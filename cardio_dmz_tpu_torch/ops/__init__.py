from .convert import lineardown2_1d_u8, norm_convert_minmax  # noqa: F401
from .morph import morph_grad3_1d_u8, morph_grad3_2d_cross_u8  # noqa: F401
from .stats import brightness_mean, equalize_hist, stddev_of_abs  # noqa: F401
from .filter import bilateral3x3  # noqa: F401
from .select import window_select  # noqa: F401
from .sobel import sobel3_dx_dy, sobel7  # noqa: F401
from .canny import canny7_precomputed_sobel  # noqa: F401
from .hough import hough_best_line  # noqa: F401
from .persp import eigen_persp_transform, warp_coord_maps  # noqa: F401
from .warp import unwarp_card, warp_perspective_exact  # noqa: F401

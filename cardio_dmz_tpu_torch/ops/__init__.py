from .convert import (  # noqa: F401
    deinterleave_rgba_to_r, lineardown2_1d_u8, norm_convert_minmax, split_u8,
    ycbcr_to_rgb)
from .morph import morph_grad3_1d_u8, morph_grad3_2d_cross_u8  # noqa: F401
from .stats import brightness_mean, equalize_hist, stddev_of_abs  # noqa: F401
from .filter import bilateral3x3, median_blur  # noqa: F401
from .select import window_select  # noqa: F401
from .sobel import (  # noqa: F401
    scharr3_dx_abs, scharr3_dy_abs, sobel3_dx_dy, sobel7)
from .canny import (  # noqa: F401
    adaptive_canny7, canny7, canny7_precomputed_sobel)
from .hough import hough_best_line  # noqa: F401
from .persp import eigen_persp_transform, warp_coord_maps  # noqa: F401
from .warp import unwarp_card, warp_perspective_exact  # noqa: F401

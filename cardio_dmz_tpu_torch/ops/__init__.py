from .convert import lineardown2_1d_u8, norm_convert_minmax  # noqa: F401
from .morph import morph_grad3_1d_u8, morph_grad3_2d_cross_u8  # noqa: F401
from .stats import equalize_hist  # noqa: F401

from .zoo import Mlp, PanConv, pan_digit_scores  # noqa: F401
from .weights import load_all_params, load_np, params_from_numpy  # noqa: F401

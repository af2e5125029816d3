from .zoo import (  # noqa: F401
    ExpiryConv, Mlp, PanConv, SlashMlp, pan_digit_scores)
from .weights import load_all_params, load_np, params_from_numpy  # noqa: F401

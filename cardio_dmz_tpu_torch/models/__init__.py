from .zoo import (  # noqa: F401
    ExpiryConv, Mlp, PanConv, pan_digit_scores)
from .weights import (  # noqa: F401
    load_all_params, load_np, load_params, module_from_numpy,
    params_from_numpy)
from .selfcheck import all_models_pass, self_check  # noqa: F401

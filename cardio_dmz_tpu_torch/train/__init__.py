from .trainer import (  # noqa: F401
    expiry_conv_loss,
    fit,
    init_expiry_conv_params,
    init_mlp_params,
    init_pan_conv_params,
    make_train_step,
    mlp_loss,
    pan_conv_loss,
)
from .optim import AdamState, adam, apply_updates  # noqa: F401
from .data import (  # noqa: F401
    synthetic_digit_batch,
    synthetic_expiry_digit_batch,
    synthetic_slash_batch,
    synthetic_vseg_batch,
)

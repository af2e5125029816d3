"""Loading of the model weights into the port's modules.

The weights are the JAX package's files, `cardio_dmz_tpu/models/params/
<name>.npz`, read by path with numpy: importing the JAX package would
import jax.
"""

import os

import numpy as np
import torch

from .zoo import Mlp, PanConv

PARAM_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "cardio_dmz_tpu", "models", "params")

# The models the PAN-only scan path runs.
MODEL_NAMES = ("vseg_mlp", "pan_conv_a", "pan_conv_b", "pan_conv_c")

_MLP_KEYS = ("hidden_w", "hidden_b", "logistic_w", "logistic_b")
_PAN_KEYS = ("conv_w", "conv_b") + _MLP_KEYS


def load_np(name, include_test_vectors=False):
    """One model's arrays as a dict of float32 numpy arrays, keyed as in
    the npz; the golden `test_*` vectors only when asked for."""
    with np.load(os.path.join(PARAM_DIR, f"{name}.npz")) as data:
        return {k: np.asarray(v, np.float32) for k, v in data.items()
                if include_test_vectors or not k.startswith("test_")}


def params_from_numpy(np_params, device):
    """{model name: {array name: numpy array}} -> {model name: nn.Module}.

    Takes the JAX package's parameters as numpy arrays, keyed like its
    load_all_params(), so that both packages compute from the same
    weights. Names outside MODEL_NAMES are not used by this path and are
    skipped."""
    out = {}
    for name in MODEL_NAMES:
        arrays = np_params[name]
        keys = _MLP_KEYS if name == "vseg_mlp" else _PAN_KEYS
        tensors = [torch.tensor(np.asarray(arrays[k]), dtype=torch.float32,
                                device=device) for k in keys]
        out[name] = (Mlp if name == "vseg_mlp" else PanConv)(*tensors)
    return out


def load_all_params(device):
    """The scan path's models on `device`, keyed by model name."""
    return params_from_numpy({name: load_np(name) for name in MODEL_NAMES},
                             device)

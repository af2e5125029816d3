"""Loading of the model weights into the port's modules.

The weights are the JAX package's files, `cardio_dmz_tpu/models/params/
<name>.npz`, read by path with numpy: importing the JAX package would
import jax.
"""

import os

import numpy as np
import torch

from .zoo import ExpiryConv, Mlp, PanConv

PARAM_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "cardio_dmz_tpu", "models", "params")

_MLP_KEYS = ("hidden_w", "hidden_b", "logistic_w", "logistic_b")
_PAN_CONV = (PanConv, ("conv_w", "conv_b") + _MLP_KEYS)
# model name -> (module, its constructor's arrays in order)
_MODELS = {
    "vseg_mlp": (Mlp, _MLP_KEYS),
    "slash_mlp": (Mlp, _MLP_KEYS),
    "pan_conv_a": _PAN_CONV,
    "pan_conv_b": _PAN_CONV,
    "pan_conv_c": _PAN_CONV,
    "expiry_conv": (ExpiryConv, ("conv1_w", "conv1_b", "conv2_w", "conv2_b")
                    + _MLP_KEYS),
}
# The models of the scan: the PAN path's, the slash MLP and the expiry conv.
MODEL_NAMES = tuple(_MODELS)
# ... and the names a file of retrained parameters may carry besides:
# tools/train_models.py trains one PAN conv, "pan_conv", an ensemble member.
_ARCHITECTURES = dict(_MODELS, pan_conv=_PAN_CONV)
# model name -> the names of its arrays, as the npz files and the modules'
# buffers carry them
MODEL_ARRAYS = {name: keys for name, (_, keys) in _ARCHITECTURES.items()}


def load_np(name, include_test_vectors=False):
    """One model's arrays as a dict of float32 numpy arrays, keyed as in
    the npz; the golden `test_*` vectors only when asked for."""
    with np.load(os.path.join(PARAM_DIR, f"{name}.npz")) as data:
        return {k: np.asarray(v, np.float32) for k, v in data.items()
                if include_test_vectors or not k.startswith("test_")}


def load_params(name, device, include_test_vectors=False):
    """One model's arrays as a dict of float32 tensors on `device`, keyed
    as in the npz (the JAX package's load_params, placed)."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in load_np(name, include_test_vectors).items()}


def module_from_numpy(name, arrays, device):
    """One model's module on `device` from its {array name: numpy array}:
    a model of the scan (MODEL_NAMES) or a retrained "pan_conv". Raises
    ValueError for another name."""
    if name not in _ARCHITECTURES:
        raise ValueError(f"unknown model {name!r}; the port builds "
                         f"{sorted(_ARCHITECTURES)}")
    module, keys = _ARCHITECTURES[name]
    return module(*(torch.tensor(np.asarray(arrays[k]), dtype=torch.float32,
                                 device=device) for k in keys))


def params_from_numpy(np_params, device):
    """{model name: {array name: numpy array}} -> {model name: nn.Module}.

    Takes the JAX package's parameters as numpy arrays, keyed like its
    load_all_params(), so that both packages compute from the same
    weights."""
    return {name: module_from_numpy(name, np_params[name], device)
            for name in _MODELS}


def load_all_params(device):
    """The scan path's models on `device`, keyed by model name."""
    return params_from_numpy({name: load_np(name) for name in MODEL_NAMES},
                             device)

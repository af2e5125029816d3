"""Checkpoint and resume for scanner sessions and model parameters.

Counterpart of the JAX package's session/checkpoint.py. ScannerState is
explicit resumable state (the reference's scan.h:33-48), so a session, or a
whole stream-major batch of sessions, persists as its leaves: to move live
streams between hosts or device lists, and to restart serving.

Two formats:

* .npz (save_session_npz / load_session_npz): the leaves in field order,
  nested ExpiryState and ScanAnalytics in place, as arr_0 ... arr_n. That
  is the order jax.tree.flatten gives the JAX package's ScannerState, whose
  fields are the same, so a file either package saves the other loads. A
  JAX single-session state (no stream axis) loads here as one stream.
* torch.save (save_session / load_session): a flat dict of tensors keyed
  by field path ("count15", "expiry.scores", "analytics.vseg_y"), loaded
  with weights_only=True; the JAX package's orbax directories have no
  counterpart here.

Every load checks the leaf count and each leaf's shape and dtype against a
fresh state (or `like`) and raises ValueError on a mismatch: a file of
another layout never turns into a state silently.
"""

import numpy as np
import torch

from ..models.weights import MODEL_ARRAYS, module_from_numpy
from .state import scanner_reset


def state_leaves(state):
    """The tensors of a (nested) NamedTuple state in field order, the order
    of jax.tree.flatten on the JAX package's state."""
    if isinstance(state, tuple):
        return [leaf for field in state for leaf in state_leaves(field)]
    return [state]


def leaf_names(state, prefix=""):
    """The field path of each leaf of state_leaves, dotted."""
    if isinstance(state, tuple):
        return [name for field, value in zip(state._fields, state)
                for name in leaf_names(value, f"{prefix}{field}.")]
    return [prefix[:-1]]


def state_from_leaves(like, leaves):
    """Rebuild a state of `like`'s structure from a flat list of leaves."""
    leaves = iter(leaves)

    def build(node):
        if isinstance(node, tuple):
            return type(node)(*(build(field) for field in node))
        return next(leaves)
    return build(like)


def state_to_numpy(state):
    """ScannerState -> its leaves as numpy arrays, flatten order."""
    return [leaf.detach().cpu().numpy() for leaf in state_leaves(state)]


def state_from_numpy(leaves, device, like=None):
    """A list of numpy leaves in flatten order -> ScannerState on `device`.
    Leaves without a stream axis (a JAX single-session state) become one
    stream. like: the state whose leaf shapes and dtypes are expected; a
    fresh state of the file's stream count when None. Raises ValueError on
    a wrong leaf count, shape or dtype."""
    leaves = [np.asarray(leaf) for leaf in leaves]
    if leaves and leaves[0].ndim == 0:
        leaves = [leaf[None] for leaf in leaves]
    if like is None:
        n_streams = leaves[0].shape[0] if leaves else 0
        like = scanner_reset((0, 0), n_streams, "cpu")
    if len(leaves) != len(state_leaves(like)):
        raise ValueError(f"checkpoint holds {len(leaves)} leaves; a "
                         f"ScannerState has {len(state_leaves(like))}")
    tensors = [torch.from_numpy(np.ascontiguousarray(leaf))
               for leaf in leaves]
    return _checked_state(like, tensors, device)


def _checked_state(like, tensors, device):
    """The state of `like`'s structure from its leaves in order, on
    `device`, after holding each leaf's shape and dtype against like's."""
    for name, tensor, ref in zip(leaf_names(like), tensors,
                                 state_leaves(like)):
        if tensor.shape != ref.shape or tensor.dtype != ref.dtype:
            raise ValueError(
                f"checkpoint leaf {name}: {tuple(tensor.shape)} "
                f"{tensor.dtype}; the state wants {tuple(ref.shape)} "
                f"{ref.dtype}")
    return state_from_leaves(like, [t.to(device) for t in tensors])


def save_session_npz(path, state):
    """Persist a stream-major ScannerState as .npz, in the JAX package's
    layout."""
    np.savez_compressed(path, *state_to_numpy(state))


def load_session_npz(path, like=None, *, device):
    """Restore a ScannerState that save_session_npz, of this or of the JAX
    package, wrote, onto `device`."""
    with np.load(path) as data:
        leaves = [data[f"arr_{i}"] for i in range(len(data.files))]
    return state_from_numpy(leaves, device, like)


def save_session(path, state):
    """Persist a stream-major ScannerState with torch.save, as a flat dict
    of CPU tensors keyed by field path. Returns the path."""
    leaves = [leaf.detach().cpu() for leaf in state_leaves(state)]
    torch.save(dict(zip(leaf_names(state), leaves)), path)
    return path


def load_session(path, like=None, *, device):
    """Restore a ScannerState from save_session's file (or, for a path
    ending in .npz, from save_session_npz's) onto `device`."""
    if str(path).endswith(".npz"):
        return load_session_npz(path, like, device=device)
    flat = torch.load(path, map_location=torch.device(device),
                      weights_only=True)
    if like is None:
        first = next(iter(flat.values()))
        like = scanner_reset((0, 0), first.shape[0], "cpu")
    names = leaf_names(like)
    if sorted(flat) != sorted(names):
        raise ValueError(
            f"checkpoint fields differ from a ScannerState's: "
            f"{sorted(set(flat) ^ set(names))}")
    return _checked_state(like, [flat[name] for name in names], device)


def save_params(path, params):
    """Persist models' arrays as one .npz with the JAX package's
    "model/key" names. params: {model name: nn.Module}, whose arrays are
    the ones it was built from (its persistent buffers, not the matrices
    folded from them), or {model name: {array name: tensor or array}}, a
    trainer's output (train.fit)."""
    flat = {}
    for model, value in params.items():
        if isinstance(value, torch.nn.Module):
            value = {key: getattr(value, key) for key in MODEL_ARRAYS[model]}
        for key, array in value.items():
            if torch.is_tensor(array):
                array = array.detach().cpu().numpy()
            flat[f"{model}/{key}"] = np.asarray(array)
    np.savez_compressed(path, **flat)


def load_params_npz(path, *, device):
    """{model name: module on `device`} from save_params's file, of this or
    of the JAX package: the scan's models (models.weights.MODEL_NAMES) and
    the retrained "pan_conv", "vseg_mlp", "slash_mlp" and "expiry_conv"
    that tools/train_models.py writes. Another model name raises
    ValueError."""
    arrays = {}
    with np.load(path) as data:
        for key in data.files:
            model, k = key.split("/", 1)
            arrays.setdefault(model, {})[k] = data[key]
    return {model: module_from_numpy(model, a, device)
            for model, a in arrays.items()}

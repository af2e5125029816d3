"""Shared helpers of the PyTorch port's parity tests.

The JAX package runs on the CPU (conftest.py forces the platform), the
port on CPU tensors, and the two meet as numpy arrays.
"""

import functools

import numpy as np
import pytest
import torch

from cardio_dmz_tpu_torch.models.weights import MODEL_NAMES, params_from_numpy

# The suite runs in several worker processes at once (pytest-xdist), each of
# which imports this module while it collects. One intra-op thread each:
# torch's default of a thread a core in every worker oversubscribes the
# host many times over (a train_one of the expiry conv took 20x longer in
# the suite than alone).
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def np_params():
    """The JAX package's load_all_params() as numpy arrays."""
    from cardio_dmz_tpu.models.weights import load_all_params
    return {name: {k: np.asarray(v) for k, v in p.items()}
            for name, p in load_all_params().items() if name in MODEL_NAMES}


@functools.lru_cache(maxsize=None)
def port_params():
    """The port's models on the CPU, built from the JAX package's arrays."""
    return params_from_numpy(np_params(), "cpu")


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_same(ref, got, atol=1e-5, rtol=0.0, path=""):
    """Compare a JAX NamedTuple result with the port's field by field:
    integer and bool arrays exactly, floats within atol + rtol*|ref|."""
    if isinstance(ref, tuple) and hasattr(ref, "_fields"):
        for name in ref._fields:
            assert_same(getattr(ref, name), getattr(got, name), atol, rtol,
                        f"{path}.{name}")
        return
    r, g = np.asarray(ref), to_np(got)
    assert r.shape == g.shape, (path, r.shape, g.shape)
    if np.issubdtype(r.dtype, np.floating):
        np.testing.assert_allclose(g, r, atol=atol, rtol=rtol, err_msg=path)
    else:
        np.testing.assert_array_equal(g, r, err_msg=path)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); run on the chip")
    return torch.device("cuda")

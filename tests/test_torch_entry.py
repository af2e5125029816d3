"""The port's entry hooks (cardio_dmz_tpu_torch/entry.py) against the JAX
package's __graft_entry__.py: entry()'s scan of four noise frames, the
dry run of training, serving and camera steps over a mesh of CPU devices,
and the refusal to run on the CPU unless it is named.

The JAX entry()'s function is jitted once (a few seconds;
tests/torch_fixture.jax_entry's lru_cache), and holds both the port and
the committed data/train_session.npz's entry arrays.
"""

import numpy as np
import pytest
import torch

import torch_fixture as fx
import torch_parity  # noqa: F401  (one intra-op thread)
from cardio_dmz_tpu_torch import entry as port_entry


@pytest.fixture(scope="module")
def jax_entry():
    return fx.jax_entry()


def test_entry_matches_jax(jax_entry):
    fn, (frames,) = port_entry.entry("cpu")
    assert frames.device.type == "cpu" and frames.shape == (4, 270, 428)
    scores, usable, y_offset = fn(frames)
    want_scores, want_usable, want_y = jax_entry
    np.testing.assert_array_equal(usable.numpy(), want_usable)
    np.testing.assert_array_equal(y_offset.numpy(), want_y)
    np.testing.assert_allclose(scores.numpy(), want_scores, atol=1e-5,
                               rtol=0)


def test_entry_fixture_is_current(jax_entry):
    """chip_smoke.py phase 20 holds entry() on the card to these arrays."""
    with np.load(fx.TRAIN_FIXTURE) as committed:
        for name, want in fx.entry_arrays().items():
            got = committed[name]
            if np.issubdtype(want.dtype, np.floating):
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
            else:
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_dryrun_multichip_on_cpu_devices(n_devices, capsys):
    """Over ["cpu"] * 2 (two data groups) and ["cpu"] * 4 (two data groups
    of two model ranks: the column-parallel hidden layer) the three steps
    run and the training loss is finite."""
    summary = port_entry.dryrun_multichip(n_devices, ["cpu"] * n_devices)
    assert summary["mesh"] == ({"data": 2, "model": 1} if n_devices == 2
                               else {"data": 2, "model": 2})
    assert summary["streams"] == 2 * n_devices
    assert np.isfinite(summary["train_loss"])
    assert "dryrun_multichip OK" in capsys.readouterr().out


def test_dryrun_takes_as_many_devices_as_named():
    with pytest.raises(ValueError, match="3 devices"):
        port_entry.dryrun_multichip(4, ["cpu"] * 3)


def test_hooks_need_cuda_unless_a_device_is_named(monkeypatch):
    """No CUDA device and none named: both hooks raise, neither falls back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.main(["2"])

"""Session and parameter checkpoints of the port, and their exchange with
the JAX package's: a session saved midway and loaded continues to the
uninterrupted session bit for bit; a file either package writes the other
loads; a file of another layout raises."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fixture as fx
from cardio_dmz_tpu.models.weights import load_all_params
from cardio_dmz_tpu.session import checkpoint as jckpt
from cardio_dmz_tpu.session import scanner_reset as jax_reset
from cardio_dmz_tpu.session import scanner_step as jax_scanner_step
from cardio_dmz_tpu_torch.models.weights import MODEL_NAMES
from cardio_dmz_tpu_torch.parallel import (
    batched_scanner_step, init_stream_states)
from cardio_dmz_tpu_torch.session import checkpoint as pckpt
from torch_parity import assert_same, np_params, port_params, to_np

ATOL = 1e-5
MID = 4


def _assert_states_equal(a, b):
    """Every leaf bit for bit, with its dtype and device type."""
    names = pckpt.leaf_names(a)
    assert names == pckpt.leaf_names(b)
    for name, x, y in zip(names, pckpt.state_leaves(a),
                          pckpt.state_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


def _run(state, frames, t0, t1, scan_expiry=True):
    result = None
    for t in range(t0, t1):
        state, (_, result) = batched_scanner_step(
            port_params(), state, torch.from_numpy(frames[:, t]),
            scan_expiry=scan_expiry)
    return state, result


@functools.lru_cache(maxsize=None)
def _full_sessions():
    """The port's full step over the expiry fixture's 3 streams: (the
    state after MID frames, the final state, the final result)."""
    frames = fx.expiry_frames()
    mid, _ = _run(init_stream_states(3, "cpu", fx.NOW), frames, 0, MID)
    final, result = _run(mid, frames, MID, fx.EXPIRY_FRAMES)
    return mid, final, result


@pytest.mark.parametrize("fmt", ["npz", "torch"])
def test_session_resumes_bit_for_bit(tmp_path, fmt):
    """Save mid-session (3 streams, expiry on), load, step on: the
    uninterrupted session, every leaf."""
    mid, final, result = _full_sessions()
    assert to_np(mid.expiry.active).any() and to_np(mid.count16).any()
    if fmt == "npz":
        path = str(tmp_path / "mid.npz")
        pckpt.save_session_npz(path, mid)
        loaded = pckpt.load_session_npz(path, device="cpu")
    else:
        path = pckpt.save_session(str(tmp_path / "mid.pt"), mid)
        loaded = pckpt.load_session(path, device="cpu")
    _assert_states_equal(loaded, mid)
    resumed, resumed_result = _run(loaded, fx.expiry_frames(), MID,
                                   fx.EXPIRY_FRAMES)
    _assert_states_equal(resumed, final)
    assert_same(jax.tree.map(to_np, result), resumed_result, atol=0)
    assert to_np(resumed_result.expiry_month).tolist() == [8, 11, 0]


def test_load_session_dispatches_on_the_suffix(tmp_path):
    mid, _, _ = _full_sessions()
    path = str(tmp_path / "mid.npz")
    pckpt.save_session_npz(path, mid)
    _assert_states_equal(pckpt.load_session(path, like=mid, device="cpu"),
                         mid)


def test_state_numpy_round_trip():
    mid, _, _ = _full_sessions()
    leaves = pckpt.state_to_numpy(mid)
    assert len(leaves) == len(jax.tree.leaves(jax.vmap(
        lambda _: jax_reset(now=fx.NOW))(jnp.arange(3))))
    _assert_states_equal(pckpt.state_from_numpy(leaves, "cpu"), mid)


# --- exchange with the JAX package -----------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_step():
    params = load_all_params()
    return jax.jit(jax.vmap(lambda s, y: jax_scanner_step(params, s, y)))


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX PAN-only step over torch_fixture.frames() (4 streams x 6
    frames): per step (state, result), jax arrays."""
    frames = fx.frames()
    state = jax.vmap(lambda _: jax_reset(now=fx.NOW))(jnp.arange(len(frames)))
    out = []
    for t in range(fx.N_FRAMES):
        state, (_, result) = _jax_step()(state, jnp.asarray(frames[:, t]))
        out.append((state, result))
    return out


def test_jax_written_batched_checkpoint_continues_in_the_port(tmp_path):
    path = str(tmp_path / "jax_mid.npz")
    jckpt.save_session_npz(path, _jax_run()[2][0])
    state = pckpt.load_session_npz(path, device="cpu")
    assert state.count15.shape == (4,)
    assert_same(fx._np(_jax_run()[2][0]), state, atol=0)
    state, result = _run(state, fx.frames(), 3, fx.N_FRAMES,
                         scan_expiry=False)
    ref_state, ref_result = _jax_run()[-1]
    assert_same(fx._np(ref_state), state, atol=ATOL)
    assert_same(fx._np(ref_result), result)
    assert to_np(result.complete).tolist() == [True, True, False, False]


def test_jax_written_single_session_loads_as_one_stream(tmp_path):
    path = str(tmp_path / "jax_single.npz")
    single = jax.tree.map(lambda a: a[1], _jax_run()[2][0])
    assert single.count15.shape == ()
    jckpt.save_session_npz(path, single)
    state = pckpt.load_session_npz(path, device="cpu")
    assert state.count15.shape == (1,)
    assert state.analytics.vseg_y.shape == (1, 20)
    state, result = _run(state, fx.frames()[1:2], 3, fx.N_FRAMES,
                         scan_expiry=False)
    ref_state, ref_result = jax.tree.map(lambda a: np.asarray(a)[1:2],
                                         _jax_run()[-1])
    assert_same(ref_state, state, atol=ATOL)
    assert_same(ref_result, result)
    assert bool(result.complete[0])


def test_port_written_checkpoint_continues_in_the_jax_package(tmp_path):
    frames = fx.frames()
    mid, _ = _run(init_stream_states(4, "cpu", fx.NOW), frames, 0, 3,
                  scan_expiry=False)
    path = str(tmp_path / "port_mid.npz")
    pckpt.save_session_npz(path, mid)
    like = _jax_run()[0][0]
    state = jckpt.load_session_npz(path, like=like)
    assert jax.tree.structure(state) == jax.tree.structure(like)
    for got, want in zip(jax.tree.leaves(state), jax.tree.leaves(like)):
        assert got.shape == want.shape and got.dtype == want.dtype
    assert_same(fx._np(state), mid, atol=0)
    state = jax.tree.map(jnp.asarray, state)
    for t in range(3, fx.N_FRAMES):
        state, (_, result) = _jax_step()(state, jnp.asarray(frames[:, t]))
    ref_state, ref_result = _jax_run()[-1]
    assert_same(fx._np(ref_result), jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), result))
    np.testing.assert_array_equal(state.completed_digits,
                                  ref_state.completed_digits)


# --- files of another layout raise -----------------------------------------

def _saved_leaves():
    return pckpt.state_to_numpy(_full_sessions()[0])


@pytest.mark.parametrize("fault", ["shape", "dtype", "count", "streams"])
def test_npz_of_another_layout_raises(tmp_path, fault):
    leaves = _saved_leaves()
    like = None
    if fault == "shape":
        leaves[2] = leaves[2][:, :15]               # aggregated15 (3, 15, 10)
    elif fault == "dtype":
        leaves[0] = leaves[0].astype(np.int64)
    elif fault == "count":
        leaves = leaves[:-1]
    else:
        like = init_stream_states(5, "cpu", fx.NOW)
    path = str(tmp_path / "bad.npz")
    np.savez_compressed(path, *leaves)
    with pytest.raises(ValueError, match="checkpoint"):
        pckpt.load_session_npz(path, like=like, device="cpu")


@pytest.mark.parametrize("fault", ["shape", "dtype", "field"])
def test_torch_checkpoint_of_another_layout_raises(tmp_path, fault):
    mid = _full_sessions()[0]
    flat = dict(zip(pckpt.leaf_names(mid), pckpt.state_leaves(mid)))
    if fault == "shape":
        flat["expiry.scores"] = flat["expiry.scores"][:, :3]
    elif fault == "dtype":
        flat["count16"] = flat["count16"].to(torch.int64)
    else:
        del flat["analytics.flipped"]
    path = str(tmp_path / "bad.pt")
    torch.save(flat, path)
    with pytest.raises(ValueError, match="checkpoint"):
        pckpt.load_session(path, device="cpu")


def test_leaf_names_follow_the_fields():
    names = pckpt.leaf_names(_full_sessions()[0])
    assert names[:2] == ["count15", "count16"]
    assert "expiry.scores" in names and "analytics.iso_speed" in names
    assert names.index("expiry.total_seen") < names.index("now_year") \
        < names.index("analytics.n_recorded")


# --- parameters ------------------------------------------------------------

def test_save_params_loads_in_the_jax_package(tmp_path):
    path = str(tmp_path / "params.npz")
    pckpt.save_params(path, port_params())
    loaded = jckpt.load_params_npz(path)
    assert sorted(loaded) == sorted(MODEL_NAMES)
    for name in MODEL_NAMES:
        assert sorted(loaded[name]) == sorted(np_params()[name])
        for key, value in np_params()[name].items():
            np.testing.assert_array_equal(np.asarray(loaded[name][key]),
                                          value, err_msg=f"{name}/{key}")
    with np.load(path) as data:
        assert not [k for k in data.files if k.endswith("_mm")
                    or k.endswith("band_w")]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_load_params_npz_rebuilds_the_modules(tmp_path, writer):
    path = str(tmp_path / "params.npz")
    if writer == "port":
        pckpt.save_params(path, port_params())
    else:
        jckpt.save_params(path, {n: load_all_params()[n]
                                 for n in MODEL_NAMES})
    loaded = pckpt.load_params_npz(path, device="cpu")
    assert sorted(loaded) == sorted(MODEL_NAMES)
    for name, module in loaded.items():
        for key, buf in module.named_buffers():
            assert torch.equal(buf, getattr(port_params()[name], key)), (
                name, key)

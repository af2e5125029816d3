"""The slice as a whole: the port's session state machine and batched
serving step against the JAX package's, stream for stream and tensor for
tensor, on rendered card sessions (tests/torch_fixture.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fixture as fx
from cardio_dmz_tpu.session import scanner_reset as jax_reset
from cardio_dmz_tpu.session import scanner_result as jax_result
from cardio_dmz_tpu_torch.parallel import (
    batched_scanner_step, init_stream_states)
from cardio_dmz_tpu_torch.session import (
    scan_frames, scanner_reset, scanner_result)
from torch_parity import assert_same, port_params, to_np

ATOL = 1e-5


def _pan(digits, n=16):
    return "".join(map(str, to_np(digits)[:n]))


def _stream(tree, i):
    return jax.tree.map(lambda a: a[i:i + 1], tree)


@functools.lru_cache(maxsize=None)
def _port_run():
    """The port's batched step over the fixture's 4 streams x 6 frames:
    one (state, frame result, scanner result) per step."""
    frames = torch.from_numpy(fx.frames())
    state = init_stream_states(len(frames), "cpu", fx.NOW)
    out = []
    for t in range(fx.N_FRAMES):
        state, (frame, result) = batched_scanner_step(
            port_params(), state, frames[:, t])
        out.append((state, frame, result))
    return out


@pytest.mark.parametrize("step", range(fx.N_FRAMES))
def test_batched_step_matches_jax_vmap(step):
    ref_state, ref_frame, ref_result = fx.jax_session()[step]
    state, frame, result = _port_run()[step]
    assert_same(ref_frame, frame, atol=ATOL, rtol=1e-5)
    assert_same(ref_result, result)
    assert_same(ref_state, state, atol=ATOL)


def test_scan_frames_reads_pan_and_matches_jax_state():
    state, (frames, results) = scan_frames(
        port_params(), torch.from_numpy(fx.frames()[:1]), fx.NOW)
    assert bool(state.number_complete[0])
    assert _pan(state.completed_digits[0]) == "4111111111111111"
    assert int(state.completed_n[0]) == 16
    assert bool(results.complete[0, -1])
    assert frames.scores.shape == (1, fx.N_FRAMES, 16, 10)
    assert int(state.analytics.n_recorded[0]) == fx.N_FRAMES
    assert_same(_stream(fx.jax_session()[-1][0], 0), state, atol=ATOL)


def test_wrong_luhn_never_accepted():
    state, _ = scan_frames(port_params(),
                           torch.from_numpy(fx.frames()[2:3]), fx.NOW)
    assert int(state.count16[0]) >= 3       # the digits were read ...
    assert not bool(state.number_complete[0])  # ... and refused
    assert_same(_stream(fx.jax_session()[-1][0], 2), state, atol=ATOL)


def test_upside_down_frames_not_recorded():
    state = _port_run()[-1][0]
    assert int(state.count15[3]) == 0 and int(state.count16[3]) == 0
    assert int(state.analytics.n_recorded[3]) == 0


def _amex_states(pans):
    """States whose 15-digit accumulator reads each of `pans`."""
    agg = np.full((len(pans), 16, 10), 0.01, np.float32)
    for s, pan in enumerate(pans):
        for i, d in enumerate(pan):
            agg[s, i, int(d)] = 0.95
    agg[:, 15] = 0.0
    return agg


def test_fifteen_digit_amex_acceptance_path():
    """The amex 15-digit acceptance (scan.cpp:99-160) at the state level:
    a Luhn-valid amex PAN is accepted, an invalid-BIN one is not."""
    pans = ("343434343434343", "143434343434349")
    agg = _amex_states(pans)
    state = scanner_reset(fx.NOW, 2, "cpu")._replace(
        count15=torch.full((2,), 5, dtype=torch.int32),
        aggregated15=torch.from_numpy(agg))
    state, result = scanner_result(state)
    assert to_np(state.number_complete).tolist() == [True, False]
    assert int(state.completed_n[0]) == 15
    assert _pan(state.completed_digits[0], 15) == pans[0]

    for s in range(2):
        ref = jax_reset(now=fx.NOW)._replace(
            count15=jnp.asarray(5, jnp.int32),
            aggregated15=jnp.asarray(agg[s]))
        ref_state, ref_res = jax_result(ref)
        ref_state, ref_res = jax.tree.map(lambda a: np.asarray(a)[None],
                                          (ref_state, ref_res))
        assert_same(ref_state, _stream(state, s))
        assert_same(ref_res, _stream(result, s))


def test_fixture_is_current():
    """The committed smoke_session.npz is what the JAX package computes
    today, so that chip_smoke.py checks the port against current results."""
    fresh = fx.fixture_arrays()
    with np.load(fx.FIXTURE) as committed:
        assert sorted(committed.files) == sorted(fresh)
        for k, v in fresh.items():
            if np.issubdtype(v.dtype, np.floating):
                np.testing.assert_allclose(committed[k], v, atol=ATOL,
                                           rtol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(committed[k], v, err_msg=k)


def test_fixture_through_port():
    """chip_smoke.py's session check, here on the CPU: the fixture's
    frames through scan_frames give the recorded outputs and both PANs."""
    with np.load(fx.FIXTURE) as f:
        fixture = {k: f[k] for k in f.files}
    state, (frames, _) = scan_frames(
        port_params(), torch.from_numpy(fixture["frames"]),
        tuple(fixture["now"]))
    got = {"vseg_y_offset": frames.vseg.y_offset,
           "vseg_pattern_type": frames.vseg.pattern_type,
           "hseg_n_offsets": frames.hseg.n_offsets,
           "hseg_offsets": frames.hseg.offsets,
           "hseg_pattern_offset": frames.hseg.pattern_offset,
           "usable": frames.usable,
           "number_complete": state.number_complete,
           "completed_digits": state.completed_digits,
           "completed_n": state.completed_n}
    for k, v in got.items():
        np.testing.assert_array_equal(to_np(v), fixture[k], err_msg=k)
    np.testing.assert_allclose(to_np(frames.scores), fixture["scores"],
                               atol=ATOL)
    assert [_pan(d) for d in state.completed_digits] == [
        "4111111111111111", "4530504390541813"]

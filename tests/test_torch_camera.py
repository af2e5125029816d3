"""The camera path as a whole: the port's detect_edges, preprocess_frame and
batched_camera_step against the JAX package's, and the recorded camera
fixture (cardio_dmz_tpu_torch/data/camera_session.npz) that chip_smoke.py
replays on the card. (Orientations and camera metadata:
tests/test_torch_camera_orient.py.)

The JAX step runs jitted and vmapped over two streams (one compile, cached
in torch_fixture). Its corners are asserted equal to the JAX package's run
op by op, which is what the port computes (torch_fixture.
assert_corners_uncontracted).
"""

import functools

import numpy as np
import pytest
import torch

import torch_fixture as fx
from cardio_dmz_tpu_torch import api as papi
from cardio_dmz_tpu_torch.parallel import (
    batched_camera_step, init_stream_states)
from torch_parity import assert_same, port_params, to_np

ATOL = 1e-5
N_STEPS = 3


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _pan(digits, n):
    return "".join(map(str, to_np(digits)[:int(n)]))


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@functools.lru_cache(maxsize=None)
def _odd_frames():
    """Two streams of N_STEPS frames the detector must reject or half
    find: a flat grey preview (no edge anywhere) and uniform noise."""
    rng = np.random.RandomState(3)
    y = np.stack([np.full((N_STEPS, 480, 640), 90, np.uint8),
                  rng.randint(0, 256, (N_STEPS, 480, 640)).astype(np.uint8)])
    cb = np.stack([np.full((N_STEPS, 240, 320), 128, np.uint8),
                   rng.randint(0, 256, (N_STEPS, 240, 320)).astype(np.uint8)])
    cr = np.stack([np.full((N_STEPS, 240, 320), 128, np.uint8),
                   rng.randint(0, 256, (N_STEPS, 240, 320)).astype(np.uint8)])
    return y, cb, cr


def _port_session(y, cb, cr, n_steps):
    """The port's batched camera step over (S, T, ...) frames from fresh
    sessions: one (state, found, frame, result) per step."""
    state = init_stream_states(len(y), "cpu", fx.NOW)
    out = []
    for t in range(n_steps):
        state, (found, frame, result) = batched_camera_step(
            port_params(), state, *_tensors(y[:, t], cb[:, t], cr[:, t]))
        out.append((state, found, frame, result))
    return out


@functools.lru_cache(maxsize=None)
def _port_fixture_run():
    return _port_session(*fx.camera_frames(), fx.CAMERA_FRAMES)


@functools.lru_cache(maxsize=None)
def _jax_odd_run():
    """The JAX camera step over _odd_frames(): (state, found, frame,
    result, corners, card) per step, as numpy."""
    import jax
    import jax.numpy as jnp
    from cardio_dmz_tpu.session import scanner_reset
    y, cb, cr = _odd_frames()
    step = fx.jax_camera_step()
    state = jax.vmap(lambda _: scanner_reset(now=fx.NOW))(jnp.arange(2))
    out = []
    for t in range(N_STEPS):
        state, *rest = step(state, y[:, t], cb[:, t], cr[:, t])
        out.append(fx._np((state, *rest)))
    return out


@pytest.mark.parametrize("source", ["fixture", "odd"])
def test_detect_edges_matches_jax(source):
    """Every edge's found flag, rho and theta and every corner, bit for
    bit, against the JAX package's detect_edges run op by op: the guide
    and tilted cards, a flat frame and a noise frame."""
    import jax
    import jax.numpy as jnp
    from cardio_dmz_tpu import api as japi
    frames = fx.camera_frames() if source == "fixture" else _odd_frames()
    y, cb, cr = (a[:, 0] for a in frames)
    edges, corners = papi.detect_edges(*_tensors(y, cb, cr))
    with jax.disable_jit():
        ref_edges, ref_corners = jax.vmap(japi.detect_edges)(
            jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr))
    for name in ("top", "bottom", "left", "right"):
        got, ref = getattr(edges, name), getattr(ref_edges, name)
        np.testing.assert_array_equal(to_np(got.found), np.asarray(ref.found))
        np.testing.assert_array_equal(_bits(to_np(got.rho)), _bits(ref.rho))
        np.testing.assert_array_equal(_bits(to_np(got.theta)),
                                      _bits(ref.theta))
    np.testing.assert_array_equal(to_np(corners.found_all),
                                  np.asarray(ref_corners.found_all))
    np.testing.assert_array_equal(_bits(fx.corner_array(corners)),
                                  _bits(fx.corner_array(ref_corners)))
    want_found = [True, True] if source == "fixture" else [False, False]
    assert to_np(corners.found_all).tolist() == want_found


@functools.lru_cache(maxsize=None)
def _port_odd_run():
    return _port_session(*_odd_frames(), N_STEPS)


@pytest.mark.parametrize("step", range(fx.CAMERA_FRAMES))
def test_batched_camera_step_matches_jax(step):
    """The port's batched_camera_step against the JAX package's vmapped
    camera_scanner_step on the fixture's two card streams, field for
    field: found flags, frame results, scanner results and states."""
    state, found, frame, result = _port_fixture_run()[step]
    ref_state, ref_found, ref_frame, ref_result, _, _ = \
        fx.jax_camera_session()[step]
    np.testing.assert_array_equal(to_np(found), ref_found)
    assert_same(ref_frame, frame, atol=ATOL, rtol=1e-5)
    assert_same(ref_result, result)
    # the analytics keep the telemetry: 1e-5 relative, summed in another
    # order than XLA's
    assert_same(ref_state, state, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("step", range(N_STEPS))
def test_camera_step_gates_frames_not_found(step):
    """A flat and a noise stream, never found: found, usable, the
    telemetry, the scanner results and the whole session state equal the
    JAX package's. The scan of such a frame reads a zero card whose vseg
    windows all tie; which tied window wins rests on the last bit of the
    MLP's dot products, summed in another order than XLA's, and nothing
    reads it (the frame is unusable and goes unrecorded), so its vseg,
    hseg and digit scores are not compared."""
    state, found, frame, result = _port_odd_run()[step]
    ref_state, ref_found, ref_frame, ref_result, _, _ = _jax_odd_run()[step]
    assert not ref_found.any()
    np.testing.assert_array_equal(to_np(found), ref_found)
    for name in ("usable", "focus_score", "brightness_score", "iso_speed",
                 "shutter_speed", "torch_is_on", "flipped"):
        assert_same(getattr(ref_frame, name), getattr(frame, name),
                    atol=ATOL, rtol=1e-5, path=name)
    assert not to_np(frame.usable).any()
    assert_same(ref_result, result)
    # the analytics keep the telemetry: 1e-5 relative, summed in another
    # order than XLA's
    assert_same(ref_state, state, atol=ATOL, rtol=1e-5)


def test_preprocess_frame_matches_fixture_cards():
    """preprocess_frame's found flags and u8 cards equal the JAX package's
    recorded ones, frame by frame, and a frame that is not found gives a
    zero card."""
    y, cb, cr = fx.camera_frames()
    with np.load(fx.CAMERA_FIXTURE) as f:
        want_found, want_card = f["found"], f["card"]
    for t in (0, fx.CAMERA_FRAMES - 1):
        found, card = papi.preprocess_frame(*_tensors(y[:, t], cb[:, t],
                                                      cr[:, t]))
        np.testing.assert_array_equal(to_np(found), want_found[:, t])
        np.testing.assert_array_equal(to_np(card), want_card[:, t])
    found, card = papi.preprocess_frame(*_tensors(
        *(a[:, 0] for a in _odd_frames())))
    assert not to_np(found).any() and not to_np(card).any()


def test_camera_fixture_is_current():
    """The committed camera_session.npz is what the JAX package computes
    today (the writer also asserts its jitted corners are the op-by-op
    ones), so that chip_smoke.py checks the port against current
    results."""
    fresh = fx.camera_fixture_arrays()
    with np.load(fx.CAMERA_FIXTURE) as committed:
        assert sorted(committed.files) == sorted(fresh)
        for k, v in fresh.items():
            if k in ("corners", "homography"):
                np.testing.assert_array_equal(_bits(committed[k]), _bits(v),
                                              err_msg=k)
            elif np.issubdtype(v.dtype, np.floating):
                np.testing.assert_allclose(committed[k], v, atol=ATOL,
                                           rtol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(committed[k], v, err_msg=k)


def test_camera_fixture_through_port():
    """chip_smoke.py's camera session check, here on the CPU: the fixture's
    frames through the port's camera step give the recorded found flags,
    corners and homographies (f32 bits), cards (u8), scan fields, and
    both PANs."""
    with np.load(fx.CAMERA_FIXTURE) as f:
        fixture = {k: f[k] for k in f.files}
    run = _port_fixture_run()

    def per_frame(get):
        return np.stack([to_np(get(r)) for r in run], axis=1)

    y, cb, cr = fx.camera_frames()
    corners = np.stack([fx.corner_array(papi.detect_edges(*_tensors(
        y[:, t], cb[:, t], cr[:, t]))[1]) for t in (0, 7)], axis=1)
    np.testing.assert_array_equal(_bits(corners),
                                  _bits(fixture["corners"][:, [0, 7]]))
    from cardio_dmz_tpu_torch.ops.persp import eigen_persp_transform
    m = eigen_persp_transform(torch.from_numpy(corners.reshape(-1, 4, 2)),
                              torch.from_numpy(fx.CARD_DEST))
    np.testing.assert_array_equal(
        _bits(to_np(m)), _bits(fixture["homography"][:, [0, 7]].reshape(
            -1, 3, 3)))

    final = run[-1][0]
    got = {
        "found": per_frame(lambda r: r[1]),
        "vseg_y_offset": per_frame(lambda r: r[2].vseg.y_offset),
        "vseg_pattern_type": per_frame(lambda r: r[2].vseg.pattern_type),
        "hseg_n_offsets": per_frame(lambda r: r[2].hseg.n_offsets),
        "hseg_offsets": per_frame(lambda r: r[2].hseg.offsets),
        "usable": per_frame(lambda r: r[2].usable),
        "number_complete": to_np(final.number_complete),
        "completed_digits": to_np(final.completed_digits),
        "completed_n": to_np(final.completed_n),
    }
    for k, v in got.items():
        np.testing.assert_array_equal(v, fixture[k], err_msg=k)
    np.testing.assert_allclose(per_frame(lambda r: r[2].scores),
                               fixture["scores"], atol=ATOL)
    for k in ("focus_score", "brightness_score"):
        np.testing.assert_allclose(per_frame(lambda r: getattr(r[2], k)),
                                   fixture[k], rtol=1e-5, err_msg=k)
    assert [_pan(d, n) for d, n in zip(final.completed_digits,
                                       final.completed_n)] == [
        pan for pan, _ in fx.CAMERA_STREAMS]


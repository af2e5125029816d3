"""The portrait and upside-down orientations and the camera metadata
through the whole camera step: the port's batched_camera_step(orientation=
..., iso_speed=..., shutter_speed=..., torch_is_on=...) against the JAX
package's camera_scanner_step on cards pasted on each orientation's guide
rect, and the host fixture (cardio_dmz_tpu_torch/data/host_session.npz)
that holds those runs for chip_smoke.py.

The JAX step compiles once an orientation (cached in torch_fixture). A
file of its own, so that it runs beside tests/test_torch_camera.py on
another worker.
"""

import functools

import numpy as np
import pytest
import torch

import torch_fixture as fx
from chip_smoke import ORIENTATIONS
from cardio_dmz_tpu_torch import api as papi
from cardio_dmz_tpu_torch.parallel import (
    batched_camera_step, init_stream_states)
from torch_parity import assert_same, port_params, to_np

ATOL = 1e-5


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _pan(digits, n):
    return "".join(map(str, to_np(digits)[:int(n)]))


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --- orientations and camera metadata through the whole step ---------------

@functools.lru_cache(maxsize=None)
def _port_oriented_run(orientation):
    """The port's camera step at an orientation over torch_fixture's
    oriented frames and metadata: one (state, found, frame, result) per
    step."""
    y, cb, cr = fx.oriented_camera_frames(orientation)
    iso, shutter, torch_on = fx.camera_metadata(*y.shape[:2])
    state = init_stream_states(len(y), "cpu", fx.NOW)
    out = []
    for t in range(y.shape[1]):
        frame = _tensors(y[:, t], cb[:, t], cr[:, t])
        meta = _tensors(iso[:, t], shutter[:, t], torch_on[:, t])
        state, (found, fr, result) = batched_camera_step(
            port_params(), state, *frame,
            orientation=ORIENTATIONS[orientation], iso_speed=meta[0],
            shutter_speed=meta[1], torch_is_on=meta[2])
        out.append((state, found, fr, result))
    return out


@pytest.mark.parametrize("step", range(fx.ORIENTED_FRAMES))
@pytest.mark.parametrize("orientation", fx.ORIENTED)
def test_oriented_camera_step_matches_jax(orientation, step):
    """batched_camera_step(orientation=...) on a card on the portrait and
    on the landscape-left (upside-down) guide rect, with non-zero camera
    metadata, against the JAX package's camera_scanner_step: found flags,
    frame results with their telemetry, scanner results and the whole
    state, analytics ring included."""
    state, found, frame, result = _port_oriented_run(orientation)[step]
    ref_state, ref_found, ref_frame, ref_result, _ = \
        fx.jax_oriented_camera_session(orientation)[step]
    assert ref_found.all()
    np.testing.assert_array_equal(to_np(found), ref_found)
    assert_same(ref_frame, frame, atol=ATOL, rtol=1e-5)
    assert_same(ref_result, result)
    assert_same(ref_state, state, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("orientation", fx.ORIENTED)
def test_oriented_corners_homography_and_card_match_jax(orientation):
    """On the first and the last frame: the detector's corners, f32 bit for
    bit, against the JAX package's run op by op (on the portrait rect its
    jitted XLA:CPU graph contracts a multiply-add of the intersection and
    differs in the last bit; the port computes the op-by-op value); the
    homography in the orientation's corner order, bit for bit; and the
    rectified card, u8 for u8, against the jitted camera step's."""
    from cardio_dmz_tpu_torch.ops.persp import eigen_persp_transform
    value = ORIENTATIONS[orientation]
    y, cb, cr = fx.oriented_camera_frames(orientation)
    ref_run = fx.jax_oriented_camera_session(orientation)
    for t in (0, fx.ORIENTED_FRAMES - 1):
        frame = _tensors(y[:, t], cb[:, t], cr[:, t])
        _, corner_points = papi.detect_edges(*frame, value)
        corners = fx.corner_array(corner_points)
        ref_corners = fx.oriented_op_by_op_corners(orientation)[:, t]
        np.testing.assert_array_equal(_bits(corners), _bits(ref_corners))
        names = ("tl", "tr", "bl", "br")
        order = [names.index(k) for k in papi._CORNER_ORDER[value]]
        m = eigen_persp_transform(torch.from_numpy(corners[:, order]),
                                  torch.from_numpy(fx.CARD_DEST))
        np.testing.assert_array_equal(
            _bits(to_np(m)),
            _bits(fx.oriented_homographies(ref_corners, orientation)))
        found, card = papi.preprocess_frame(*frame, value)
        assert to_np(found).all()
        np.testing.assert_array_equal(to_np(card), ref_run[t][4])


def test_oriented_sessions_read_their_pans():
    """Each orientation's sessions end as the JAX package's do, and read a
    card's number."""
    for orientation in fx.ORIENTED:
        state = _port_oriented_run(orientation)[-1][0]
        ref = fx.jax_oriented_camera_session(orientation)[-1][0]
        np.testing.assert_array_equal(to_np(state.number_complete),
                                      ref.number_complete)
        np.testing.assert_array_equal(to_np(state.completed_digits),
                                      ref.completed_digits)
        done = to_np(state.number_complete)
        assert done.any(), orientation
        pans = [pan for pan, _ in fx.EXPIRY_STREAMS]
        assert [_pan(d, n) for d, n, c in zip(
            state.completed_digits, state.completed_n, done) if c] == [
            pans[s] for s in np.nonzero(done)[0]]


def test_camera_metadata_reaches_telemetry_and_analytics():
    """iso, shutter and torch go into each frame's telemetry and into every
    field of the analytics ring, equal to the JAX package's; no input reads
    as zeros; a wrong shape raises."""
    orientation = fx.ORIENTED[0]
    iso, shutter, torch_on = fx.camera_metadata(fx.ORIENTED_STREAMS,
                                                fx.ORIENTED_FRAMES)
    run = _port_oriented_run(orientation)
    for t, (_, _, frame, _) in enumerate(run):
        np.testing.assert_array_equal(to_np(frame.iso_speed), iso[:, t])
        np.testing.assert_array_equal(to_np(frame.shutter_speed),
                                      shutter[:, t])
        np.testing.assert_array_equal(to_np(frame.torch_is_on),
                                      torch_on[:, t])
    ring = run[-1][0].analytics
    ref = fx.jax_oriented_camera_session(orientation)[-1][0].analytics
    assert_same(ref, ring, atol=ATOL, rtol=1e-5)
    n = fx.ORIENTED_FRAMES
    np.testing.assert_array_equal(to_np(ring.iso_speed)[:, :n], iso)
    np.testing.assert_array_equal(to_np(ring.torch_is_on)[:, :n], torch_on)
    assert to_np(ring.shutter_speed)[:, :n].all()

    y, cb, cr = (a[:, 0] for a in fx.oriented_camera_frames(orientation))
    state = init_stream_states(len(y), "cpu", fx.NOW)
    _, (_, frame, _) = batched_camera_step(
        port_params(), state, *_tensors(y, cb, cr),
        orientation=ORIENTATIONS[orientation])
    assert not to_np(frame.iso_speed).any()
    assert not to_np(frame.torch_is_on).any()
    with pytest.raises(ValueError, match="metadata"):
        batched_camera_step(port_params(), state, *_tensors(y, cb, cr),
                            iso_speed=torch.zeros(5, dtype=torch.int32))


# --- the host fixture ------------------------------------------------------

def test_host_fixture_is_current():
    """The committed host_session.npz is what the JAX package computes
    today (HostScanner sessions, host-oracle groups, the oriented camera
    runs with metadata, the checkpoint's leaves), so that chip_smoke.py
    checks the port against current results."""
    fresh = fx.host_fixture_arrays()
    with np.load(fx.HOST_FIXTURE) as committed:
        assert sorted(committed.files) == sorted(fresh)
        for k, v in fresh.items():
            if k == "checkpoint_npz":
                # zip members carry the time they were written: compare
                # the arrays inside
                old = fx.checkpoint_leaves(committed[k])
                new = fx.checkpoint_leaves(v)
                assert len(old) == len(new)
                for i, (a, b) in enumerate(zip(old, new)):
                    assert a.dtype == b.dtype, i
                    np.testing.assert_allclose(a, b, atol=ATOL, rtol=1e-5,
                                               err_msg=f"leaf {i}")
            elif k.endswith(("corners", "homography")):
                np.testing.assert_array_equal(_bits(committed[k]), _bits(v),
                                              err_msg=k)
            elif np.issubdtype(v.dtype, np.floating):
                np.testing.assert_allclose(committed[k], v, atol=ATOL,
                                           rtol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(committed[k], v, err_msg=k)

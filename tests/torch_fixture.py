"""The session fixtures shared by the PyTorch port's tests and chip_smoke.py.

smoke_session.npz, the PAN-only path: four streams of six rendered
270x428 card frames go through the JAX package's scanner_step, vmapped
over streams. Streams 0 and 1 (two readable PANs) are kept: their frames,
the date the sessions start from, the JAX package's per-frame
vseg/hseg/scores/usable and the final completed digits.

camera_session.npz, the camera path: two streams of 480x640 Y + 240x320
Cb/Cr preview frames go through the JAX package's camera_scanner_step,
vmapped over streams. Stream 0 is a card on the landscape guide rect (the
geometry of tests/test_camera.py); stream 1 a perspective-tilted card,
pasted into the preview with persp_host.warp_exact, so that the warp
really interpolates. Kept: the frames, and per frame the JAX package's
found flag, corners, homography, rectified card and frame fields, and the
final completed digits.

expiry_session.npz, the full paths (PAN + expiry): three streams of eight
rendered card frames (a PAN with "08/28", another PAN with "11/29", and a
card without an expiry line) go through the JAX package's
scanner_step(scan_expiry=True), vmapped over streams; and the same cards,
placed on the guide rect of 480x640 previews, through
camera_scanner_step(scan_expiry=True). Kept: the card frames (the previews
are rebuilt from them), and per frame of either path the expiry windows,
their (4, 5, 10) scores, the expiry state and the date, and the final
results. The writer asserts that the jitted windows equal the
ones computed op by op.

host_session.npz, the host side of serving (it holds results only: its
frames are expiry_session.npz's cards): the JAX HostScanner's per-frame
outputs and the host oracle's expiry groups over those three streams; two
short camera runs of the first two cards with non-zero iso / shutter /
torch metadata, on the portrait and on the landscape-left (upside-down)
guide rect, through camera_scanner_step(orientation=...), with the final
analytics rings (their corners are the detector's run op by op); and the
portrait run's state after three frames as the bytes of a checkpoint
written by the JAX package's save_session_npz.

train_glyphs.npz, the glyph masks the training generators draw with PIL:
the 10 PAN digit masks of synthetic._digit_mask (27x19) and the 60 expiry
digit masks of train/data._render_expiry_char (16x11, every digit at
every jitter it draws). The port's generators (cardio_dmz_tpu_torch/
train/) take them from this table and need no PIL.

expiry_glyphs.npz, the expiry text the JAX package's
synthetic.render_text_small draws with PIL: each digit's coverage mask, its
offset and its textbbox, as PIL rasterizes it. The port's renderer
(cardio_dmz_tpu_torch/synthetic.py) composites them as PIL does and needs
no PIL.

train_session.npz, training and __graft_entry__: for each of the four
architectures of tools/train_models.py, its initial parameters
(PRNGKey(0)), three seed-0 batches of 64 from its generator,
value_and_grad's loss and gradients on the first batch, and a three-step
fit at lr 3e-3 on the three batches (its losses and final parameters);
and __graft_entry__.entry()'s outputs on its four noise frames.

ref_session.npz, the compiled card.io C++ (the port's refbridge, linked
from native/refshim/build/; no JAX): the render parameters of the first
cases of cardio_dmz_tpu_torch/tools/parity_ab.py's sweeps, drawn from its
default_rng(2026) in its order (64 rectified frames, 4 PAN sessions of 10
frames and 12 dated expiry sessions of 16, as the tool draws them, and 16
camera previews cycling the four orientations) and of session 50 of the
tool's default expiry sweep, a SHA-256 of each drawn batch, and the
reference's answers: each frame's usable, vseg, hseg and 160 scores;
each session's PAN and date; the MM/YY groups ref_scan_card_image finds
on every frame of the expiry sessions; each preview's found flag and
corners, the SHA-256 of the card ref_transform_card warps from them and
the reference's scan of that card.
No frame is stored, and none is chosen for agreeing.

sweep_session.npz, the accuracy sweeps: tools/accuracy_sweep.py's
run_sweep at its defaults (512 sessions of 8 frames, batch 64, seed 2026)
and run_camera_sweep at its (128 sessions of 8 frames, batch 32, seed
2026): per session the true PAN, the complete flag and the accepted read,
and each report as JSON.

chip_smoke.py replays them through the port on the card, where neither
JAX nor the renderer is installed. Write the files anew with

    python tests/torch_fixture.py [smoke camera expiry host glyphs
                                   expiry_glyphs train sweep ref]

(all of them when none is named).
"""

import contextlib
import functools
import io
import json
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import synthetic  # noqa: E402
from cardio_dmz_tpu import api  # noqa: E402
from chip_smoke import (  # noqa: E402
    DATED_CARD, ORIENTATIONS, TRAIN_BATCH, TRAIN_LR, TRAIN_MODELS,
    group_rects, paste_previews)
from cardio_dmz_tpu.constants import (  # noqa: E402
    LANDSCAPE_HORIZONTAL_INSET, LANDSCAPE_VERTICAL_INSET,
    ORIENTATION_LANDSCAPE_RIGHT)
from cardio_dmz_tpu.models.weights import load_all_params  # noqa: E402
from cardio_dmz_tpu.ops import persp_host  # noqa: E402
from cardio_dmz_tpu.scan.expiry_device import (  # noqa: E402
    best_expiry_seg_device, categorize_windows)
from cardio_dmz_tpu.session import scanner_reset, scanner_step  # noqa: E402
from cardio_dmz_tpu.session.state import camera_scanner_step  # noqa: E402

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cardio_dmz_tpu_torch", "data")
FIXTURE = os.path.join(_DATA, "smoke_session.npz")
CAMERA_FIXTURE = os.path.join(_DATA, "camera_session.npz")
EXPIRY_FIXTURE = os.path.join(_DATA, "expiry_session.npz")
HOST_FIXTURE = os.path.join(_DATA, "host_session.npz")
GLYPH_FIXTURE = os.path.join(_DATA, "train_glyphs.npz")
EXPIRY_GLYPH_FIXTURE = os.path.join(_DATA, "expiry_glyphs.npz")
TRAIN_FIXTURE = os.path.join(_DATA, "train_session.npz")
SWEEP_FIXTURE = os.path.join(_DATA, "sweep_session.npz")
REF_FIXTURE = os.path.join(_DATA, "ref_session.npz")
NOW = (2026, 1)
N_FRAMES = 6
# (pan, y0, noise): two readable PANs, a wrong-Luhn PAN and an upside-down
# card; geometry as in tests/test_session.py
STREAMS = (("4111111111111111", 150, 1),
           ("4530504390541813", 150, 2),
           ("4111111111111112", 150, 1),
           ("4111111111111111", 60, 1))
FIXTURE_STREAMS = 2


@functools.lru_cache(maxsize=None)
def frames():
    """(4, 6, 270, 428) uint8."""
    return np.stack([
        np.stack([synthetic.render_frame(pan, y0=y0, width=18.0, offset=35,
                                         seed=s, noise=noise)
                  for s in range(N_FRAMES)])
        for pan, y0, noise in STREAMS])


def _np(tree):
    return jax.tree.map(np.array, tree)


@functools.lru_cache(maxsize=None)
def jax_session():
    """The JAX package's run over frames(): a list, one entry per step,
    of (state, frame result, scanner result) as numpy pytrees, each
    stream-major."""
    params = load_all_params()
    step = jax.jit(jax.vmap(lambda s, y: scanner_step(params, s, y)))
    fr = frames()
    state = jax.vmap(lambda _: scanner_reset(now=NOW))(jnp.arange(len(fr)))
    out = []
    for t in range(N_FRAMES):
        state, (frame, result) = step(state, jnp.asarray(fr[:, t]))
        out.append((_np(state), _np(frame), _np(result)))
    return out


def fixture_arrays():
    """What smoke_session.npz holds, computed now from the JAX package."""
    run = jax_session()
    k = FIXTURE_STREAMS

    def per_frame(get):
        return np.stack([get(f)[:k] for _, f, _ in run], axis=1)

    final = run[-1][0]
    return {
        "frames": frames()[:k],
        "now": np.asarray(NOW, np.int32),
        "vseg_y_offset": per_frame(lambda f: f.vseg.y_offset),
        "vseg_pattern_type": per_frame(lambda f: f.vseg.pattern_type),
        "vseg_score": per_frame(lambda f: f.vseg.score),
        "hseg_n_offsets": per_frame(lambda f: f.hseg.n_offsets),
        "hseg_offsets": per_frame(lambda f: f.hseg.offsets),
        "hseg_pattern_offset": per_frame(lambda f: f.hseg.pattern_offset),
        "hseg_number_width": per_frame(lambda f: f.hseg.number_width),
        "hseg_score": per_frame(lambda f: f.hseg.score),
        "scores": per_frame(lambda f: f.scores),
        "usable": per_frame(lambda f: f.usable),
        "number_complete": final.number_complete[:k],
        "completed_digits": final.completed_digits[:k],
        "completed_n": final.completed_n[:k],
    }


# --- the camera path -------------------------------------------------------

CAMERA_FRAMES = 20
CARD_DEST = np.float32([[0, 0], [427, 0], [0, 269], [427, 269]])
# (pan, quad of the card in the preview as tl, tr, bl, br; None = the
# guide rect, pasted without resampling)
CAMERA_STREAMS = (
    ("4111111111111111", None),
    ("4530504390541813", ((103.0, 108.0), (529.0, 101.0), (108.0, 370.0),
                          (536.0, 376.0))),
)


def camera_preview(card, quad=None, bg=50):
    """A 270x428 card placed in a 480x640 Y + 240x320 Cb/Cr preview.
    quad=None puts it on the landscape guide rect with flat 128 chroma
    (tests/test_camera.py); otherwise it is warped onto `quad` with
    cvWarpPerspective's exact bilinear and blended into the background by
    its coverage, and a flat-tinted card goes onto the chroma planes."""
    if quad is None:
        y = np.full((480, 640), bg, np.uint8)
        x0, y0 = LANDSCAPE_HORIZONTAL_INSET, LANDSCAPE_VERTICAL_INSET
        y[y0:y0 + 270, x0:x0 + 428] = card
        cbcr = np.full((240, 320), 128, np.uint8)
        return y, cbcr, cbcr.copy()

    def paste(image, value, scale, shape):
        m = persp_host.persp_transform(CARD_DEST, np.float32(quad) * scale)
        warped = persp_host.warp_exact(image, m, shape).astype(np.int32)
        cover = persp_host.warp_exact(np.full_like(image, 255), m,
                                      shape).astype(np.int32)
        out = warped + (value * (255 - cover) + 127) // 255
        return np.clip(out, 0, 255).astype(np.uint8)

    # the chroma planes carry the card too, at half size
    tint = np.full_like(card, 100)
    return (paste(card, bg, 1.0, (480, 640)),
            paste(tint, 128, 0.5, (240, 320)),
            paste(tint + 60, 128, 0.5, (240, 320)))


@functools.lru_cache(maxsize=None)
def camera_frames():
    """Y (2, T, 480, 640), Cb and Cr (2, T, 240, 320), all uint8."""
    planes = [[camera_preview(synthetic.render_frame(
        pan, seed=i, noise=0, y0=150, width=18.5, offset=30), quad)
        for i in range(CAMERA_FRAMES)] for pan, quad in CAMERA_STREAMS]
    return tuple(np.stack([np.stack([f[k] for f in stream])
                           for stream in planes]) for k in range(3))


@functools.lru_cache(maxsize=None)
def jax_camera_step():
    """The JAX package's camera step, vmapped over streams and jitted, with
    the corners and the rectified card it computes on the way:
    (state, y, cb, cr) -> (state, found, frame, result, corners, card)."""
    params = load_all_params()

    def step(state, y, cb, cr):
        _, corners = api.detect_edges(y, cb, cr)
        _, card = api.preprocess_frame(y, cb, cr)
        state, (found, frame, result) = camera_scanner_step(
            params, state, y, cb, cr)
        return state, found, frame, result, corners, card
    return jax.jit(jax.vmap(step))


def corner_array(corners):
    """CornerPoints -> (..., 4, 2) in tl, tr, bl, br order."""
    return np.stack([np.asarray(c) for c in (
        corners.top_left, corners.top_right, corners.bottom_left,
        corners.bottom_right)], axis=-2)


def op_by_op_corners(y, cb, cr, orientation=ORIENTATION_LANDSCAPE_RIGHT):
    """detect_edges' corners for (N, ...) frames with every JAX op run on
    its own: no f32 multiply fused into an add, as on the TPU and in the
    reference's compiled C++ (the jitted XLA:CPU graph may fuse them)."""
    with jax.disable_jit():
        _, corners = jax.vmap(lambda a, b, c: api.detect_edges(
            a, b, c, orientation))(
            jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr))
    return corner_array(corners)


def assert_corners_uncontracted(corners, y, cb, cr,
                                orientation=ORIENTATION_LANDSCAPE_RIGHT):
    """The jitted JAX corners (N, 4, 2) equal the op-by-op ones, bit for
    bit: the port computes the latter, so only such inputs compare."""
    want = op_by_op_corners(y, cb, cr, orientation)
    np.testing.assert_array_equal(np.asarray(corners).view(np.int32),
                                  want.view(np.int32))


def homographies(corners):
    """The JAX package's homography for (..., 4, 2) landscape corners, as
    it computes it off the TPU (persp_host, through a callback)."""
    flat = corners.reshape(-1, 4, 2)
    return np.stack([persp_host.persp_transform(c, CARD_DEST)
                     for c in flat]).reshape(corners.shape[:-2] + (3, 3))


@functools.lru_cache(maxsize=None)
def jax_camera_session():
    """The JAX camera step over camera_frames(): one (state, found, frame,
    result, corners, card) per step, as numpy, stream-major."""
    y, cb, cr = camera_frames()
    step = jax_camera_step()
    state = jax.vmap(lambda _: scanner_reset(now=NOW))(jnp.arange(len(y)))
    out = []
    for t in range(CAMERA_FRAMES):
        state, *rest = step(state, y[:, t], cb[:, t], cr[:, t])
        out.append(_np((state, *rest)))
    return out


def camera_fixture_arrays():
    """What camera_session.npz holds, computed now from the JAX package."""
    run = jax_camera_session()
    y, cb, cr = camera_frames()

    def per_frame(get):
        return np.stack([np.asarray(get(r)) for r in run], axis=1)

    corners = per_frame(lambda r: corner_array(r[4]))        # (2, T, 4, 2)
    assert_corners_uncontracted(
        corners.reshape(-1, 4, 2), y.reshape(-1, 480, 640),
        cb.reshape(-1, 240, 320), cr.reshape(-1, 240, 320))
    final = run[-1][0]
    return {
        "y": y, "cb": cb, "cr": cr,
        "now": np.asarray(NOW, np.int32),
        "found": per_frame(lambda r: r[1]),
        "corners": corners,
        "homography": homographies(corners),
        "card": per_frame(lambda r: r[5]),
        "vseg_y_offset": per_frame(lambda r: r[2].vseg.y_offset),
        "vseg_pattern_type": per_frame(lambda r: r[2].vseg.pattern_type),
        "hseg_n_offsets": per_frame(lambda r: r[2].hseg.n_offsets),
        "hseg_offsets": per_frame(lambda r: r[2].hseg.offsets),
        "scores": per_frame(lambda r: r[2].scores),
        "usable": per_frame(lambda r: r[2].usable),
        "focus_score": per_frame(lambda r: r[2].focus_score),
        "brightness_score": per_frame(lambda r: r[2].brightness_score),
        "number_complete": final.number_complete,
        "completed_digits": final.completed_digits,
        "completed_n": final.completed_n,
    }


# --- the full paths: PAN + expiry ------------------------------------------

EXPIRY_FRAMES = 8
# (pan, expiry text or None); geometry as in tests/test_expiry_device.py
EXPIRY_STREAMS = (("4111111111111111", "08/28"),
                  ("4530504390541813", "11/29"),
                  ("4111111111111111", None))


@functools.lru_cache(maxsize=None)
def expiry_frames():
    """(3, 8, 270, 428) uint8."""
    def render(pan, expiry, seed):
        if expiry is None:
            return synthetic.render_frame(pan, y0=150, width=18.0, offset=35,
                                          seed=seed, noise=1)
        return synthetic.render_frame_with_expiry(pan, expiry, seed=seed,
                                                  **DATED_CARD)
    return np.stack([np.stack([render(pan, expiry, s)
                               for s in range(EXPIRY_FRAMES)])
                     for pan, expiry in EXPIRY_STREAMS])


@functools.lru_cache(maxsize=None)
def expiry_camera_frames():
    """The cards of expiry_frames() on the guide rect of a preview:
    Y (3, 8, 480, 640), Cb and Cr (3, 8, 240, 320), all uint8."""
    planes = [[camera_preview(card) for card in stream]
              for stream in expiry_frames()]
    return tuple(np.stack([np.stack([f[k] for f in stream])
                           for stream in planes]) for k in range(3))


@functools.lru_cache(maxsize=None)
def jax_expiry_step():
    """The JAX package's full step, vmapped over streams and jitted, with
    the frame's window scores: (state, y) -> (state, frame, result,
    scores)."""
    params = load_all_params()

    def step(state, y):
        state, (frame, result) = scanner_step(params, state, y,
                                              scan_expiry=True)
        scores = categorize_windows(params["expiry_conv"], y,
                                    frame.expiry_groups)
        return state, frame, result, scores
    return jax.jit(jax.vmap(step))


@functools.lru_cache(maxsize=None)
def jax_expiry_camera_step():
    """The JAX package's full camera step, vmapped and jitted, with the
    rectified card and the window scores: (state, y, cb, cr) -> (state,
    found, frame, result, card, scores)."""
    params = load_all_params()

    def step(state, y, cb, cr):
        _, card = api.preprocess_frame(y, cb, cr)
        state, (found, frame, result) = camera_scanner_step(
            params, state, y, cb, cr, scan_expiry=True)
        scores = categorize_windows(params["expiry_conv"], card,
                                    frame.expiry_groups)
        return state, found, frame, result, card, scores
    return jax.jit(jax.vmap(step))


def _fresh_states(n):
    return jax.vmap(lambda _: scanner_reset(now=NOW))(jnp.arange(n))


@functools.lru_cache(maxsize=None)
def jax_expiry_session():
    """jax_expiry_step over expiry_frames(): one (state, frame, result,
    scores) per step, as numpy, stream-major."""
    fr = expiry_frames()
    state = _fresh_states(len(fr))
    out = []
    for t in range(EXPIRY_FRAMES):
        state, *rest = jax_expiry_step()(state, jnp.asarray(fr[:, t]))
        out.append(_np((state, *rest)))
    return out


@functools.lru_cache(maxsize=None)
def jax_expiry_camera_session():
    """jax_expiry_camera_step over expiry_camera_frames(): one (state,
    found, frame, result, card, scores) per step, as numpy."""
    y, cb, cr = expiry_camera_frames()
    state = _fresh_states(len(y))
    out = []
    for t in range(EXPIRY_FRAMES):
        state, *rest = jax_expiry_camera_step()(state, y[:, t], cb[:, t],
                                                cr[:, t])
        out.append(_np((state, *rest)))
    return out


def op_by_op_windows(cards, vseg_y, enabled):
    """best_expiry_seg_device for (N, 270, 428) cards with every JAX op run
    on its own: no f32 multiply fused into a subtract (the jitted XLA:CPU
    graph may fuse the regrid's). Windows as a numpy pytree."""
    slash = load_all_params()["slash_mlp"]
    with jax.disable_jit():
        return _np(jax.vmap(
            lambda y, v, e: best_expiry_seg_device(slash, y, v, e))(
            jnp.asarray(cards), jnp.asarray(vseg_y), jnp.asarray(enabled)))


def assert_windows_uncontracted(windows, cards, vseg_y, enabled):
    """The jitted JAX windows (N-major) equal the op-by-op ones: the port
    computes the latter, so only such frames compare."""
    want = op_by_op_windows(cards, vseg_y, enabled)
    for name in windows._fields:
        np.testing.assert_array_equal(getattr(windows, name),
                                      getattr(want, name), err_msg=name)


def _expiry_arrays(run, frame_of, state_of, scores_of, result_of, prefix):
    def per_frame(get):
        return np.stack([np.asarray(get(r)) for r in run], axis=1)

    out = {f"window_{k}": per_frame(lambda r: getattr(
        frame_of(r).expiry_groups, k))
        for k in ("valid", "top", "left", "char_tops", "char_lefts")}
    out["window_scores"] = per_frame(scores_of)
    out.update({f"expiry_{k}": per_frame(lambda r: getattr(
        state_of(r).expiry, k))
        for k in ("active", "top", "left", "scores", "recently_seen",
                  "total_seen")})
    out.update(
        vseg_y_offset=per_frame(lambda r: frame_of(r).vseg.y_offset),
        usable=per_frame(lambda r: frame_of(r).usable),
        expiry_month=per_frame(lambda r: state_of(r).expiry_month),
        expiry_year=per_frame(lambda r: state_of(r).expiry_year),
        complete=per_frame(lambda r: result_of(r).complete),
        result_month=per_frame(lambda r: result_of(r).expiry_month),
        result_year=per_frame(lambda r: result_of(r).expiry_year),
        frames_since_complete=state_of(run[-1]).frames_since_complete,
        number_complete=state_of(run[-1]).number_complete,
        completed_digits=state_of(run[-1]).completed_digits,
        completed_n=state_of(run[-1]).completed_n)
    return {prefix + k: v for k, v in out.items()}


def _windows_of(arrays, prefix):
    from cardio_dmz_tpu.scan.expiry_device import ExpiryWindows
    return ExpiryWindows(*(
        arrays[f"{prefix}window_{k}"].reshape(
            (-1,) + arrays[f"{prefix}window_{k}"].shape[2:])
        for k in ExpiryWindows._fields))


def _seg_gate(run, frame_of, state_before):
    """The `enabled` gate each frame's expiry seg ran under, recomputed
    from its results: (S, T) bool."""
    from cardio_dmz_tpu.constants import (
        CARD_HEIGHT, FLIP_VSEG_Y_OFFSET_CUTOFF, MIN_VSEG_SCORE,
        SMALL_CHARACTER_HEIGHT)
    gates = []
    for t, r in enumerate(run):
        f = frame_of(r)
        need = np.ones_like(f.usable) if t == 0 else (
            (state_before(run[t - 1]).expiry_month == 0)
            | (state_before(run[t - 1]).expiry_year == 0))
        gates.append((f.vseg.score > MIN_VSEG_SCORE)
                     & (f.vseg.y_offset >= FLIP_VSEG_Y_OFFSET_CUTOFF)
                     & (f.vseg.y_offset
                        < CARD_HEIGHT - 2 * SMALL_CHARACTER_HEIGHT) & need)
    return np.stack(gates, axis=1)


def expiry_fixture_arrays():
    """What expiry_session.npz holds, computed now from the JAX package."""
    run = jax_expiry_session()
    cam = jax_expiry_camera_session()
    out = {"frames": expiry_frames(), "now": np.asarray(NOW, np.int32),
           "camera_found": np.stack([r[1] for r in cam], axis=1)}
    out.update(_expiry_arrays(run, lambda r: r[1], lambda r: r[0],
                              lambda r: r[3], lambda r: r[2], ""))
    out.update(_expiry_arrays(cam, lambda r: r[2], lambda r: r[0],
                              lambda r: r[5], lambda r: r[3], "camera_"))
    # only frames whose jitted windows equal the op-by-op ones are kept
    for prefix, cards, gate in (
            ("", out["frames"], _seg_gate(run, lambda r: r[1],
                                          lambda r: r[0])),
            ("camera_", np.stack([r[4] for r in cam], axis=1),
             _seg_gate(cam, lambda r: r[2], lambda r: r[0])
             & out["camera_found"])):
        assert_windows_uncontracted(
            _windows_of(out, prefix), cards.reshape(-1, 270, 428),
            out[prefix + "vseg_y_offset"].reshape(-1), gate.reshape(-1))
    return out


# --- the host side: HostScanner, oriented camera runs, a checkpoint --------

ORIENTED = ("portrait", "landscape_left")    # names of chip_smoke.ORIENTATIONS
ORIENTED_STREAMS = 2          # the first two cards of expiry_frames()
ORIENTED_FRAMES = 8
CHECKPOINT_AFTER = 3          # frames of the portrait run before the save


def camera_metadata(n_streams, n_frames):
    """Non-zero camera metadata for every stream and frame: iso (S, T)
    int32, shutter (S, T) f32, torch (S, T) bool."""
    s = np.arange(n_streams)[:, None]
    t = np.arange(n_frames)[None, :]
    return ((100 + 50 * s + t).astype(np.int32),
            (0.01 * (t + 1) + s).astype(np.float32),
            (s + t) % 2 == 0)


@functools.lru_cache(maxsize=None)
def oriented_camera_frames(orientation):
    """The first ORIENTED_STREAMS cards of expiry_frames() on an
    orientation's guide rect: Y (S, T, 480, 640), Cb and Cr (S, T, 240,
    320), all uint8."""
    cards = expiry_frames()[:ORIENTED_STREAMS, :ORIENTED_FRAMES]
    return paste_previews(cards, orientation=orientation)


@functools.lru_cache(maxsize=None)
def jax_oriented_camera_step(orientation):
    """The JAX package's camera step at an orientation, with the camera
    metadata, vmapped over streams and jitted: (state, y, cb, cr, iso,
    shutter, torch) -> (state, found, frame, result, card). (The corners
    are taken op by op, op_by_op_corners: a second detector in this graph
    would only add to its compile.)"""
    params = load_all_params()
    value = ORIENTATIONS[orientation]

    def step(state, y, cb, cr, iso, shutter, torch_on):
        _, card = api.preprocess_frame(y, cb, cr, value)
        state, (found, frame, result) = camera_scanner_step(
            params, state, y, cb, cr, orientation=value, iso_speed=iso,
            shutter_speed=shutter, torch_is_on=torch_on)
        return state, found, frame, result, card
    return jax.jit(jax.vmap(step))


@functools.lru_cache(maxsize=None)
def jax_oriented_camera_session(orientation):
    """jax_oriented_camera_step over oriented_camera_frames(): one (state,
    found, frame, result, card) per step, as numpy."""
    y, cb, cr = oriented_camera_frames(orientation)
    iso, shutter, torch_on = camera_metadata(*y.shape[:2])
    step = jax_oriented_camera_step(orientation)
    state = _fresh_states(len(y))
    out = []
    for t in range(y.shape[1]):
        state, *rest = step(state, y[:, t], cb[:, t], cr[:, t], iso[:, t],
                            shutter[:, t], torch_on[:, t])
        out.append(_np((state, *rest)))
    return out


@functools.lru_cache(maxsize=None)
def oriented_op_by_op_corners(orientation):
    """The detector's corners over oriented_camera_frames(), run op by op:
    (S, T, 4, 2). That is what the port computes; on the portrait rect the
    jitted XLA:CPU graph contracts a multiply-add of the intersection and
    differs in the last bit, so the fixture keeps these and, for
    everything else, the jitted step's results."""
    y, cb, cr = oriented_camera_frames(orientation)
    return op_by_op_corners(
        y.reshape(-1, 480, 640), cb.reshape(-1, 240, 320),
        cr.reshape(-1, 240, 320), ORIENTATIONS[orientation]).reshape(
        y.shape[:2] + (4, 2))


def oriented_homographies(corners, orientation):
    """The JAX package's homography for (..., 4, 2) corners in tl, tr, bl,
    br order, taken in the orientation's corner order (api._CORNER_ORDER),
    as it computes it off the TPU (persp_host)."""
    names = ("tl", "tr", "bl", "br")
    order = [names.index(k)
             for k in api._CORNER_ORDER[ORIENTATIONS[orientation]]]
    return homographies(corners[..., order, :])


def jax_checkpoint_bytes(state):
    """A (stream-batched) JAX ScannerState as the bytes of the .npz that
    the JAX package's save_session_npz writes."""
    from cardio_dmz_tpu.session.checkpoint import save_session_npz
    buffer = io.BytesIO()
    save_session_npz(buffer, state)
    return np.frombuffer(buffer.getvalue(), np.uint8)


@functools.lru_cache(maxsize=None)
def jax_sharded_run(fixture, scan_expiry, n_steps=4):
    """The JAX package's make_sharded_step (jitted) on a one-CPU mesh over
    the first n_steps frames of a fixture file (FIXTURE or
    EXPIRY_FIXTURE), from fresh states at the fixture's `now`: one (state,
    (frame, result)) per step, as numpy."""
    from cardio_dmz_tpu.parallel.mesh import make_mesh
    from cardio_dmz_tpu.parallel.streams import make_sharded_step
    data = np.load(fixture)
    frames, now = data["frames"], data["now"]
    step, place, init = make_sharded_step(
        load_all_params(), make_mesh(jax.devices()[:1]),
        scan_expiry=scan_expiry)
    state = init(frames.shape[0])
    state = state._replace(now_year=jnp.full_like(state.now_year, now[0]),
                           now_month=jnp.full_like(state.now_month, now[1]))
    out = []
    for t in range(n_steps):
        state, res = step(state, place(frames[:, t]))
        out.append(_np((state, res)))
    return out


@functools.lru_cache(maxsize=None)
def jax_host_scanner():
    """One JAX HostScanner: its jitted PAN step compiles once. Callers set
    its attributes and reset() it."""
    from cardio_dmz_tpu.session.host import HostScanner
    return HostScanner(load_all_params(), scan_expiry=True, now=NOW)


@functools.lru_cache(maxsize=None)
def jax_host_sessions():
    """The JAX HostScanner over each stream of expiry_frames(), and the
    host oracle's groups of every frame at the vseg row the scanner found:
    {key: (S, T, ...) array}."""
    from cardio_dmz_tpu.scan.expiry_seg_host import best_expiry_seg
    scanner = jax_host_scanner()
    scanner.scan_expiry, scanner.allow_past_dates = True, False
    scanner.collect_name_groups = False
    slash = load_all_params()["slash_mlp"]
    keys = ("usable", "vseg_y_offset", "vseg_pattern_type", "hseg_n_offsets",
            "hseg_offsets", "complete", "predictions", "expiry_month",
            "expiry_year", "state_month", "state_year", "n_groups",
            "group_tops", "group_lefts")
    out = {k: [] for k in keys}
    for stream in expiry_frames():
        scanner.reset()
        rows = {k: [] for k in keys}
        for y in stream:
            frame, result = scanner.add_frame(y)
            n, tops, lefts = group_rects(best_expiry_seg(
                y, int(frame.vseg.y_offset), slash)[0])
            for k, v in (
                    ("usable", frame.usable),
                    ("vseg_y_offset", frame.vseg.y_offset),
                    ("vseg_pattern_type", frame.vseg.pattern_type),
                    ("hseg_n_offsets", frame.hseg.n_offsets),
                    ("hseg_offsets", frame.hseg.offsets),
                    ("complete", result.complete),
                    ("predictions", result.predictions),
                    ("expiry_month", result.expiry_month),
                    ("expiry_year", result.expiry_year),
                    ("state_month", scanner.expiry_month),
                    ("state_year", scanner.expiry_year),
                    ("n_groups", n), ("group_tops", tops),
                    ("group_lefts", lefts)):
                rows[k].append(np.asarray(v))
        for k in keys:
            out[k].append(np.stack(rows[k]))
    return {k: np.stack(v) for k, v in out.items()}


def host_fixture_arrays():
    """What host_session.npz holds, computed now from the JAX package."""
    from cardio_dmz_tpu.session.analytics import ScanAnalytics
    out = {"now": np.asarray(NOW, np.int32)}
    out.update({f"host_{k}": v for k, v in jax_host_sessions().items()})
    iso, shutter, torch_on = camera_metadata(ORIENTED_STREAMS,
                                             ORIENTED_FRAMES)
    out.update(iso_speed=iso, shutter_speed=shutter, torch_is_on=torch_on)
    for orientation in ORIENTED:
        run = jax_oriented_camera_session(orientation)

        def per_frame(get):
            return np.stack([np.asarray(get(r)) for r in run], axis=1)

        corners = oriented_op_by_op_corners(orientation)
        final = run[-1][0]
        arrays = {
            "found": per_frame(lambda r: r[1]),
            "corners": corners,
            "homography": oriented_homographies(corners, orientation),
            # the rectified cards of the first and the last frame
            "card": per_frame(lambda r: r[4])[:, [0, -1]],
            "vseg_y_offset": per_frame(lambda r: r[2].vseg.y_offset),
            "hseg_n_offsets": per_frame(lambda r: r[2].hseg.n_offsets),
            "hseg_offsets": per_frame(lambda r: r[2].hseg.offsets),
            "usable": per_frame(lambda r: r[2].usable),
            "scores": per_frame(lambda r: r[2].scores),
            "focus_score": per_frame(lambda r: r[2].focus_score),
            "brightness_score": per_frame(lambda r: r[2].brightness_score),
            "frame_iso_speed": per_frame(lambda r: r[2].iso_speed),
            "frame_shutter_speed": per_frame(lambda r: r[2].shutter_speed),
            "frame_torch_is_on": per_frame(lambda r: r[2].torch_is_on),
            "number_complete": final.number_complete,
            "completed_digits": final.completed_digits,
            "completed_n": final.completed_n,
        }
        arrays.update({f"analytics_{k}": getattr(final.analytics, k)
                       for k in ScanAnalytics._fields})
        out.update({f"{orientation}_{k}": v for k, v in arrays.items()})
    mid = jax_oriented_camera_session(ORIENTED[0])[CHECKPOINT_AFTER - 1][0]
    out["checkpoint_npz"] = jax_checkpoint_bytes(mid)
    return out


def checkpoint_leaves(npz_bytes):
    """The arrays of a checkpoint held as bytes, in order."""
    with np.load(io.BytesIO(np.asarray(npz_bytes).tobytes())) as data:
        return [data[f"arr_{i}"] for i in range(len(data.files))]


# --- training and __graft_entry__ -------------------------------------------

TRAIN_STEPS = 3


def glyph_arrays():
    """What train_glyphs.npz holds: synthetic._digit_mask of each digit, and
    each expiry digit as train/data._render_expiry_char draws it (bold mono
    18, at 1 + jx, 1 + jy of its box) for jx in (-1, 0, 1), jy in (-1, 0)."""
    from PIL import Image, ImageDraw

    from cardio_dmz_tpu.synthetic import _digit_mask
    from cardio_dmz_tpu.train.data import _FONT_MONO_BOLD, _font

    font = _font(_FONT_MONO_BOLD, 18)
    expiry = np.zeros((10, 3, 2, 16, 11), np.float32)
    for d in range(10):
        for jx in (-1, 0, 1):
            for jy in (-1, 0):
                img = Image.new("L", (11, 16), 0)
                draw = ImageDraw.Draw(img)
                bbox = draw.textbbox((0, 0), str(d), font=font)
                draw.text((1 + jx - bbox[0], 1 + jy - bbox[1]), str(d),
                          fill=255, font=font)
                expiry[d, jx + 1, jy + 1] = np.asarray(img).astype(
                    np.float32) / 255.0
    return {"pan_digits": np.stack([_digit_mask(d) for d in range(10)]),
            "expiry_digits": expiry}


def expiry_glyph_arrays():
    """What expiry_glyphs.npz holds: the expiry digits as
    synthetic.render_text_small draws them (synthetic._EXPIRY_DIGIT_FONTS),
    each as PIL's ImageDraw.text rasterizes it at a whole-pixel position:
    font.getmask2's coverage mask (padded into one array; "mask_shape"
    holds each one's height and width) and offset, and the textbbox that
    places it."""
    from PIL import Image, ImageDraw, ImageFont

    from cardio_dmz_tpu.synthetic import _EXPIRY_DIGIT_FONTS

    draw = ImageDraw.Draw(Image.new("L", (1, 1), 0))
    masks, shapes, offsets, bboxes = [], [], [], []
    for d in range(10):
        path, size = _EXPIRY_DIGIT_FONTS[d]
        font = ImageFont.truetype(path, size)
        mask, offset = font.getmask2(str(d), draw.fontmode)
        w, h = mask.size
        masks.append(np.array(mask, np.uint8).reshape(h, w))
        shapes.append((h, w))
        offsets.append(offset)
        bboxes.append(draw.textbbox((0, 0), str(d), font=font))
    padded = np.zeros((10,) + tuple(np.max(shapes, axis=0)), np.uint8)
    for d, m in enumerate(masks):
        padded[d, :m.shape[0], :m.shape[1]] = m
    return {"mask": padded, "mask_shape": np.int32(shapes),
            "offset": np.int32(offsets), "bbox": np.int32(bboxes)}


@functools.lru_cache(maxsize=None)
def train_spec(model):
    """tools/train_models._spec(model) of the JAX package."""
    from cardio_dmz_tpu.tools.train_models import _spec
    return _spec(model)


@functools.lru_cache(maxsize=None)
def train_batches(model, seed=0):
    """TRAIN_STEPS batches of TRAIN_BATCH from the model's JAX generator
    at `seed`: (inputs (3, B, ...), labels (3, B))."""
    data_fn = train_spec(model)[3]
    rng = np.random.RandomState(seed)
    batches = [data_fn(rng, TRAIN_BATCH) for _ in range(TRAIN_STEPS)]
    return (np.stack([b[0] for b in batches]),
            np.stack([b[1] for b in batches]))


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(model):
    """jit(value_and_grad(loss_fn)) of the JAX package for `model`."""
    return jax.jit(jax.value_and_grad(train_spec(model)[1]))


@functools.lru_cache(maxsize=None)
def jax_train_run(model):
    """{name: numpy array} of one architecture: its initial parameters
    ("init/<key>"), the batches, the loss and gradients on batch 0 and the
    three-step fit ("fit/<key>", "fit_losses")."""
    from cardio_dmz_tpu.train import fit

    init_fn, loss_fn = train_spec(model)[:2]
    params = init_fn()
    inputs, labels = train_batches(model)
    loss, grads = jax_value_and_grad(model)(params, inputs[0], labels[0])
    trained, losses = fit(loss_fn, params, iter(zip(inputs, labels)),
                          steps=TRAIN_STEPS, learning_rate=TRAIN_LR)
    out = {"inputs": inputs, "labels": labels,
           "loss": np.float32(loss), "fit_losses": np.float32(losses)}
    for prefix, tree in (("init", params), ("grad", grads),
                         ("fit", trained)):
        out.update({f"{prefix}/{k}": np.asarray(v) for k, v in tree.items()})
    return out


@functools.lru_cache(maxsize=None)
def jax_entry():
    """__graft_entry__.entry()'s function, jitted as a compile check jits
    it, on its example frames, as numpy: (scores, usable, y_offset)."""
    from __graft_entry__ import entry
    fn, args = entry()
    return tuple(np.asarray(x) for x in jax.jit(fn)(*args))


def train_run_arrays():
    """The training arrays of train_session.npz, "<model>/<name>" for each
    architecture, computed now from the JAX package."""
    return {f"{m}/{k}": v for m in TRAIN_MODELS
            for k, v in jax_train_run(m).items()}


def entry_arrays():
    """The entry's arrays of train_session.npz, computed now."""
    return dict(zip(("entry_scores", "entry_usable", "entry_y_offset"),
                    jax_entry()))


def train_fixture_arrays():
    """What train_session.npz holds."""
    return {**train_run_arrays(), **entry_arrays()}


# --- the accuracy sweeps -----------------------------------------------------

SWEEP = (512, 8, 64, 2026)          # run_sweep's defaults
CAMERA_SWEEP = (128, 8, 32, 2026)   # run_camera_sweep's


@contextlib.contextmanager
def recording_sweep():
    """Inside the block the JAX package's tools/accuracy_sweep.py records
    what it renders and what its jitted functions return: a dict with
    "rendered", the (frames, pans) of each render_sessions /
    render_camera_sessions call, and "jit", the (qualified name, args,
    outputs) of each call of a function the tool jits (its step, and the
    camera sweep's card placement, "render_camera_sessions.<locals>.place").
    The tool itself runs unchanged."""
    from cardio_dmz_tpu.tools import accuracy_sweep as tool

    rec = {"rendered": [], "jit": []}
    real_jit = jax.jit

    def recorded(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            rec["rendered"].append(out)
            return out
        return call

    def jit(fn, *args, **kwargs):
        compiled = real_jit(fn, *args, **kwargs)
        name = getattr(fn, "__qualname__", "")
        if not name.startswith(("run_sweep.", "run_camera_sweep.",
                                "render_camera_sessions.")):
            return compiled

        def call(*call_args):
            out = compiled(*call_args)
            rec["jit"].append((name, call_args, out))
            return out
        return call

    with mock.patch.object(tool, "render_sessions",
                           recorded(tool.render_sessions)), \
            mock.patch.object(tool, "render_camera_sessions",
                              recorded(tool.render_camera_sessions)), \
            mock.patch.object(jax, "jit", jit):
        yield rec


def _jax_reads(state, n):
    """The first n streams' accepted reads of a JAX ScannerState batch
    (None where the number did not complete), as the tool reads them."""
    complete = np.asarray(state.number_complete)[:n]
    digits = np.asarray(state.completed_digits)[:n]
    n_num = np.asarray(state.completed_n)[:n]
    return ["".join(map(str, digits[i][:n_num[i]])) if complete[i] else None
            for i in range(n)]


@functools.lru_cache(maxsize=None)
def jax_sweep(n_sessions, frames_per_session, batch, seed):
    """The JAX run_sweep: (report, pans, reads), reads session for
    session."""
    from cardio_dmz_tpu.tools.accuracy_sweep import run_sweep
    with recording_sweep() as rec:
        report = run_sweep(n_sessions, frames_per_session, batch, seed,
                           quiet=True)
    pans, reads = [], []
    for (_, batch_pans), (_, _, (state, _)) in zip(rec["rendered"],
                                                    rec["jit"]):
        pans += batch_pans
        reads += _jax_reads(state, len(batch_pans))
    return report, pans, reads


@functools.lru_cache(maxsize=None)
def jax_camera_sweep(n_sessions, frames_per_session, batch, seed):
    """The JAX run_camera_sweep: (report, pans, reads, previews (S, T,
    480, 640) u8, quads (S * T, 4, 2) f32 as its placement took them)."""
    from cardio_dmz_tpu.tools.accuracy_sweep import run_camera_sweep
    with recording_sweep() as rec:
        report = run_camera_sweep(n_sessions, frames_per_session, batch,
                                  seed, quiet=True)
    steps = [out for name, _, out in rec["jit"]
             if name.startswith("run_camera_sweep.")]
    finals = steps[frames_per_session - 1::frames_per_session]
    pans, reads = [], []
    for (_, batch_pans), (state, _) in zip(rec["rendered"], finals):
        pans += batch_pans
        reads += _jax_reads(state, len(batch_pans))
    quads = np.concatenate([np.asarray(args[1]) for name, args, _ in
                            rec["jit"] if name.startswith("render_camera")])
    previews = np.concatenate([ys for ys, _ in rec["rendered"]])
    return report, pans, reads, previews, quads


def _sweep_arrays(prefix, report, pans, reads):
    return {f"{prefix}_pans": np.array(pans),
            f"{prefix}_complete": np.array([r is not None for r in reads]),
            f"{prefix}_reads": np.array([r or "" for r in reads]),
            f"{prefix}_report": np.array(json.dumps(report))}


def sweep_fixture_arrays():
    """What sweep_session.npz holds: "rect_*" from run_sweep(*SWEEP),
    "camera_*" from run_camera_sweep(*CAMERA_SWEEP)."""
    return {**_sweep_arrays("rect", *jax_sweep(*SWEEP)),
            **_sweep_arrays("camera", *jax_camera_sweep(*CAMERA_SWEEP)[:3])}


def _record_arrays(prefix, records):
    """FrameRecords as arrays under prefix."""
    return {f"{prefix}_usable": np.array([r.usable for r in records]),
            f"{prefix}_vseg_y": np.int32([r.vseg_y_offset for r in records]),
            f"{prefix}_vseg_pattern": np.int32(
                [r.vseg_pattern_type for r in records]),
            f"{prefix}_hseg_n": np.int32([r.hseg_n_offsets for r in records]),
            f"{prefix}_hseg_offsets": np.int32(
                [list(r.hseg_offsets) + [0] * (16 - r.hseg_n_offsets)
                 for r in records]),
            f"{prefix}_hseg_width": np.float32(
                [r.hseg_number_width for r in records]),
            f"{prefix}_scores": np.stack([r.scores for r in records])}


def ref_fixture_arrays():
    """What ref_session.npz holds (module docstring), from the port's
    refbridge: the C++'s answers, not JAX's."""
    from chip_smoke import (
        REF_CAMERA, REF_CASE_KEYS, REF_EXPIRY_SESSIONS, REF_FRAMES,
        REF_ORIENTATIONS, REF_PAN_SESSIONS, REF_SWEEP_EXPIRY, ref_cases,
        sha256, window_arrays)
    from cardio_dmz_tpu_torch import refbridge
    from cardio_dmz_tpu_torch.tools import parity_ab as ab

    oracle = refbridge.RefOracle.shared()
    rng = np.random.default_rng(2026)
    frame_cases = ab.frame_cases(rng, REF_FRAMES)
    pan_cases = ab.pan_session_cases(rng, REF_PAN_SESSIONS)
    expiry_cases = ab.expiry_session_cases(rng, REF_EXPIRY_SESSIONS)
    expiry_cases += [ab.sweep_expiry_case(k) for k in REF_SWEEP_EXPIRY]
    camera_cases = ab.camera_cases(rng, REF_CAMERA, REF_ORIENTATIONS)

    frames = [ab.render_frame_case(c) for c in frame_cases]
    pan_sessions = [ab.render_pan_session(c) for c in pan_cases]
    expiry_sessions = [ab.render_expiry_session(c) for c in expiry_cases]
    previews = [ab.render_camera_case(c) for c in camera_cases]

    pan_reads = [ab.ref_session(oracle, s, scan_expiry=False)
                 for s in pan_sessions]
    expiry_reads = [ab.ref_session(oracle, s, scan_expiry=True)
                    for s in expiry_sessions]
    camera = [ab.ref_camera(oracle, y, cb, c["orientation"])
              for (y, cb), c in zip(previews, camera_cases)]
    blank = np.zeros((270, 428), np.uint8)
    camera_scans = ab.ref_frames(oracle, [card if ok else blank
                                          for ok, _, card in camera])
    drawn = (frame_cases, pan_cases, expiry_cases, camera_cases)
    arrays = {f"{prefix}_{k}": np.array([c[k] for c in cases])
              for (prefix, keys), cases in zip(REF_CASE_KEYS, drawn)
              for k in keys}
    arrays.update({
        "frame_sha256": np.array(sha256(frames)),
        **_record_arrays("frame", ab.ref_frames(oracle, frames)),
        "pan_session_sha256": np.array(sha256(pan_sessions)),
        "pan_session_ref_pan": np.array([p or "" for p, _ in pan_reads]),
        "expiry_sha256": np.array(sha256(expiry_sessions)),
        "expiry_ref_pan": np.array([p or "" for p, _ in expiry_reads]),
        "expiry_ref_month": np.int32([d[0] if d else 0
                                      for _, d in expiry_reads]),
        "expiry_ref_year": np.int32([d[1] if d else 0
                                     for _, d in expiry_reads]),
        **window_arrays(ab.ref_expiry_windows(
            oracle, np.concatenate(expiry_sessions))),
        "camera_sha256": np.array(sha256([y for y, _ in previews])),
        "camera_found": np.array([ok for ok, _, _ in camera]),
        "camera_corners": np.stack([c for _, c, _ in camera]),
        "camera_card_sha256": np.array([sha256([card]) if ok else ""
                                        for ok, _, card in camera]),
        **_record_arrays("camera", camera_scans),
    })
    # the reader in chip_smoke.py rebuilds the cases this writer drew
    for want, got in zip(drawn, ref_cases(arrays)):
        for a, b in zip(want, got):
            assert a.keys() == b.keys() and all(
                np.array_equal(a[k], b[k]) for k in a), (a, b)
    return arrays


WRITERS = {"smoke": (FIXTURE, fixture_arrays),
           "camera": (CAMERA_FIXTURE, camera_fixture_arrays),
           "expiry": (EXPIRY_FIXTURE, expiry_fixture_arrays),
           "host": (HOST_FIXTURE, host_fixture_arrays),
           "glyphs": (GLYPH_FIXTURE, glyph_arrays),
           "expiry_glyphs": (EXPIRY_GLYPH_FIXTURE, expiry_glyph_arrays),
           "train": (TRAIN_FIXTURE, train_fixture_arrays),
           "sweep": (SWEEP_FIXTURE, sweep_fixture_arrays),
           "ref": (REF_FIXTURE, ref_fixture_arrays)}


if __name__ == "__main__":
    os.makedirs(_DATA, exist_ok=True)
    for name in sys.argv[1:] or WRITERS:
        path, arrays = WRITERS[name]
        np.savez_compressed(path, **arrays())
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")

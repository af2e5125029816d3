"""The homography, the coordinate maps and the exact warp of the port
against the JAX package's, and the portrait camera preprocessing.

* the persp-QR plain version against persp_host.persp_transform (what the
  JAX package runs off the TPU) and the JAX function, on 200 seeded
  corner sets and degenerate ones, bit for bit, NaN included, and with a
  destination set a stream against the JAX function vmapped over both;
* the float64 coordinate maps against persp_host's real double and the
  JAX package's double-float form, exactly;
* the exact warp's plain route (the maps, then the gather, from the
  homography) against warp_perspective_exact with the detector
  envelope's windows (api.warp_src_bounds), u8-equal, landscape and
  portrait, a NaN homography included. Quads come from that envelope:
  outside it the JAX forms read 0 for taps beyond their windows;
* the warp wrapper's checks and CPU route.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import torch_fixture as fx
from cardio_dmz_tpu import api as japi
from cardio_dmz_tpu.ops import persp as jpersp
from cardio_dmz_tpu.ops import persp_host
from cardio_dmz_tpu.ops import warp as jwarp
from cardio_dmz_tpu_torch import api as papi
from cardio_dmz_tpu_torch.constants import (
    ORIENTATION_LANDSCAPE_RIGHT, ORIENTATION_PORTRAIT)
from cardio_dmz_tpu_torch.ops import persp as ppersp
from cardio_dmz_tpu_torch.ops import warp as pwarp
from cardio_dmz_tpu_torch.ops.cuda import persp_qr, warp_gather
from chip_smoke import dest_rects
from torch_parity import to_np

OUT = (270, 428)
# the guide rect's corners in each orientation's warp order (api.py
# _CORNER_ORDER): landscape tl, tr, bl, br; portrait bl, tl, br, tr
GUIDE = {
    ORIENTATION_LANDSCAPE_RIGHT: np.float32([[106, 105], [534, 105],
                                             [106, 375], [534, 375]]),
    ORIENTATION_PORTRAIT: np.float32([[185, 454], [185, 26], [455, 454],
                                      [455, 26]]),
}


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _quads(orientation, n, seed, jitter=12.0):
    """n detector-realistic quads: the guide rect +-jitter px per corner
    (tests/test_pallas.py)."""
    rng = np.random.RandomState(seed)
    return (GUIDE[orientation][None]
            + rng.uniform(-jitter, jitter, (n, 4, 2))).astype(np.float32)


def _degenerate():
    """Corner sets that break the solve: all zero (a frame where no card
    was found), one corner repeated, three collinear, a line, inf, NaN."""
    g = GUIDE[ORIENTATION_LANDSCAPE_RIGHT]
    rep = g.copy()
    rep[1] = rep[0]
    col = g.copy()
    col[2] = (col[0] + col[1]) / 2
    line = np.float32([[0, 0], [1, 1], [2, 2], [3, 3]])
    inf = g.copy()
    inf[3, 0] = np.inf
    nan = g.copy()
    nan[0, 1] = np.nan
    return np.stack([np.zeros((4, 2), np.float32), rep, col, line, inf,
                     nan])


CARD_DEST = fx.CARD_DEST


def _port_persp(src):
    return to_np(persp_qr.eigen_persp_transform_batched(
        torch.from_numpy(src), torch.from_numpy(CARD_DEST)))


@pytest.mark.parametrize("seed", range(4))
def test_persp_plain_matches_persp_host(seed):
    """50 corner sets a seed (200 in all), half from the envelope and half
    up to 40 px off, with the degenerate sets in every batch."""
    src = np.concatenate([
        _quads(ORIENTATION_LANDSCAPE_RIGHT, 25, seed),
        _quads(ORIENTATION_LANDSCAPE_RIGHT, 25, seed + 100, jitter=40.0),
        _degenerate()])
    got = _port_persp(src)
    with np.errstate(invalid="ignore"):
        want = np.stack([persp_host.persp_transform(s, CARD_DEST)
                         for s in src])
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.isfinite(got[:50]).all()
    assert not np.isfinite(got[50]).all()    # the all-zero set


def test_persp_plain_matches_jax():
    src = np.concatenate([_quads(ORIENTATION_PORTRAIT, 6, 7),
                          _degenerate()[:1]])
    want = np.asarray(jax.jit(jax.vmap(
        lambda s: jpersp.eigen_persp_transform(s, CARD_DEST)))(src))
    np.testing.assert_array_equal(_bits(_port_persp(src)), _bits(want))


def test_persp_per_stream_dest_matches_jax():
    """A destination set a stream, as the JAX package's batched form
    takes it: the plain version, the wrapper's CPU route and
    ops.eigen_persp_transform against jax.vmap of the JAX function with
    both arguments batched, bit for bit."""
    src, dst = _quads(ORIENTATION_LANDSCAPE_RIGHT, 6, 5), dest_rects(
        np.random.RandomState(5), 6)
    assert len({d.tobytes() for d in dst}) == 6
    want = np.asarray(jax.jit(jax.vmap(jpersp.eigen_persp_transform))(
        src, dst))
    assert np.isfinite(want).all()
    t_src, t_dst = torch.from_numpy(src), torch.from_numpy(dst)
    for got in (persp_qr.persp_transform_reference(t_src, t_dst),
                persp_qr.eigen_persp_transform_batched(t_src, t_dst),
                ppersp.eigen_persp_transform(t_src, t_dst)):
        np.testing.assert_array_equal(_bits(to_np(got)), _bits(want))
    # a shared set is every stream's: equal to that set repeated
    shared = persp_qr.eigen_persp_transform_batched(t_src, t_dst[2])
    np.testing.assert_array_equal(_bits(to_np(shared)), _bits(to_np(
        persp_qr.eigen_persp_transform_batched(
            t_src, t_dst[2].expand(6, 4, 2).contiguous()))))


def test_persp_per_stream_dest_checks():
    src = torch.from_numpy(_quads(ORIENTATION_LANDSCAPE_RIGHT, 3, 4))
    dst = torch.from_numpy(dest_rects(np.random.RandomState(4), 3))
    assert persp_qr.eigen_persp_transform_batched(src, dst).shape == (3, 3, 3)
    for bad in (dst[:, :3], dst[:2], torch.cat([dst, dst[:1]]), dst[None]):
        with pytest.raises(ValueError):
            persp_qr.eigen_persp_transform_batched(src, bad.contiguous())
    with pytest.raises(TypeError):
        persp_qr.eigen_persp_transform_batched(src, dst.double())


def test_persp_qr_ops_counts_the_solve():
    """persp_qr.persp_qr_ops, the model behind persp QR's bound (its
    wrapper's work formula) and chain floor, against a closed count of the solve's f32 operations:
    the system's 16 products, each Householder step's norm, beta, ess,
    tau and update, Q^T b, and the back-substitution."""
    n, ops = 8, 16
    for k in range(n):
        nt = n - 1 - k
        if nt:
            ops += 2 * nt - 1 + 3 + 1 + nt + 2   # tsq, beta, c0-beta, ess, tau
            ops += nt * 2 * nt + 2 * nt + nt * (1 + 2 * nt)   # the update
        ops += 2 if nt == 0 else 2 * nt + 2 + 3 * nt      # Q^T b
    ops += sum(1 + 2 * j for j in range(n))       # back-substitution
    n_ops, chain, on_chain = persp_qr.persp_qr_ops()
    assert n_ops == ops == 999
    assert chain == sum(on_chain.values()) == 120
    assert on_chain["div"] == 15 and on_chain["sqrt"] == 7
    weighted = persp_qr.persp_qr_ops(
        {"add": 1, "mul": 1, "div": 10, "sqrt": 10})[1]
    assert weighted == 120 + 9 * 22


def test_persp_wrapper_cpu_route_and_checks():
    src = torch.from_numpy(_quads(ORIENTATION_LANDSCAPE_RIGHT, 2, 3))
    dst = torch.from_numpy(CARD_DEST)
    before = persp_qr.LAUNCHES
    assert persp_qr.eigen_persp_transform_batched(src, dst).shape == (2, 3, 3)
    assert persp_qr.LAUNCHES == before and not persp_qr.KERNEL.loaded
    with pytest.raises(TypeError):
        persp_qr.eigen_persp_transform_batched(src.double(), dst)
    with pytest.raises(ValueError):
        persp_qr.eigen_persp_transform_batched(src[:, :3], dst)


@functools.lru_cache(maxsize=None)
def _jax_maps():
    return jax.jit(lambda m: jpersp.warp_coord_maps(m, OUT)[:2])


@pytest.mark.parametrize("orientation", [ORIENTATION_LANDSCAPE_RIGHT,
                                         ORIENTATION_PORTRAIT])
def test_coord_maps_match_double_and_jax(orientation):
    src = _quads(orientation, 3, orientation)
    m = _port_persp(src)
    x, y = ppersp.warp_coord_maps(torch.from_numpy(m), OUT)
    for s in range(len(src)):
        hx, hy = persp_host.warp_coord_maps(m[s], OUT)
        np.testing.assert_array_equal(to_np(x[s]), hx)
        np.testing.assert_array_equal(to_np(y[s]), hy)
        jx, jy = _jax_maps()(m[s])
        np.testing.assert_array_equal(to_np(x[s]), np.asarray(jx))
        np.testing.assert_array_equal(to_np(y[s]), np.asarray(jy))


def test_coord_maps_of_degenerate_homographies_stay_defined():
    m = _port_persp(_degenerate())
    x, y = ppersp.warp_coord_maps(torch.from_numpy(m), OUT)
    assert x.dtype == torch.int32 and x.shape == (6,) + OUT
    # the all-zero corners give a NaN homography; its maps read INT32_MIN,
    # as cvRound gives NaN on x86 and the real-double chain does
    assert int(x[0].max()) == int(y[0].min()) == -2**31
    with np.errstate(all="ignore"):
        hx, hy = persp_host.warp_coord_maps(m[0], OUT)
    np.testing.assert_array_equal(to_np(x[0]), hx)
    np.testing.assert_array_equal(to_np(y[0]), hy)


@pytest.mark.parametrize("orientation", [ORIENTATION_LANDSCAPE_RIGHT,
                                         ORIENTATION_PORTRAIT])
def test_warp_plain_matches_jax_windowed(orientation):
    """Uniform-noise frames, where every flipped tap would change the
    output, warped through envelope quads. The JAX function runs op by
    op: jitted on the CPU, XLA may fuse the multiplies and adds of its
    double-float coordinate math into FMAs and move a quantized
    coordinate across a rounding boundary (ROADMAP.md, queue 3), which
    neither the TPU nor the real double chain does. The last stream's
    corners are all zero: its homography is NaN and its card 0."""
    rng = np.random.RandomState(11)
    img = rng.randint(1, 256, (4, 480, 640)).astype(np.uint8)
    m = _port_persp(np.concatenate([_quads(orientation, 3, 20 + orientation),
                                    _degenerate()[:1]]))
    transpose = papi._orientation_transposes(orientation)
    got = to_np(warp_gather.warp_perspective_reference(
        torch.from_numpy(img), torch.from_numpy(m), OUT, transpose))
    entry = pwarp.warp_perspective_exact(
        torch.from_numpy(img), torch.from_numpy(m), OUT, transpose=transpose)
    np.testing.assert_array_equal(to_np(entry), got)   # the CPU route
    bounds = japi.warp_src_bounds((480, 640), orientation)
    with jax.disable_jit():
        want = np.asarray(jax.vmap(lambda im, mm: jwarp.warp_perspective_exact(
            im, mm, OUT, src_bounds=bounds, transpose=transpose))(img, m))
    np.testing.assert_array_equal(got, want)
    for s in range(4):
        with np.errstate(all="ignore"):
            host = persp_host.warp_exact(img[s], m[s], OUT)
        np.testing.assert_array_equal(got[s], host)
    assert not got[3].any()


def test_warp_gather_plain_reads_zero_outside():
    img = torch.full((1, 4, 5), 200, dtype=torch.uint8)
    # x0 = -1 (only the x0+1 tap inside), far out, inside, and INT32_MIN (a
    # NaN coordinate)
    xq = torch.tensor([[[-32 + 16, -10_000, 32 + 8, -2**31]]],
                      dtype=torch.int32)
    yq = torch.tensor([[[32, 32, 32, 32]]], dtype=torch.int32)
    got = to_np(warp_gather.warp_gather_reference(img, xq, yq))[0, 0]
    assert got.tolist() == [100, 0, 200, 0]


@pytest.mark.parametrize("orientation", [ORIENTATION_LANDSCAPE_RIGHT,
                                         ORIENTATION_PORTRAIT])
def test_warp_of_nan_homography_is_a_zero_card(orientation):
    """All-zero corners (a frame where no card was found) give a NaN
    homography; its warp is defined and 0 everywhere, through unwarp_card
    and the plain route, whatever the frame holds."""
    img = torch.full((2, 480, 640), 255, dtype=torch.uint8)
    transpose = papi._orientation_transposes(orientation)
    card = pwarp.unwarp_card(img, torch.zeros((2, 4, 2)), OUT, transpose)
    assert card.shape == (2,) + OUT and card.dtype == torch.uint8
    assert not card.any()
    m = torch.full((1, 3, 3), float("nan"))
    assert not warp_gather.warp_perspective_reference(
        img[:1], m, OUT, transpose).any()


def test_warp_gather_wrapper_checks():
    img = torch.zeros((2, 8, 8), dtype=torch.uint8)
    m = torch.eye(3).expand(2, 3, 3).contiguous()
    before = warp_gather.LAUNCHES
    for transpose in (False, True):
        got = warp_gather.warp_perspective_exact(img, m, (3, 4), transpose)
        assert got.shape == (2, 3, 4) and got.dtype == torch.uint8
    assert warp_gather.LAUNCHES == before and not warp_gather.KERNEL.loaded
    with pytest.raises(TypeError):      # dtypes
        warp_gather.warp_perspective_exact(img.int(), m, (3, 4))
    with pytest.raises(TypeError):
        warp_gather.warp_perspective_exact(img, m.double(), (3, 4))
    with pytest.raises(TypeError):      # the transpose flag is a bool
        warp_gather.warp_perspective_exact(img, m, (3, 4), 1)
    with pytest.raises(ValueError):     # shapes
        warp_gather.warp_perspective_exact(img[:1], m, (3, 4))
    with pytest.raises(ValueError):
        warp_gather.warp_perspective_exact(img[0], m[0], (3, 4))
    with pytest.raises(ValueError):
        warp_gather.warp_perspective_exact(img, m[:, :2], (3, 4))
    with pytest.raises(ValueError):     # out_shape
        warp_gather.warp_perspective_exact(img, m, (0, 4))
    with pytest.raises(ValueError):
        warp_gather.warp_perspective_exact(img, m, (3, 4, 1))
    with pytest.raises(ValueError):     # devices
        warp_gather.warp_perspective_exact(img, m.to("meta"), (3, 4))
    with pytest.raises(ValueError):     # no route off the CPU and CUDA
        warp_gather.warp_perspective_exact(img.to("meta"), m.to("meta"),
                                           (3, 4))
    with pytest.raises(ValueError):     # contiguity
        warp_gather.warp_perspective_exact(img.transpose(1, 2), m, (3, 4))
    with pytest.raises(ValueError):
        warp_gather.warp_perspective_exact(img, m.transpose(1, 2), (3, 4))


# --- the camera preprocessing in a portrait orientation --------------------

def _portrait_frames():
    """A card turned a quarter turn onto the portrait guide rect, and a
    tilted one pasted with chroma, as (Y, Cb, Cr) stacks of 2."""
    card = fx.synthetic.render_frame("4111111111111111", seed=3, noise=0,
                                     y0=150, width=18.5, offset=30)
    y = np.full((480, 640), 50, np.uint8)
    y[26:26 + 428, 185:185 + 270] = np.rot90(card)
    flat = np.full((240, 320), 128, np.uint8)
    tilted = fx.camera_preview(card, ((188.0, 450.0), (183.0, 28.0),
                                      (452.0, 455.0), (457.0, 24.0)))
    return tuple(np.stack(p) for p in zip((y, flat, flat), tilted))


def test_preprocess_frame_portrait_matches_jax():
    """Corners against the JAX package's detect_edges run op by op, and
    the card against its real-double warp chain (persp_host) from them."""
    y, cb, cr = _portrait_frames()
    t = [torch.from_numpy(a) for a in (y, cb, cr)]
    _, corners = papi.detect_edges(*t, orientation=ORIENTATION_PORTRAIT)
    want = fx.op_by_op_corners(y, cb, cr, ORIENTATION_PORTRAIT)
    np.testing.assert_array_equal(_bits(fx.corner_array(corners)),
                                  _bits(want))
    found, card = papi.preprocess_frame(*t, orientation=ORIENTATION_PORTRAIT)
    assert to_np(found).all()
    order = [("tl", "tr", "bl", "br").index(k)
             for k in papi._CORNER_ORDER[ORIENTATION_PORTRAIT]]
    for s in range(2):
        np.testing.assert_array_equal(to_np(card[s]),
                                      persp_host.unwarp_card_exact(
                                          y[s], want[s][order], OUT))

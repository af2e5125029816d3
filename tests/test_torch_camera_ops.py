"""The camera path's ops in the port against the JAX package's: sobel7 and
sobel3, NMS, bounded hysteresis, canny and the Hough stage on rendered
detection bands and on noise, exactly; the line geometry against the JAX
functions run op by op; and the trig values of every reachable Hough
angle of every detection band."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fixture as fx
from cardio_dmz_tpu import api as japi
from cardio_dmz_tpu.ops import canny as jcanny
from cardio_dmz_tpu.ops import hough as jhough
from cardio_dmz_tpu.ops import sobel as jsobel
from cardio_dmz_tpu.utils import geometry as jgeom
from cardio_dmz_tpu_torch import api as papi
from cardio_dmz_tpu_torch.constants import (
    HORIZONTAL_ANGLE, HOUGH_THETA_RES, MAX_ANGLE_DEVIATION,
    ORIENTATION_LANDSCAPE_LEFT, ORIENTATION_LANDSCAPE_RIGHT,
    ORIENTATION_PORTRAIT, ORIENTATION_PORTRAIT_UPSIDE_DOWN, VERTICAL_ANGLE)
from cardio_dmz_tpu_torch.ops import canny as pcanny
from cardio_dmz_tpu_torch.ops import hough as phough
from cardio_dmz_tpu_torch.ops import sobel as psobel
from cardio_dmz_tpu_torch.utils import geometry as pgeom
from torch_parity import to_np

ORIENTATIONS = (ORIENTATION_PORTRAIT, ORIENTATION_PORTRAIT_UPSIDE_DOWN,
                ORIENTATION_LANDSCAPE_RIGHT, ORIENTATION_LANDSCAPE_LEFT)
N_ANGLES = 10   # the Hough window: +-5 degrees in 1-degree steps


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


@functools.lru_cache(maxsize=None)
def _bands():
    """{name: (B, h, w) uint8}: the 12 detection bands of the camera
    fixture's first frame of each stream (a guide-aligned and a tilted
    card), and uniform-noise bands of the same shapes."""
    y, cb, cr = fx.camera_frames()
    samples = (y[:, 0], cb[:, 0], cr[:, 0])
    rng = np.random.RandomState(5)
    out = {}
    for p, plane in enumerate(samples):
        boxes = japi.detection_boxes(plane.shape, ORIENTATION_LANDSCAPE_RIGHT)
        for name, (x, y0, w, h) in boxes.items():
            out[f"card-{p}-{name}"] = plane[:, y0:y0 + h, x:x + w]
            out[f"noise-{p}-{name}"] = rng.randint(
                0, 256, (2, h, w)).astype(np.uint8)
    return out


BAND_NAMES = [f"{kind}-{p}-{name}" for kind in ("card", "noise")
              for p in range(3) for name in ("top", "bottom", "left", "right")]


def _vertical(name):
    return name.endswith(("left", "right"))


@functools.lru_cache(maxsize=None)
def _sobel_pair(name):
    band = _bands()[name]
    return (np.asarray(jsobel.sobel7(band, dx=True, dy=False)),
            np.asarray(jsobel.sobel7(band, dx=False, dy=True)))


def _thresholds(dx, dy):
    """The JAX package's adaptive thresholds for (B, h, w) bands, as
    (B, 1, 1) int32 (api.py:264-267)."""
    h, w = dx.shape[-2:]
    band_sum = (np.abs(dx).astype(np.int32)
                + np.abs(dy).astype(np.int32)).sum(axis=(-2, -1))
    mean = jnp.asarray(band_sum).astype(jnp.float32) / (h * w)
    low = np.asarray(jnp.floor(mean).astype(jnp.int32))
    high = np.asarray(jnp.floor(3.0 * mean).astype(jnp.int32))
    return low[:, None, None], high[:, None, None]


@pytest.mark.parametrize("name", BAND_NAMES)
def test_sobel7_matches_jax(name):
    dx, dy = _sobel_pair(name)
    band = torch.from_numpy(_bands()[name])
    np.testing.assert_array_equal(to_np(psobel.sobel7(band, True, False)), dx)
    np.testing.assert_array_equal(to_np(psobel.sobel7(band, False, True)), dy)


@pytest.mark.parametrize("kind", ["card", "noise", "saturating"])
def test_sobel3_dx_dy_matches_jax(kind):
    if kind == "saturating":
        x = np.zeros((2, 90, 142), np.uint8)
        x[:, ::2, ::3] = 255
    else:
        x = fx.camera_frames()[0][:, 0, 195:285, 249:391]
        if kind == "noise":
            x = np.random.RandomState(2).randint(0, 256, x.shape).astype(
                np.uint8)
    np.testing.assert_array_equal(
        to_np(psobel.sobel3_dx_dy(torch.from_numpy(x))),
        np.asarray(jsobel.sobel3_dx_dy(x)))


@pytest.mark.parametrize("name", BAND_NAMES)
def test_canny_matches_jax(name):
    """NMS, bounded hysteresis and the u8 edge map of one band, with the
    band's adaptive thresholds."""
    dx, dy = _sobel_pair(name)
    low, high = _thresholds(dx, dy)
    tdx, tdy = torch.from_numpy(dx.copy()), torch.from_numpy(dy.copy())
    cand = np.asarray(jcanny.canny_nms(dx, dy, low))
    np.testing.assert_array_equal(
        to_np(pcanny.canny_nms(tdx, tdy, torch.from_numpy(low))), cand)
    ref = np.asarray(jcanny.canny7_precomputed_sobel(dx, dy, low, high))
    got = to_np(pcanny.canny7_precomputed_sobel(
        tdx, tdy, torch.from_numpy(low), torch.from_numpy(high)))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_bounded_hysteresis_on_percolating_noise():
    """Low-amplitude noise percolates: there three sweeps of the bounded
    hysteresis stop short of the exact flood. The port equals the bounded
    form (both of the JAX package's lowerings), not the flood."""
    rng = np.random.RandomState(1)
    band = np.clip(128 + rng.randint(-8, 9, (54, 536)), 0,
                   255).astype(np.uint8)
    dx = np.asarray(jsobel.sobel7(band, dx=True, dy=False))
    dy = np.asarray(jsobel.sobel7(band, dx=False, dy=True))
    low, high = _thresholds(dx[None], dy[None])
    cand = np.asarray(jcanny.canny_nms(dx, dy, low[0]))
    strong = cand & (np.abs(dx) + np.abs(dy) > high[0])
    bounded = np.asarray(jcanny.hysteresis_bounded_unpacked(cand, strong))
    np.testing.assert_array_equal(
        np.asarray(jcanny.hysteresis_bounded(cand, strong)), bounded)
    exact = np.asarray(jcanny.hysteresis(cand, strong))
    assert (bounded != exact).any()
    got = to_np(pcanny.hysteresis_bounded(torch.from_numpy(cand),
                                          torch.from_numpy(strong)))
    np.testing.assert_array_equal(got, bounded)


@pytest.mark.parametrize("density", [0.3, 0.6])
def test_bounded_hysteresis_random_masks(density):
    rng = np.random.RandomState(int(density * 10))
    cand = rng.rand(3, 41, 77) < density
    strong = rng.rand(3, 41, 77) < 0.02
    for s in range(3):
        ref = np.asarray(jcanny.hysteresis_bounded_unpacked(cand[s],
                                                            strong[s]))
        got = to_np(pcanny.hysteresis_bounded(torch.from_numpy(cand[s]),
                                              torch.from_numpy(strong[s])))
        np.testing.assert_array_equal(got, ref)


def _hough_kwargs(name, h, w):
    base = VERTICAL_ANGLE if _vertical(name) else HORIZONTAL_ANGLE
    return dict(rho=1.0, theta=HOUGH_THETA_RES, threshold=max(w, h) // 6,
                theta_min=base - MAX_ANGLE_DEVIATION,
                theta_max=base + MAX_ANGLE_DEVIATION,
                vertical=_vertical(name), gradient_angle_threshold=10.0)


@pytest.mark.parametrize("name", BAND_NAMES)
def test_hough_matches_jax(name):
    """The Hough stage of one band against the JAX function run unjitted,
    op by op, so that its f32 angle n*theta_res + theta_min is not fused
    into an FMA; bit for bit. Noise bands find no line."""
    dx, dy = _sobel_pair(name)
    low, high = _thresholds(dx, dy)
    edges = np.asarray(jcanny.canny7_precomputed_sobel(dx, dy, low, high))
    h, w = edges.shape[-2:]
    kw = _hough_kwargs(name, h, w)
    got = phough.hough_best_line(torch.from_numpy(edges),
                                 torch.from_numpy(dx), torch.from_numpy(dy),
                                 **kw)
    ref = jax.vmap(functools.partial(jhough.hough_best_line, **kw))(
        edges, dx, dy)
    np.testing.assert_array_equal(to_np(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(_bits(to_np(got[1])), _bits(ref[1]))
    np.testing.assert_array_equal(_bits(to_np(got[2])), _bits(ref[2]))
    # the cards' chroma planes are flat except on the tilted card's
    found = ~to_np(got[0])
    if name.startswith("noise"):
        assert not found.any()
    elif name.startswith("card-0"):
        assert found.all()
    else:
        assert found.tolist() == [False, True]


def _reachable_angles(vertical):
    """The f32 angles the Hough stage can emit, n*theta_res + theta_min
    with each op rounded on its own, and 0 (no line)."""
    base = VERTICAL_ANGLE if vertical else HORIZONTAL_ANGLE
    n = torch.arange(N_ANGLES, dtype=torch.float32)
    theta = n * HOUGH_THETA_RES + (base - MAX_ANGLE_DEVIATION)
    return torch.cat([theta, torch.zeros(1)])


def _band_origins():
    """(x, y, vertical) of every detection band of every plane, in every
    orientation."""
    out = set()
    for orientation in ORIENTATIONS:
        for shape in ((480, 640), (240, 320)):
            boxes = papi.detection_boxes(shape, orientation)
            for name, vertical in papi._EDGE_SPECS:
                x, y, _, _ = boxes[name]
                out.add((x, y, vertical))
    return sorted(out)


@pytest.mark.parametrize("vertical", [False, True])
def test_trig_of_reachable_angles_equals_jax(vertical):
    """sin/cos in float64 rounded to f32 equal XLA:CPU's f32 jnp.sin and
    jnp.cos at every angle the Hough stage can emit, and at every argument
    cos(pi/2 - delta) that line_by_shifting_origin takes for every band's
    origin; the port takes its corners' trig from these."""
    theta = _reachable_angles(vertical)
    s, c = pgeom.sin_cos(theta)
    np.testing.assert_array_equal(_bits(to_np(s)),
                                  _bits(jnp.sin(to_np(theta))))
    np.testing.assert_array_equal(_bits(to_np(c)),
                                  _bits(jnp.cos(to_np(theta))))
    for x, y, band_vertical in _band_origins():
        if band_vertical != vertical:
            continue
        offset_angle = (math.pi / 2.0 if x == 0
                        else math.atan(float(y) / float(x)))
        arg = math.pi / 2.0 - (theta - offset_angle + math.pi / 2.0)
        _, c = pgeom.sin_cos(arg)
        np.testing.assert_array_equal(_bits(to_np(c)),
                                      _bits(jnp.cos(to_np(arg))))


def _random_lines(seed, n=64):
    """Lines at reachable angles: horizontal ones (top/bottom) and
    vertical ones (left/right), with rho in band-local and full-image
    ranges."""
    rng = np.random.RandomState(seed)
    th = _reachable_angles(False)[rng.randint(0, N_ANGLES, n)]
    tv = _reachable_angles(True)[rng.randint(0, N_ANGLES, n)]
    rh = torch.from_numpy(rng.uniform(-40, 420, n).astype(np.float32))
    rv = torch.from_numpy(rng.uniform(-600, -20, n).astype(np.float32))
    return rh, th, rv, tv


@pytest.mark.parametrize("seed", [0, 1])
def test_parametric_intersect_matches_op_by_op_jax(seed):
    rh, th, rv, tv = _random_lines(seed)
    ok, x, y = pgeom.parametric_intersect_torch(rh, th, rv, tv)
    with jax.disable_jit():
        rok, rx, ry = jgeom.parametric_intersect_jax(
            jnp.asarray(to_np(rh)), jnp.asarray(to_np(th)),
            jnp.asarray(to_np(rv)), jnp.asarray(to_np(tv)))
    np.testing.assert_array_equal(to_np(ok), np.asarray(rok))
    np.testing.assert_array_equal(_bits(to_np(x)), _bits(rx))
    np.testing.assert_array_equal(_bits(to_np(y)), _bits(ry))


@pytest.mark.parametrize("origin", [(125, 91), (87, 119), (514, 119),
                                    (0, 40), (63, 180)])
def test_line_by_shifting_origin_matches_op_by_op_jax(origin):
    rh, th, rv, tv = _random_lines(sum(origin))
    for rho, theta in ((rh, th), (rv, tv)):
        got, got_theta = pgeom.line_by_shifting_origin_torch(
            rho, theta, *origin)
        with jax.disable_jit():
            ref, _ = jgeom.line_by_shifting_origin_jax(
                jnp.asarray(to_np(rho)), jnp.asarray(to_np(theta)), *origin)
        np.testing.assert_array_equal(_bits(to_np(got)), _bits(ref))
        assert got_theta is theta


def test_detection_boxes_match_jax():
    for orientation in ORIENTATIONS + (0,):
        for shape in ((480, 640), (240, 320), (640, 480)):
            assert papi.detection_boxes(shape, orientation) == \
                japi.detection_boxes(shape, orientation)

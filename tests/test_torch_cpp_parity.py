"""The port against the COMPILED card.io C++ (cardio_dmz_tpu_torch.refbridge).

One test for each of tests/test_cpp_parity.py, with the port on the CPU
where that file runs the JAX package: the same inputs (tests/synthetic.py,
the same seeds) and the same tolerances. On the CPU the port's kernel
wrappers run their plain versions, so the digit prep, persp QR and warp
tests hold those against the C++. The oracle links from the objects under
native/refshim/build/; the file skips only when refbridge.missing() names
a missing prerequisite (g++, the system OpenCV, the objects).

Tolerances: 1e-5 on the four models' outputs; equality on sobel7, scharr,
morph, equalize, canny, segmentation and digits; rel 1e-4 on focus and
brightness; the homography's uint32 view and the exact warp bit for bit;
Hough rho within 1e-4 and theta within 1e-6 with the same null flag;
vseg score within 2e-3; hseg width within 1e-6; digit scores within 2e-4
given the reference's hseg; corners within 1e-2 px.
"""

import functools
import math

import numpy as np
import pytest
import torch

import synthetic
import tiers

from cardio_dmz_tpu_torch import api as papi
from cardio_dmz_tpu_torch import refbridge
from cardio_dmz_tpu_torch.config import ScanConfig
from cardio_dmz_tpu_torch.constants import (
    LANDSCAPE_HORIZONTAL_INSET, LANDSCAPE_VERTICAL_INSET)
from cardio_dmz_tpu_torch.models import load_all_params
from cardio_dmz_tpu_torch.refbridge import (
    corner_array, corner_points, frame_records, group_to_ref,
    ref_frame_record)
from cardio_dmz_tpu_torch.session import HostScanner, scanner_reset
from cardio_dmz_tpu_torch.session.state import scanner_step
from torch_parity import to_np

pytestmark = pytest.mark.skipif(
    not refbridge.available(),
    reason="compiled reference unavailable: "
           + "; ".join(refbridge.missing()))

DEST = np.float32([[0, 0], [427, 0], [0, 269], [427, 269]])


@functools.lru_cache(maxsize=None)
def _oracle():
    return refbridge.RefOracle.shared()


@functools.lru_cache(maxsize=None)
def _params():
    return load_all_params("cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_reference_selfcheck():
    assert _oracle().models_selfcheck()


# ---------------------------------------------------------------- models


def test_vseg_mlp_parity_fuzz():
    rng = np.random.default_rng(0)
    model = _params()["vseg_mlp"]
    for _ in range(8):
        x = rng.uniform(0, 1, 204).astype(np.float32)
        ours = to_np(model(_t(x)))
        np.testing.assert_allclose(ours, _oracle().model_vseg(x), atol=1e-5)


def test_pan_conv_parity_fuzz():
    rng = np.random.default_rng(1)
    params = _params()
    for which, key in enumerate(["pan_conv_a", "pan_conv_b", "pan_conv_c"]):
        for _ in range(4):
            img = rng.uniform(0, 1, (27, 19)).astype(np.float32)
            ours = to_np(params[key](_t(img)))
            np.testing.assert_allclose(ours, _oracle().model_pan(which, img),
                                       atol=1e-5)


def test_slash_mlp_parity_fuzz():
    rng = np.random.default_rng(2)
    model = _params()["slash_mlp"]
    for _ in range(8):
        x = rng.uniform(0, 1, 176).astype(np.float32)
        ours = to_np(model(_t(x)))
        np.testing.assert_allclose(ours, _oracle().model_slash(x), atol=1e-5)


def test_expiry_conv_parity_fuzz():
    rng = np.random.default_rng(3)
    model = _params()["expiry_conv"]
    for _ in range(4):
        img = rng.uniform(0, 1, (16, 11)).astype(np.float32)
        ours = to_np(model(_t(img)))
        np.testing.assert_allclose(ours, _oracle().model_expiry(img),
                                   atol=1e-5)


# ---------------------------------------------------------------- kernels


def _rand_img(rng, h, w):
    return rng.integers(0, 256, (h, w), dtype=np.uint8)


def test_sobel7_parity():
    from cardio_dmz_tpu_torch.ops import sobel7

    rng = np.random.default_rng(4)
    img = _rand_img(rng, 54, 160)
    for dx in (True, False):
        ours = to_np(sobel7(_t(img), dx, not dx))
        np.testing.assert_array_equal(ours, _oracle().sobel7(img, dx))


def test_scharr3_parity():
    from cardio_dmz_tpu_torch.ops import scharr3_dx_abs, scharr3_dy_abs

    rng = np.random.default_rng(5)
    img = _rand_img(rng, 60, 120)
    np.testing.assert_array_equal(
        to_np(scharr3_dx_abs(_t(img))).astype(np.int16),
        _oracle().scharr3_abs(img, True))
    np.testing.assert_array_equal(
        to_np(scharr3_dy_abs(_t(img))).astype(np.int16),
        _oracle().scharr3_abs(img, False))


def test_morph_grad_parity():
    from cardio_dmz_tpu_torch.ops import (
        morph_grad3_1d_u8, morph_grad3_2d_cross_u8)

    rng = np.random.default_rng(6)
    strip = _rand_img(rng, 1, 408)
    np.testing.assert_array_equal(to_np(morph_grad3_1d_u8(_t(strip))),
                                  _oracle().morph_grad3(strip, False))
    img = _rand_img(rng, 27, 428)
    np.testing.assert_array_equal(to_np(morph_grad3_2d_cross_u8(_t(img))),
                                  _oracle().morph_grad3(img, True))


def test_equalize_hist_parity():
    from cardio_dmz_tpu_torch.ops import equalize_hist

    rng = np.random.default_rng(7)
    img = _rand_img(rng, 16, 11)
    np.testing.assert_array_equal(to_np(equalize_hist(_t(img))),
                                  _oracle().equalize_hist(img))


def test_focus_brightness_parity():
    rng = np.random.default_rng(8)
    img = _rand_img(rng, 270, 428)
    ours_f = float(papi.focus_score(_t(img[None]), use_full_image=False)[0])
    ref_f = _oracle().focus_score(img, use_full_image=False)
    assert ours_f == pytest.approx(ref_f, rel=1e-4)
    ours_b = float(papi.brightness_score(_t(img[None]),
                                         use_full_image=False)[0])
    ref_b = _oracle().brightness_score(img, use_full_image=False)
    assert ours_b == pytest.approx(ref_b, rel=1e-4)


def test_persp_transform_bit_exact_parity():
    """llcv_calc_persp_transform (Eigen f32 householderQr, cv/warp.cpp:
    34-125) against the persp-QR wrapper's plain version, BIT-exact over
    randomized detector-realistic corner sets, one set at a time and all
    50 as one batch. The 8x8 system's conditioning amplifies any 1-ulp
    sequence deviation to ~1e3 ulp, so equality here is a strong gate."""
    from cardio_dmz_tpu_torch.ops import eigen_persp_transform

    rng = np.random.default_rng(42)
    srcs = []
    for _ in range(50):
        srcs.append(np.float32([[106, 105], [534, 105], [106, 375],
                                [534, 375]])
                    + rng.uniform(-25, 25, (4, 2)).astype(np.float32))
    refs = np.stack([_oracle().persp_transform(s, DEST) for s in srcs])
    one = np.stack([to_np(eigen_persp_transform(_t(s[None]), _t(DEST)))[0]
                    for s in srcs])
    batch = to_np(eigen_persp_transform(_t(np.stack(srcs)), _t(DEST)))
    np.testing.assert_array_equal(refs.view(np.uint32), one.view(np.uint32))
    np.testing.assert_array_equal(refs.view(np.uint32),
                                  batch.view(np.uint32))


def test_warp_exact_pixel_parity():
    """unwarp_card's exact route == cvWarpPerspective BIT-FOR-BIT: the
    whole rectification chain (persp QR + double coords + 5-bit
    fixed-point bilinear, the warp wrapper's plain version) on random
    noise images (worst case: every quantization flip would change the
    output), one image at a time and the four as one batch."""
    from cardio_dmz_tpu_torch.ops import unwarp_card

    rng = np.random.default_rng(7)
    srcs, imgs, refs = [], [], []
    for _ in range(4):
        src = (np.float32([[106, 105], [534, 105], [106, 375], [534, 375]])
               + rng.uniform(-12, 12, (4, 2)).astype(np.float32))
        img = rng.integers(0, 256, (480, 640)).astype(np.uint8)
        m = _oracle().persp_transform(src, DEST)
        refs.append(_oracle().warp_perspective(img, m, (270, 428)))
        srcs.append(src)
        imgs.append(img)
        np.testing.assert_array_equal(
            to_np(unwarp_card(_t(img[None]), _t(src[None])))[0], refs[-1])
    np.testing.assert_array_equal(
        to_np(unwarp_card(_t(np.stack(imgs)), _t(np.stack(srcs)))),
        np.stack(refs))


def _camera_frame(rng, seed, noise_lo, noise_hi):
    card = np.asarray(synthetic.render_frame(synthetic.safe_pan(rng),
                                             seed=seed))
    y = np.full((480, 640), 50, np.int32) + rng.integers(noise_lo, noise_hi,
                                                         (480, 640))
    y[105:105 + 270, 106:106 + 428] = card
    return np.clip(y, 0, 255).astype(np.uint8)


def test_canny7_kernel_parity():
    """adaptive canny7 (the serving bounded hysteresis, the port's only
    form) against the compiled reference (llcv_adaptive_canny7_
    precomputed_sobel, cv/canny.cpp:568-580) on the detection bands of
    a pasted card."""
    from cardio_dmz_tpu_torch.ops import adaptive_canny7

    y = _camera_frame(np.random.default_rng(5), 3, -4, 5)
    for x, yy, w, h in papi.detection_boxes((480, 640), 3).values():
        band = y[yy:yy + h, x:x + w]
        got, _, _ = adaptive_canny7(_t(band[None]))
        np.testing.assert_array_equal(to_np(got)[0], _oracle().canny7(band))


def test_hough_kernel_parity():
    """The gradient-gated Hough against the compiled reference (llcv_hough,
    cv/hough.cpp:52-195), fed the reference's own canny/sobel planes so the
    gate isolates the vote/argmax machinery."""
    from cardio_dmz_tpu_torch.ops import hough_best_line

    y = _camera_frame(np.random.default_rng(9), 4, -3, 4)
    for name, (x, yy, w, h) in papi.detection_boxes((480, 640), 3).items():
        band = y[yy:yy + h, x:x + w]
        vertical = name in ("left", "right")
        dx = _oracle().sobel7(band, True)
        dy = _oracle().sobel7(band, False)
        edges = _oracle().canny7(band)
        base = math.pi if vertical else math.pi / 2
        kwargs = dict(rho_res=1.0, theta_res=math.pi / 180,
                      threshold=max(w, h) // 6,
                      theta_min=base - 5 * math.pi / 180,
                      theta_max=base + 5 * math.pi / 180,
                      vertical=vertical, gradient_angle_threshold=10.0)
        ref_rho, ref_theta, ref_null = _oracle().hough(edges, dx, dy,
                                                       **kwargs)
        is_null, rho, theta = hough_best_line(
            _t(edges[None]), _t(dx[None].astype(np.int32)),
            _t(dy[None].astype(np.int32)), rho=1.0, theta=math.pi / 180,
            threshold=max(w, h) // 6, theta_min=kwargs["theta_min"],
            theta_max=kwargs["theta_max"], vertical=vertical,
            gradient_angle_threshold=10.0)
        assert bool(is_null[0]) == ref_null
        if not ref_null:
            assert float(rho[0]) == pytest.approx(ref_rho, abs=1e-4)
            assert float(theta[0]) == pytest.approx(ref_theta, abs=1e-6)


# ----------------------------------------------------------- frame stages


def _frames(n=6, with_expiry=False, seed0=0):
    out = []
    rng = np.random.default_rng(seed0)
    for i in range(n):
        pan = synthetic.safe_pan(rng, length=16, prefix=(4,))
        if with_expiry:
            y = synthetic.render_frame_with_expiry(pan, "08/28", seed=i)
        else:
            y = synthetic.render_frame(pan, y0=150 + (i % 3) * 8, seed=i)
        out.append((pan, np.asarray(y, dtype=np.uint8)))
    return out


def test_vseg_parity_on_synthetic_frames():
    from cardio_dmz_tpu_torch.scan.vseg import best_n_vseg

    frames = _frames(6)
    v = best_n_vseg(_params()["vseg_mlp"],
                    _t(np.stack([y for _, y in frames])))
    for i, (_, y) in enumerate(frames):
        ref_y, ref_score, ref_pat, _ = _oracle().vseg(y)
        assert int(v.y_offset[i]) == ref_y
        assert int(v.pattern_type[i]) == ref_pat
        assert float(v.score[i]) == pytest.approx(ref_score, abs=2e-3)


def test_hseg_staged_exact_parity():
    """The staged hseg search matches the compiled C++ candidate for
    candidate: identical (width, pattern_offset, offsets) on every frame
    (n_hseg.cpp:110-147, including the f32 width accumulation)."""
    from cardio_dmz_tpu_torch.scan.hseg import best_n_hseg

    rng = np.random.default_rng(11)
    checked = 0
    for i in range(10):
        length = 16 if i % 3 else 15
        pan = synthetic.safe_pan(rng, length=length,
                                 prefix=(4,) if length == 16 else (3, 4))
        y = synthetic.render_frame(pan, y0=int(rng.integers(150, 230)),
                                   width=float(rng.uniform(17.3, 19.2)),
                                   offset=int(rng.integers(25, 45)),
                                   noise=int(rng.integers(0, 4)), seed=i)
        vy, _, vp, vn = _oracle().vseg(y)
        if vp == 0:
            continue
        hn, hoffs, hw, hpo, _ = _oracle().hseg(y, vy)
        ours = best_n_hseg(_t(y[None, vy:vy + 27]), torch.tensor([vp]),
                           torch.tensor([vn]))
        assert int(ours.pattern_offset[0]) == hpo
        assert float(ours.number_width[0]) == pytest.approx(hw, abs=1e-6)
        assert list(to_np(ours.offsets[0]))[:hn] == hoffs
        checked += 1
    assert checked >= 6


def test_frame_digit_parity_on_synthetic_frames():
    """Digit-level agreement with the compiled reference through the
    port's scan_card_image (the digit-prep wrapper's plain version): every
    usable frame agrees on the segmentation and >= 99.5% of digits, all
    eight frames as one batch of streams."""
    from cardio_dmz_tpu_torch.scan import scan_card_image

    frames = _frames(8)
    ours = frame_records(scan_card_image(
        _params(), _t(np.stack([y for _, y in frames]))))
    total = agree = usable_frames = 0
    for (_, y), got in zip(frames, ours):
        ref = ref_frame_record(_oracle().scan_card_image(y,
                                                         scan_expiry=False))
        assert ref.usable == got.usable
        if not ref.usable:
            continue
        usable_frames += 1
        assert got.hseg_n_offsets == ref.hseg_n_offsets
        assert got.hseg_offsets == ref.hseg_offsets
        total += len(ref.digits)
        agree += sum(a == b for a, b in zip(got.digits, ref.digits))
    assert usable_frames >= 3, "too few usable frames"
    if total:
        assert agree / total >= 0.995, f"digit agreement {agree}/{total}"


def test_digit_parity_given_reference_hseg():
    """Categorize-stage parity: the reference's hseg offsets forced into
    the port's digit path (cells, the digit-prep wrapper, the 3-conv
    ensemble) reproduce the reference digits exactly and its scores
    within 2e-4 (isolates categorize from hseg)."""
    from cardio_dmz_tpu_torch.scan.categorize import number_scores

    params = _params()
    total = agree = 0
    for _, y in _frames(8):
        ref = _oracle().scan_card_image(y, scan_expiry=False)
        if not ref.usable:
            continue
        n = ref.hseg_n_offsets
        strip = y[None, ref.vseg_y_offset:ref.vseg_y_offset + 27, :]
        offsets = np.zeros((1, 16), np.int32)
        offsets[0, :n] = ref.hseg_offsets
        ours = to_np(number_scores(params, _t(strip), _t(offsets),
                                   torch.tensor([n])))[0]
        np.testing.assert_allclose(ours[:n], ref.scores[:n], atol=2e-4)
        our_digits = list(ours.argmax(1)[:n])
        total += n
        agree += sum(int(a == b) for a, b in zip(our_digits, ref.digits))
    assert total >= 30
    assert agree == total, f"digit agreement {agree}/{total}"


def _ref_session(frames, scan_expiry):
    """The compiled scanner over frames, one handle: (first PAN string or
    None, first (month, year) with both set or None), as the sweeps read
    them after each frame."""
    handle = _oracle().scanner_create()
    pan = date = None
    try:
        for y in frames:
            _oracle().scanner_add_frame(handle, y, scan_expiry=scan_expiry)
            r = _oracle().scanner_result(handle)
            if pan is None and r:
                pan = "".join(map(str, r[0]))
            if date is None and r and r[1] and r[2]:
                date = (r[1], r[2])
    finally:
        _oracle().scanner_destroy(handle)
    return pan, date


def test_session_parity_final_pan():
    for pan, _ in _frames(2, seed0=42):
        frames = [np.asarray(synthetic.render_frame(
            pan, y0=152, seed=100 + i, noise=1), np.uint8) for i in range(8)]
        ours = HostScanner(_params(), scan_expiry=False)
        for y in frames:
            ours.add_frame(y)
        ref_pan, _ = _ref_session(frames, scan_expiry=False)
        assert ref_pan == pan, "reference never completed"
        assert ours.result().complete
        assert ours.card_number == pan


# ------------------------------------------------------------------ expiry


def _name_frame(seed):
    y = np.asarray(synthetic.render_frame_with_expiry(
        "4111111111111111", "08/28", seed=seed), np.uint8)
    return np.asarray(synthetic.render_text_small(
        y, "1234 56789", 150 + 27 + 35 + 26, 100), np.uint8)


def test_name_supergroup_path_parity():
    """The flag-gated name super-group path (expiry_seg_host with
    collect_name_groups=True) matches the compiled reference's OWN
    gather/regrid/optimize internals invoked with the disabled call's
    parameters (gather_into_groups(super, local, 2*kSmallCharacterWidth),
    expiry_seg.cpp:544-548), stage for stage on frames carrying a
    name-like two-word line (13 px word gap: >=9 splits local groups,
    <18 merges the super)."""
    from cardio_dmz_tpu_torch.scan import expiry_seg_host as H
    from cardio_dmz_tpu_torch.scan.expiry_types import (
        MIN_NAME_STRIP_CHARS, SMALL_CHAR_WIDTH)

    def assert_same(og, rg, what):
        got = group_to_ref(og)
        assert (got.top, got.left, got.width, got.height) == \
            (rg.top, rg.left, rg.width, rg.height), what
        assert got.char_tops == rg.char_tops, what
        assert got.char_lefts == rg.char_lefts, what
        assert got.char_sums == rg.char_sums, what

    multi_local_supers = survivors = 0
    for i in range(4):
        y = _name_frame(i)
        sobel = H.scharr_dx_abs_below(y, 150)
        for base, total in H.select_stripes(sobel, 150):
            local = H.local_groups_for_stripe(sobel, base, total)
            if not local:
                continue
            ours = H.gather_into_groups(local, 2 * SMALL_CHAR_WIDTH)
            refs = _oracle().gather_groups([group_to_ref(g) for g in local],
                                           2 * SMALL_CHAR_WIDTH)
            assert len(ours) == len(refs)
            for og, rg in zip(ours, refs):
                assert_same(og, rg, "gather")
                if len(og.character_rects) > max(
                        len(g.character_rects) for g in local):
                    multi_local_supers += 1
                if len(og.character_rects) < MIN_NAME_STRIP_CHARS - 1:
                    continue
                H.regrid_group(sobel, og)
                rg = _oracle().regrid_group(sobel, rg)
                assert_same(og, rg, "regrid")
                H.optimize_character_rects(sobel, og)
                rg = _oracle().optimize_character_rects(sobel, rg)
                assert_same(og, rg, "optimize")
                if len(og.character_rects) >= MIN_NAME_STRIP_CHARS:
                    survivors += 1
    assert multi_local_supers >= 1
    assert survivors >= 2

    # end to end: the flag returns name groups, and the flag off (the
    # serving default, the reference's disabled path) returns none
    y = _name_frame(0)
    slash = _params()["slash_mlp"]
    _, names_on = H.best_expiry_seg(y, 150, slash, collect_name_groups=True)
    _, names_off = H.best_expiry_seg(y, 150, slash)
    assert names_off == []
    assert len(names_on) >= 1


def test_expiry_seg_parity_host_vs_reference():
    """The port's host expiry segmentation == compiled reference, group for
    group (tops, lefts, character rects), on synthetic expiry frames."""
    from cardio_dmz_tpu_torch.scan import expiry_seg_host as H

    frames_with_groups = 0
    for i in range(6):
        y = np.asarray(synthetic.render_frame_with_expiry(
            "4111111111111111", "08/28", seed=i), dtype=np.uint8)
        ref_groups, ref_names = _oracle().expiry_seg(y, 150)
        our_groups, our_names = H.best_expiry_seg(
            y, 150, _params()["slash_mlp"])
        assert ref_names == [] and our_names == []
        assert len(ref_groups) == len(our_groups), f"frame {i}"
        frames_with_groups += bool(ref_groups)
        for rg, og in zip(ref_groups, map(group_to_ref, our_groups)):
            assert (rg.top, rg.left) == (og.top, og.left)
            assert rg.char_tops == og.char_tops
            assert rg.char_lefts == og.char_lefts
    assert frames_with_groups >= 2


def _port_dates(frames, now, device_step=True):
    """(HostScanner's first date, the device step's first date) over
    frames, the CYTHON_DMZ date branch (past dates accepted)."""
    params = _params()
    ours = HostScanner(params, scan_expiry=True, now=now,
                       allow_past_dates=True)
    cfg = ScanConfig(scan_expiry=True, expiry_allow_past_dates=True)
    dev = scanner_reset(now, 1, "cpu")
    our_date = dev_date = None
    for y in frames:
        ours.add_frame(y)
        res = ours.result()
        if our_date is None and res.complete and res.expiry_month:
            our_date = (res.expiry_month, res.expiry_year)
        if device_step:
            dev, (_, dres) = scanner_step(params, dev, _t(y[None]),
                                          config=cfg)
            if dev_date is None and bool(dres.complete[0]) and \
                    int(dres.expiry_month[0]):
                dev_date = (int(dres.expiry_month[0]),
                            int(dres.expiry_year[0]))
    return our_date, dev_date


def test_expiry_session_randomized_device_parity():
    """Randomized expiry sessions (dates incl. past/out-of-window, layout,
    spacing, noise): the port's DEVICE expiry path (scanner_step with
    scan_expiry) and its host oracle both agree with the compiled
    reference session date for date. The A/B runs the CYTHON_DMZ
    date-sanity configuration (expiry_allow_past_dates=True) because the
    compiled oracle IS that configuration (expiry_categorize.cpp:382-397).
    The full-scale sweep lives in tools/parity_ab.py."""
    rng = np.random.default_rng(77)
    now = (2026, 8)
    read_sessions = 0
    for s in range(8):
        if s == 3:
            text = "01/22"   # past date: the CYTHON_DMZ branch accepts it
        elif s == 7:
            text = "%02d/%02d" % (rng.integers(1, 13), rng.integers(33, 39))
        else:
            text = "%02d/%02d" % (rng.integers(1, 13), rng.integers(27, 31))
        y0 = int(rng.integers(145, 200))
        ex = int(rng.integers(95, 160))
        ey = min(y0 + 27 + int(rng.integers(30, 44)), 240)
        spacing = int(rng.integers(12, 15))
        style = "flat" if s % 4 == 1 else "emboss"
        pan = synthetic.safe_pan(rng)
        frames = [np.asarray(synthetic.render_frame_with_expiry(
            pan, text, y0=y0, expiry_y=ey, expiry_x=ex,
            expiry_spacing=spacing, style=style, seed=5100 * s + i),
            np.uint8) for i in range(12)]
        _, ref_date = _ref_session(frames, scan_expiry=True)
        our_date, dev_date = _port_dates(frames, now)
        assert our_date == ref_date, (s, text, our_date, ref_date)
        assert dev_date == ref_date, (s, text, dev_date, ref_date)
        read_sessions += int(ref_date is not None)
    assert read_sessions >= 2   # the sweep must exercise real reads


# sessions of tools/parity_ab.py's default expiry sweep (default_rng(2026))
CAP_REASON = (
    "the device segmentation keeps the first 16 rects of a group "
    "(expiry_device.MAX_CHARS, the JAX package's cap); the C++ regrids the "
    "whole run: ROADMAP.md section 3")
TIE_REASON = (
    "the C++ orders equal candidate sums as libstdc++'s std::sort (unstable) "
    "leaves them; the port, as the JAX package, by left: ROADMAP.md "
    "section 3")


@functools.lru_cache(maxsize=None)
def _sweep_session(session):
    from cardio_dmz_tpu_torch.tools import parity_ab as ab
    return ab.render_expiry_session(ab.sweep_expiry_case(session))


def _ref_groups(y, vseg_y):
    groups, _ = _oracle().expiry_seg(y, vseg_y)
    return [(g.top, g.left, g.char_tops, g.char_lefts) for g in groups]


@pytest.mark.parametrize("session", [
    48, 49, 50, pytest.param(51, marks=pytest.mark.xfail(
        strict=True, reason=CAP_REASON))])
def test_device_expiry_seg_parity_on_sweep_session(session):
    """The device expiry segmentation (scan_card_image with scan_expiry,
    the session's 16 frames as one batch of streams) against the C++'s
    best_expiry_seg, window for window (top, left, char rects) on every
    frame the gate lets through, and the session's date through the device
    step against the C++ scanner's. Session 50's frame 9 holds a slash at
    0.69296 in the C++: the JAX package's device path, which rounds the
    slash MLP's first-layer factors to bfloat16, reads 0.70704 there and
    a date three frames early; the port computes in float32."""
    from cardio_dmz_tpu_torch.scan import scan_card_image
    from cardio_dmz_tpu_torch.tools import parity_ab as ab

    frames = _sweep_session(session)
    fr = scan_card_image(_params(), _t(frames), scan_expiry=True)
    w = fr.expiry_groups
    gated = to_np((fr.vseg.score > 15) & ~fr.upside_down)
    for t, y in enumerate(frames):
        ours = [(int(w.top[t, k]), int(w.left[t, k]),
                 to_np(w.char_tops[t, k]).tolist(),
                 to_np(w.char_lefts[t, k]).tolist())
                for k in range(w.valid.shape[1]) if bool(w.valid[t, k])]
        want = _ref_groups(y, int(fr.vseg.y_offset[t])) if gated[t] else []
        assert ours == want, (session, t)
    (_, dev_date), = ab.device_sessions(_params(), frames[None], True, "cpu")
    _, ref_date = _ref_session(frames, scan_expiry=True)
    assert dev_date == ref_date


@pytest.mark.parametrize("session,frame", [
    (50, 9), (51, 12), (25, 1), (41, 6),
    pytest.param(97, 1, marks=pytest.mark.xfail(strict=True,
                                                  reason=TIE_REASON)),
    pytest.param(41, 7, marks=pytest.mark.xfail(strict=True,
                                                 reason=TIE_REASON))])
def test_host_expiry_seg_parity_on_sweep_frames(session, frame):
    """The host expiry segmentation against the C++'s best_expiry_seg,
    group for group, on frames of the sweep where the device path and the
    C++ part: a slash near 0.7 (50, 9), groups longer than the device's
    cap (51, 12; 25, 1; 41, 6), and equal rect sums the two sorts order
    otherwise (97, 1; 41, 7)."""
    from cardio_dmz_tpu_torch.scan import expiry_seg_host as H
    from cardio_dmz_tpu_torch.scan.vseg import best_n_vseg

    y = _sweep_session(session)[frame]
    vseg_y = int(best_n_vseg(_params()["vseg_mlp"], _t(y[None])).y_offset[0])
    groups, _ = H.best_expiry_seg(y, vseg_y, _params()["slash_mlp"])
    ours = [(g.top, g.left, [r.top for r in g.character_rects],
             [r.left for r in g.character_rects]) for g in groups]
    assert ours == _ref_groups(y, vseg_y)


def test_expiry_session_date_parity():
    """Full-session expiry reads AGREE with the compiled reference, and on
    pinned known-good renders both read the true date (the HostScanner,
    the shipping date window)."""
    for text in ("08/28", "12/28", "03/27"):
        want = (int(text[:2]), 2000 + int(text[3:]))
        frames = [np.asarray(synthetic.render_frame_with_expiry(
            "4111111111111111", text, seed=i), np.uint8) for i in range(12)]
        ours = HostScanner(_params(), scan_expiry=True, now=(2026, 8))
        our_date = None
        for y in frames:
            ours.add_frame(y)
            res = ours.result()
            if our_date is None and res.complete and res.expiry_month:
                our_date = (res.expiry_month, res.expiry_year)
        _, ref_date = _ref_session(frames, scan_expiry=True)
        assert ref_date == want, f"reference failed {text}: {ref_date}"
        assert our_date == want, f"ours failed {text}: {our_date}"


# ------------------------------------------------------------------ camera


def _assert_camera_parity(y, cb, orientation, close, max_diff=None):
    """detect_edges and transform_card of the port against dmz_detect_edges
    and dmz_transform_card on one preview; returns whether the card was
    found. Corners within 1e-2 px; the port's warp from its own corners
    against the reference's card from its corners, by `close` (the share
    of pixels within 1 or 2 levels) and max_diff; and the port's warp from
    the REFERENCE's corners bit for bit."""
    ok, _, _, ref_corners = _oracle().detect_edges(y, cb, cb, orientation)
    _, corners = papi.detect_edges(_t(y[None]), _t(cb[None]), _t(cb[None]),
                                   orientation)
    found, ours = corner_array(corners)
    assert bool(found[0]) == ok
    if not ok:
        return False
    np.testing.assert_allclose(ours[0], ref_corners, atol=1e-2)
    ref_card = _oracle().transform_card(y, ref_corners, orientation)
    our_card = to_np(papi.transform_card(_t(y[None]), corners,
                                         orientation))[0]
    diff = np.abs(our_card.astype(int) - ref_card.astype(int))
    levels, share = close
    assert (diff <= levels).mean() > share, diff.max()
    if max_diff is not None:
        assert diff.max() <= max_diff
    from_ref = to_np(papi.transform_card(
        _t(y[None]), corner_points(ref_corners[None]), orientation))[0]
    np.testing.assert_array_equal(from_ref, ref_card)
    return True


def test_detect_edges_and_transform_parity():
    """Camera-stage parity vs the compiled reference: dmz_detect_edges
    (corner points, dmz.cpp:371-439) and dmz_transform_card (428x270 warp,
    dmz.cpp:443-497) on synthetic preview frames with the card on the
    landscape guide rect."""
    rng = np.random.RandomState(5)
    found_frames = 0
    for i in range(5):
        card = np.asarray(synthetic.render_frame(
            "4111111111111111", seed=i, noise=i % 3), dtype=np.uint8)
        y = np.full((480, 640), 50, np.int32)
        y += rng.randint(-(i % 3) - 1, (i % 3) + 2, y.shape)
        y[LANDSCAPE_VERTICAL_INSET:LANDSCAPE_VERTICAL_INSET + 270,
          LANDSCAPE_HORIZONTAL_INSET:LANDSCAPE_HORIZONTAL_INSET + 428] = card
        y = np.clip(y, 0, 255).astype(np.uint8)
        cb = np.full((240, 320), 128, np.uint8)
        found_frames += _assert_camera_parity(y, cb, 3, (1, 0.995), 16)
    assert found_frames >= 4


@pytest.mark.parametrize("orientation", tiers.sweep([1, 2, 3, 4], [1, 3]))
def test_detect_and_transform_all_orientations(orientation):
    """Corner detection + warp parity for every FrameOrientation
    (dmz_olm.h:19-22): the insets and the corner reordering
    (dmz.cpp:446-471) differ per orientation. Fast tier covers one
    portrait + one landscape; CARDIO_FULL_SWEEPS=1 runs all four."""
    rng = np.random.RandomState(orientation)
    boxes = papi.detection_boxes((480, 640), orientation)
    left = boxes["left"][0] + boxes["left"][2] // 2
    right = boxes["right"][0] + boxes["right"][2] // 2
    top = boxes["top"][1] + boxes["top"][3] // 2
    bottom = boxes["bottom"][1] + boxes["bottom"][3] // 2
    y = np.full((480, 640), 50, np.int32)
    y += rng.randint(-2, 3, y.shape)
    y[top:bottom, left:right] = 190
    y = np.clip(y, 0, 255).astype(np.uint8)
    cb = np.full((240, 320), 128, np.uint8)
    _assert_camera_parity(y, cb, orientation, (2, 0.99))

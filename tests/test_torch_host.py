"""The host side of the scanner: the port's host expiry oracle
(scan/expiry_seg_host.py, scan/expiry_categorize_host.py) stage by stage
against the JAX package's, HostScanner against the JAX HostScanner frame by
frame, and the host halves of utils/olm.py, utils/geometry.py, ops/filter.py
and api.blur_card.

Tolerances: every rect, sum, pattern and discrete decision equal; slash
probabilities within 2e-4 (the JAX package takes XLA's tanh, the port
libm's) with none within 2e-4 of the 0.7 threshold; model outputs within
1e-5.
"""

import copy
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import synthetic
from cardio_dmz_tpu import api as japi
from cardio_dmz_tpu.models import zoo as jzoo
from cardio_dmz_tpu.models.weights import load_all_params
from cardio_dmz_tpu.ops.filter import median_blur as jax_median_blur
from cardio_dmz_tpu.scan import expiry_categorize_host as jcat
from cardio_dmz_tpu.scan import expiry_seg_host as jseg
from cardio_dmz_tpu.scan import expiry_types as jtypes
from cardio_dmz_tpu.session.host import HostScanner as JaxHostScanner
from cardio_dmz_tpu.utils import geometry as jgeom
from cardio_dmz_tpu.utils import olm as jolm
from cardio_dmz_tpu_torch import api as papi
from cardio_dmz_tpu_torch.constants import (
    ORIENTATION_LANDSCAPE_LEFT, ORIENTATION_LANDSCAPE_RIGHT,
    ORIENTATION_PORTRAIT, ORIENTATION_PORTRAIT_UPSIDE_DOWN)
from cardio_dmz_tpu_torch.ops.filter import median_blur
from cardio_dmz_tpu_torch.scan import expiry_categorize_host as pcat
from cardio_dmz_tpu_torch.scan import expiry_seg_host as pseg
from cardio_dmz_tpu_torch.scan import expiry_types as ptypes
from cardio_dmz_tpu_torch.session import HostScanner, scanner_reset
from cardio_dmz_tpu_torch.session.state import EXPIRY_GRACE_FRAMES
from cardio_dmz_tpu_torch.utils import geometry as pgeom
from cardio_dmz_tpu_torch.utils import olm as polm
from torch_parity import port_params, to_np

ATOL = 1e-5
SLASH_ATOL = 2e-4
PAN = "4111111111111111"
NOW = (2026, 8)


@pytest.fixture(autouse=True)
def _full_precision():
    prev = jzoo.set_precision("highest")
    yield
    jzoo.set_precision(prev)


@functools.lru_cache(maxsize=None)
def _params():
    return load_all_params()


def _frame(seed=0, expiry="08/28"):
    """The frame of tests/test_expiry.py."""
    return synthetic.render_frame_with_expiry(
        PAN, expiry, y0=150, offset=35, expiry_y=212, expiry_x=120, noise=1,
        seed=seed)


@functools.lru_cache(maxsize=None)
def _cases():
    """{name: (frame, vseg row)}: seeds 0-7 of tests/test_expiry.py and the
    text-heavy frame of tests/test_expiry_device.py."""
    cases = {f"seed{s}": (_frame(s), 150) for s in range(8)}
    heavy = synthetic.render_frame(PAN, y0=120, offset=35, width=18.0,
                                   seed=0, noise=1)
    for row, x in ((175, 40), (175, 200), (200, 60), (225, 100), (250, 50)):
        heavy = synthetic.render_text_small(heavy, "01/29 08/31", row, x,
                                            size=20, spacing=12)
    cases["text_heavy"] = (heavy, 120)
    return cases


CASES = tuple(f"seed{s}" for s in range(8)) + ("text_heavy",)


def _rects(group):
    return [(r.top, r.left, r.sum) for r in group.character_rects]


def _group(group):
    """Every field of a GroupedRects that the segmentation sets."""
    return (group.top, group.left, group.width, group.height, group.sum,
            group.character_width, int(group.pattern), _rects(group))


@functools.lru_cache(maxsize=None)
def _stripes(case):
    """(the JAX package's scharr band, its stripes) for a case; the port's
    are asserted equal in test_scharr_and_stripes_match_jax."""
    y, vy = _cases()[case]
    sobel = jseg.scharr_dx_abs_below(y, vy)
    return sobel, jseg.select_stripes(sobel, vy)


def test_types_match_jax():
    for name in ("SMALL_CHAR_WIDTH", "SMALL_CHAR_HEIGHT",
                 "TRIMMED_CHAR_WIDTH", "TRIMMED_CHAR_HEIGHT",
                 "MIN_EXPIRY_STRIP_CHARS", "MIN_NAME_STRIP_CHARS",
                 "EXPIRY_MAX_VALID_LENGTH"):
        assert getattr(ptypes, name) == getattr(jtypes, name)
    assert {p.name: int(p) for p in ptypes.ExpiryPattern} == {
        p.name: int(p) for p in jtypes.ExpiryPattern}
    for cls in ("CharacterRect", "GroupedRects"):
        assert [f.name for f in dataclasses.fields(getattr(ptypes, cls))] \
            == [f.name for f in dataclasses.fields(getattr(jtypes, cls))]


@pytest.mark.parametrize("case", CASES)
def test_scharr_and_stripes_match_jax(case):
    y, vy = _cases()[case]
    ref_sobel, ref_stripes = _stripes(case)
    sobel = pseg.scharr_dx_abs_below(y, vy)
    np.testing.assert_array_equal(sobel, ref_sobel)
    assert sobel.dtype == ref_sobel.dtype
    assert pseg.select_stripes(sobel, vy) == ref_stripes
    assert len(ref_stripes) >= 1


@pytest.mark.parametrize("case", CASES)
def test_local_groups_regrid_and_trim_match_jax(case):
    """local_groups_for_stripe, then regrid_group and
    optimize_character_rects on every group long enough, stage by stage."""
    sobel, stripes = _stripes(case)
    n_trimmed = 0
    for base, total in stripes:
        ref = jseg.local_groups_for_stripe(sobel, base, total)
        got = pseg.local_groups_for_stripe(sobel, base, total)
        assert [_group(g) for g in got] == [_group(g) for g in ref]
        for r, g in zip(ref, got):
            if len(r.character_rects) < jtypes.MIN_EXPIRY_STRIP_CHARS - 1:
                continue
            jseg.regrid_group(sobel, r)
            pseg.regrid_group(sobel, g)
            assert _group(g) == _group(r)
            jseg.optimize_character_rects(sobel, r)
            pseg.optimize_character_rects(sobel, g)
            assert _group(g) == _group(r)
            n_trimmed += 1
    assert n_trimmed >= 1


@pytest.mark.parametrize("collect_name_groups", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_best_expiry_seg_matches_jax(case, collect_name_groups):
    y, vy = _cases()[case]
    ref, ref_names = jseg.best_expiry_seg(
        y, vy, _params()["slash_mlp"],
        collect_name_groups=collect_name_groups)
    got, got_names = pseg.best_expiry_seg(
        y, vy, port_params()["slash_mlp"],
        collect_name_groups=collect_name_groups)
    assert [_group(g) for g in got] == [_group(g) for g in ref]
    assert [_group(g) for g in got_names] == [_group(g) for g in ref_names]
    if not collect_name_groups:
        assert got_names == []
    if case == "seed0":
        assert len(got) >= 1 and len(got[0].character_rects) == 5


def test_name_groups_are_collected_when_asked():
    y, vy = _cases()["text_heavy"]
    _, names = pseg.best_expiry_seg(y, vy, port_params()["slash_mlp"],
                                    collect_name_groups=True)
    assert names and all(len(g.character_rects) >= 5 for g in names)


@pytest.mark.parametrize("case", CASES)
def test_slash_probs_match_jax_host(case):
    """The slash MLP on every trimmed character of a case's groups: within
    2e-4 of the JAX package's, and none so near 0.7 that the two could
    decide differently."""
    sobel, stripes = _stripes(case)
    rects = []
    for base, total in stripes:
        for g in pseg.local_groups_for_stripe(sobel, base, total):
            if len(g.character_rects) >= 4:
                pseg.regrid_group(sobel, g)
                pseg.optimize_character_rects(sobel, g)
                rects.extend(g.character_rects)
    assert rects
    got = np.asarray(pseg._slash_probs(port_params()["slash_mlp"], sobel,
                                       rects))
    ref = np.asarray([jseg._slash_prob(_params()["slash_mlp"], sobel, r)
                      for r in rects])
    np.testing.assert_allclose(got, ref, atol=SLASH_ATOL)
    assert (np.abs(ref - 0.7) > SLASH_ATOL).all()
    assert pseg._slash_prob(port_params()["slash_mlp"], sobel,
                            rects[0]) == pytest.approx(got[0], abs=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_categorize_expiry_digits_matches_jax(case):
    y, vy = _cases()[case]
    ref_groups, _ = jseg.best_expiry_seg(y, vy, _params()["slash_mlp"])
    got_groups, _ = pseg.best_expiry_seg(y, vy, port_params()["slash_mlp"])
    all_scores = pcat.categorize_groups(y, got_groups,
                                        port_params()["expiry_conv"])
    assert len(all_scores) == len(ref_groups)
    for r, g, batched in zip(ref_groups, got_groups, all_scores):
        ref = jcat.categorize_expiry_digits(y, r, _params()["expiry_conv"])
        got = pcat.categorize_expiry_digits(y, g,
                                            port_params()["expiry_conv"])
        assert got.shape == ref.shape == (11, 10)
        np.testing.assert_allclose(got, ref, atol=ATOL)
        np.testing.assert_allclose(batched, ref, atol=ATOL)
        assert (got[2] == 0).all()
    if case == "seed0":
        digits = all_scores[0][:5].argmax(-1)
        assert list(digits[[0, 1, 3, 4]]) == [0, 8, 2, 8]


def test_prepare_char_for_cat_matches_jax():
    y, _ = _cases()["seed0"]
    for top, left in ((214, 120), (214, 133), (0, 0), (254, 417)):
        np.testing.assert_allclose(
            pcat.prepare_char_for_cat(y, top, left, device="cpu"),
            jcat.prepare_char_for_cat(y, top, left), atol=1e-7)


# --- aggregation and dates: the cases of tests/test_expiry.py ---------------

def _test_group(types, top=10, left=20, fill=1.0):
    g = types.GroupedRects(top=top, left=left, width=60, height=16)
    g.character_rects = [types.CharacterRect(top, left + 12 * i)
                         for i in range(5)]
    g.scores = np.full((11, 10), fill, np.float32)
    return g


def _table(groups):
    return [(g.top, g.left, g.recently_seen_count, g.total_seen_count,
             g.scores.tolist()) for g in groups]


def test_group_aggregation_decay_and_forget_matches_jax():
    ref, got = [], []
    jcat.aggregate_grouped_rects(ref, [_test_group(jtypes)])
    pcat.aggregate_grouped_rects(got, [_test_group(ptypes)])
    assert _table(got) == _table(ref)
    assert len(got) == 1 and got[0].recently_seen_count == 3
    for _ in range(3):
        jcat.aggregate_grouped_rects(ref, [])
        pcat.aggregate_grouped_rects(got, [])
        assert _table(got) == _table(ref)
    assert got == []


def test_group_aggregation_merges_and_coalesces_like_jax():
    """Two near groups in one frame coalesce; a later sighting merges into
    the kept group with the EWMA; a far one opens a second entry."""
    ref, got = [], []
    for frame in (
            [(10, 20, 1.0), (12, 22, 0.5)],     # coalesce
            [(14, 21, 0.25)],                   # merge
            [(100, 200, 0.75)],                 # fresh
            []):
        jcat.aggregate_grouped_rects(
            ref, [_test_group(jtypes, *g) for g in frame])
        pcat.aggregate_grouped_rects(
            got, [_test_group(ptypes, *g) for g in frame])
        assert _table(got) == _table(ref)
    assert len(got) == 2 and got[0].total_seen_count == 2


def test_stable_expiry_digits_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        scores = rng.rand(11, 10).astype(np.float32) ** 6
        scores[2] = 0
        ref, got = _test_group(jtypes), _test_group(ptypes)
        ref.scores = got.scores = scores
        assert pcat.stable_expiry_digits(got) == \
            jcat.stable_expiry_digits(ref)
    sharp = np.zeros((11, 10), np.float32)
    sharp[[0, 1, 3, 4], [0, 8, 2, 8]] = 0.9
    got = _test_group(ptypes)
    got.scores = sharp
    assert pcat.stable_expiry_digits(got) == [0, 8, None, 2, 8]


@pytest.mark.parametrize("allow_past_dates", [False, True])
@pytest.mark.parametrize("digits, best, want", [
    ([0, 1, None, 2, 0], (0, 0), (0, 0)),        # stale
    ([0, 1, None, 3, 5], (0, 0), (0, 0)),        # more than 5 years out
    ([0, 8, None, 2, 7], (0, 0), (8, 2027)),
    ([2, 7, None, 0, 8], (0, 0), (8, 2027)),     # month and year swapped
    ([0, 8, None, 2, 7], (12, 2028), (12, 2028)),  # prefer the later
    ([0, 8, None, None, 7], (0, 0), (0, 0)),     # an unstable digit
    ([0, 8, None, 9, 9], (0, 0), (0, 0)),        # 1999 with past dates
])
def test_expiry_from_digits_matches_jax(digits, best, want,
                                        allow_past_dates):
    args = (digits, 0, best[0], best[1])
    ref = jcat.expiry_from_digits(*args, now=NOW,
                                  allow_past_dates=allow_past_dates)
    got = pcat.expiry_from_digits(*args, now=NOW,
                                  allow_past_dates=allow_past_dates)
    assert got == ref
    if not allow_past_dates:
        assert got == want
    elif digits == [0, 1, None, 2, 0]:
        assert got == (1, 2020)
    elif digits == [0, 8, None, 9, 9]:
        assert got == (8, 1999)


def test_expiry_extract_needs_three_sightings_like_jax():
    ref_table, got_table = [], []
    ref = got = (0, 0)
    history = []
    for s in range(6):
        y = _frame(seed=s)
        groups, _ = jseg.best_expiry_seg(y, 150, _params()["slash_mlp"])
        ref = jcat.expiry_extract(y, ref_table, groups,
                                  _params()["expiry_conv"], now=NOW,
                                  best_month=ref[0], best_year=ref[1])
        groups, _ = pseg.best_expiry_seg(y, 150, port_params()["slash_mlp"])
        got = pcat.expiry_extract(y, got_table, groups,
                                  port_params()["expiry_conv"], now=NOW,
                                  best_month=got[0], best_year=got[1])
        assert got == ref
        assert [(g.top, g.left, g.recently_seen_count, g.total_seen_count)
                for g in got_table] == [
            (g.top, g.left, g.recently_seen_count, g.total_seen_count)
            for g in ref_table]
        for g, r in zip(got_table, ref_table):
            np.testing.assert_allclose(g.scores, r.scores, atol=ATOL)
        history.append(got)
    assert history[0] == (0, 0) and history[-1] == (8, 2028)


# --- HostScanner -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_scanner():
    """One JAX HostScanner for every session here: its jitted PAN step
    compiles once; sessions differ in the attributes set on it."""
    return JaxHostScanner(_params(), scan_expiry=True, now=NOW)


def _sessions():
    """{name: (frames, HostScanner keyword arguments)}."""
    undated = [synthetic.render_frame(PAN, y0=150, width=18.0, offset=35,
                                      seed=s, noise=1) for s in range(8)]
    return {
        "dated": ([_frame(seed=s) for s in range(8)], {}),
        "undated": (undated, {}),
        "past_date": ([_frame(seed=s, expiry="08/21") for s in range(8)],
                      {"allow_past_dates": True}),
        "past_date_refused": ([_frame(seed=s, expiry="08/21")
                               for s in range(8)], {}),
        "pan_only": ([_frame(seed=s) for s in range(6)],
                     {"scan_expiry": False}),
        "name_groups": ([_frame(seed=s) for s in range(4)],
                        {"collect_name_groups": True}),
    }


def _run_both(name):
    frames, kwargs = _sessions()[name]
    ref = _jax_scanner()
    ref.scan_expiry = kwargs.get("scan_expiry", True)
    ref.allow_past_dates = kwargs.get("allow_past_dates", False)
    ref.collect_name_groups = kwargs.get("collect_name_groups", False)
    ref.reset()
    got = HostScanner(port_params(), now=NOW, **kwargs)
    assert got.device == torch.device("cpu")
    for t, y in enumerate(frames):
        rf, rr = ref.add_frame(y)
        gf, gr = got.add_frame(y)
        for field in ("usable", "upside_down"):
            assert bool(getattr(gf, field)) == bool(getattr(rf, field)), (
                t, field)
        for part, fields in (("vseg", ("y_offset", "pattern_type",
                                       "number_length")),
                             ("hseg", ("n_offsets", "offsets",
                                       "pattern_offset", "number_width"))):
            for field in fields:
                np.testing.assert_array_equal(
                    to_np(getattr(getattr(gf, part), field)),
                    np.asarray(getattr(getattr(rf, part), field)),
                    err_msg=f"frame {t} {part}.{field}")
        np.testing.assert_allclose(to_np(gf.scores), np.asarray(rf.scores),
                                   atol=ATOL)
        assert gf.scores.shape == (16, 10)
        assert bool(gr.complete) == bool(rr.complete), t
        assert int(gr.n_numbers) == int(rr.n_numbers)
        np.testing.assert_array_equal(gr.predictions,
                                      np.asarray(rr.predictions))
        assert (gr.expiry_month, gr.expiry_year) == (
            rr.expiry_month, rr.expiry_year), t
        assert (got.expiry_month, got.expiry_year) == (
            ref.expiry_month, ref.expiry_year), t
        assert got.card_number == ref.card_number
        assert [_group(g) for g in got.name_groups] == [
            _group(g) for g in ref.name_groups]
    return ref, got, gr


def test_host_scanner_reads_pan_and_date_like_jax():
    _, got, result = _run_both("dated")
    assert got.card_number == PAN
    assert result.complete
    assert (result.expiry_month, result.expiry_year) == (8, 2028)


def test_host_scanner_undated_card_waits_for_grace_like_jax():
    ref, got, result = _run_both("undated")
    assert got.card_number == PAN and not result.complete
    assert (got.expiry_month, got.expiry_year) == (0, 0)
    import jax.numpy as jnp
    for since, want in ((EXPIRY_GRACE_FRAMES, False),
                        (EXPIRY_GRACE_FRAMES + 1, True)):
        got.state = got.state._replace(frames_since_complete=torch.full(
            (1,), since, dtype=torch.int32))
        ref.state = ref.state._replace(
            frames_since_complete=jnp.asarray(since, jnp.int32))
        assert got.result().complete == ref.result().complete == want
        assert got.result().expiry_month == 0
    got.reset()
    assert got.card_number is None and not got.result().complete
    assert got.result().n_numbers == 0


def test_host_scanner_allow_past_dates_like_jax():
    _, got, result = _run_both("past_date")
    assert result.complete
    assert (result.expiry_month, result.expiry_year) == (8, 2021)
    _, got, result = _run_both("past_date_refused")
    assert not result.complete and got.expiry_month == 0


def test_host_scanner_pan_only_like_jax():
    _, got, result = _run_both("pan_only")
    assert result.complete and got.card_number == PAN
    assert (result.expiry_month, result.expiry_year) == (0, 0)
    assert got.expiry_groups == []


def test_host_scanner_collects_name_groups_like_jax():
    _, got, _ = _run_both("name_groups")
    assert isinstance(got.name_groups, list)


# --- olm: the cases of tests/test_olm.py -----------------------------------

def _digits(s):
    return [int(c) for c in s]


VALID_PANS = ["4111111111111111", "5500005555555559", "343434343434343",
              "6011000995500000", "3528000700000000", "2221000000000009"]


@pytest.mark.parametrize("pan", VALID_PANS + [
    "4111111111111112", "1234567890123456", "9999999999999999"])
def test_passes_luhn_checksum_matches_jax(pan):
    d = _digits(pan)
    got = polm.passes_luhn_checksum(d)
    assert got == jolm.passes_luhn_checksum(d)
    assert got == (pan in VALID_PANS)
    padded = torch.tensor([d + [0] * (16 - len(d))])
    assert bool(polm.luhn_checksum(padded, torch.tensor([len(d)]))) == got


@pytest.mark.parametrize("allow_incomplete", [False, True])
@pytest.mark.parametrize("pan", [
    "4111111111111111", "5500005555555559", "2221000000000009",
    "343434343434343", "370000002000000", "6011000995500000",
    "3528000700000000", "6200000000000005", "5000000000000009",
    "6444444444444444", "8800000000000000", "1111111111111111",
    "9999999999999999", "411111111111111", "4", "35", "3", "601", ""])
def test_card_info_matches_jax(pan, allow_incomplete):
    ref = jolm.card_info_for_prefix_and_length(_digits(pan),
                                               allow_incomplete)
    got = polm.card_info_for_prefix_and_length(_digits(pan),
                                               allow_incomplete)
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    assert int(got.card_type) == int(ref.card_type)
    if len(pan) in (15, 16) and not allow_incomplete:
        valid = got.card_type not in (polm.CardType.UNRECOGNIZED,
                                      polm.CardType.AMBIGUOUS)
        d = _digits(pan)
        padded = torch.tensor([d + [0] * (16 - len(d))])
        assert bool(polm.card_type_valid(
            padded, torch.tensor([len(d)]))) == valid


@pytest.mark.parametrize("orientation", [
    ORIENTATION_PORTRAIT, ORIENTATION_PORTRAIT_UPSIDE_DOWN,
    ORIENTATION_LANDSCAPE_RIGHT, ORIENTATION_LANDSCAPE_LEFT, 0])
def test_guide_frame_and_opposite_match_jax(orientation):
    for w, h in ((640, 480), (480, 640), (1280, 720)):
        got = polm.guide_frame(orientation, w, h)
        ref = jolm.guide_frame(orientation, w, h)
        assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    assert polm.opposite_orientation(orientation) == \
        jolm.opposite_orientation(orientation)
    if orientation == ORIENTATION_LANDSCAPE_RIGHT:
        g = polm.guide_frame(orientation, 640, 480)
        assert g.x == pytest.approx(140.0, rel=1e-5)
        assert g.y == pytest.approx(106 / 640 * 480, rel=1e-5)


def test_rect_points_and_scale_point_match_jax():
    got = polm.rect_points(polm.Rect(3.0, 4.0, 10.0, 20.0))
    ref = jolm.rect_points(jolm.Rect(3.0, 4.0, 10.0, 20.0))
    assert [dataclasses.astuple(p) for p in got] == [
        dataclasses.astuple(p) for p in ref]
    assert dataclasses.astuple(got[3]) == (13.0, 24.0)
    p = polm.scale_point(polm.Point(5.0, 6.0), polm.Rect(1, 2, 10, 20),
                         polm.Rect(0, 0, 428, 270))
    r = jolm.scale_point(jolm.Point(5.0, 6.0), jolm.Rect(1, 2, 10, 20),
                         jolm.Rect(0, 0, 428, 270))
    assert dataclasses.astuple(p) == dataclasses.astuple(r)


# --- scalar geometry -------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_scalar_geometry_matches_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(25):
        rho1, rho2 = rng.uniform(-300, 300, 2)
        th1 = rng.uniform(math.pi / 2 - 0.1, math.pi / 2 + 0.1)
        th2 = rng.uniform(-0.1, 0.1)
        got = pgeom.parametric_intersect(pgeom.ParametricLine(rho2, th2),
                                         pgeom.ParametricLine(rho1, th1))
        ref = jgeom.parametric_intersect(jgeom.ParametricLine(rho2, th2),
                                         jgeom.ParametricLine(rho1, th1))
        assert got == ref
        # the reference rejects on the signed determinant
        assert pgeom.parametric_intersect(
            pgeom.ParametricLine(rho1, th1),
            pgeom.ParametricLine(rho2, th2)) == jgeom.parametric_intersect(
            jgeom.ParametricLine(rho1, th1), jgeom.ParametricLine(rho2, th2))
        x, y = rng.randint(0, 600, 2)
        got = pgeom.line_by_shifting_origin(
            pgeom.ParametricLine(rho1, th1), int(x), int(y))
        ref = jgeom.line_by_shifting_origin(
            jgeom.ParametricLine(rho1, th1), int(x), int(y))
        assert dataclasses.astuple(got) == dataclasses.astuple(ref)


def test_scalar_geometry_golden_cases():
    ok, x, y = pgeom.parametric_intersect(
        pgeom.ParametricLine(20.0, 0.0),
        pgeom.ParametricLine(10.0, math.pi / 2))
    assert ok and x == pytest.approx(20.0, abs=1e-4)
    assert y == pytest.approx(10.0, abs=1e-4)
    shifted = pgeom.line_by_shifting_origin(
        pgeom.ParametricLine(5.0, 0.0), 100, 50)
    assert shifted.rho == pytest.approx(105.0, abs=1e-3)
    assert pgeom.line_by_shifting_origin(
        pgeom.ParametricLine(7.0, math.pi / 2), 0, 30).rho == pytest.approx(
        37.0, abs=1e-3)
    none = pgeom.parametric_line_none()
    assert pgeom.is_parametric_line_none(none)
    assert dataclasses.astuple(none) == dataclasses.astuple(
        jgeom.parametric_line_none())
    assert pgeom.parametric_intersect(
        none, pgeom.ParametricLine(1.0, 0.0)) == (False, 0.0, 0.0)
    assert pgeom.inset_rect(1, 2, 30, 40, 3, 4) == jgeom.inset_rect(
        1, 2, 30, 40, 3, 4) == (4, 6, 24, 32)


# --- median_blur and blur_card ---------------------------------------------

@pytest.mark.parametrize("shape, ksize", [((40, 60), 25), ((30, 30, 3), 5),
                                          ((12, 9), 25)])
def test_median_blur_matches_jax(shape, ksize):
    img = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    got = median_blur(img, ksize)
    ref = jax_median_blur(img, ksize)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, ref)


def _blur_states(n_streams=1):
    """The state of tests/test_api.py::test_blur_card, for both packages."""
    import jax.numpy as jnp
    from cardio_dmz_tpu.session import scanner_reset as jax_reset
    offsets = [30 + 19 * i for i in range(16)]
    ref = jax_reset()._replace(
        last_n_offsets=jnp.asarray(16, jnp.int32),
        last_offsets=jnp.asarray(offsets, jnp.int32),
        last_number_width=jnp.asarray(18.0, jnp.float32),
        last_vseg_y=jnp.asarray(150, jnp.int32))
    got = scanner_reset(NOW, n_streams, "cpu")
    got.last_n_offsets[-1] = 16
    got.last_offsets[-1] = torch.tensor(offsets, dtype=torch.int32)
    got.last_number_width[-1] = 18.0
    got.last_vseg_y[-1] = 150
    return ref, got


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("unblur_digits", [4, 0, -1])
def test_blur_card_matches_jax(unblur_digits, channels):
    shape = (270, 428) if channels is None else (270, 428, channels)
    card = np.random.RandomState(2).randint(0, 256, shape).astype(np.uint8)
    ref_state, state = _blur_states()
    ref = japi.blur_card(card, ref_state, unblur_digits=unblur_digits)
    got = papi.blur_card(card, state, unblur_digits=unblur_digits)
    np.testing.assert_array_equal(got, ref)
    if unblur_digits == 4:
        x_keep = 30 + 19 * 12
        np.testing.assert_array_equal(got[:, x_keep + 24:],
                                      card[:, x_keep + 24:])
        assert (got[150:177, 30:49] != card[150:177, 30:49]).any()


def test_blur_card_takes_one_stream_of_a_batch():
    card = np.random.RandomState(3).randint(0, 256, (270, 428)).astype(
        np.uint8)
    ref_state, state = _blur_states(n_streams=3)   # stream 2 holds the seg
    with pytest.raises(ValueError, match="which stream"):
        papi.blur_card(card, state)
    np.testing.assert_array_equal(papi.blur_card(card, state, stream=2),
                                  japi.blur_card(card, ref_state))
    np.testing.assert_array_equal(papi.blur_card(card, state, stream=0),
                                  card)             # nothing segmented yet


def test_copies_are_independent_of_the_jax_package():
    """The port's host modules hold their own copies: none is the JAX
    package's object."""
    assert ptypes.GroupedRects is not jtypes.GroupedRects
    assert pseg.best_expiry_seg is not jseg.best_expiry_seg
    assert copy.deepcopy(_test_group(ptypes)).top == 10

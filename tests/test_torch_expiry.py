"""The expiry read as a whole: the port's segmentation, categorization,
aggregation and date extraction, and the full (PAN + expiry) scanner and
camera steps, against the JAX package's on rendered frames (the frames of
tests/test_expiry_device.py and the sessions of tests/torch_fixture.py)."""

import functools

import jax
import numpy as np
import pytest
import torch

import synthetic
import torch_fixture as fx
from cardio_dmz_tpu.config import ScanConfig as JaxScanConfig
from cardio_dmz_tpu.models import zoo as jzoo
from cardio_dmz_tpu.models.weights import load_all_params
from cardio_dmz_tpu.scan import expiry_device as jx
from cardio_dmz_tpu.scan.frame import scan_card_image as jax_scan_card_image
from cardio_dmz_tpu.session import scanner_result as jax_result
from cardio_dmz_tpu.session.state import EXPIRY_GRACE_FRAMES
from cardio_dmz_tpu_torch.config import DEFAULT_CONFIG, ScanConfig
from cardio_dmz_tpu_torch.parallel import (
    batched_camera_step, batched_scanner_step, init_stream_states)
from cardio_dmz_tpu_torch.scan import expiry_device as tx
from cardio_dmz_tpu_torch.scan.frame import scan_card_image
from cardio_dmz_tpu_torch.session import (
    scan_frames, scanner_reset, scanner_result, state as port_state)
from torch_parity import assert_same, port_params, to_np

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _full_precision():
    prev = jzoo.set_precision("highest")
    yield
    jzoo.set_precision(prev)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x)).to(dtype)


def _tree_t(tree):
    return type(tree)(*(_t(np.asarray(v)) for v in tree))


def _pan(digits, n=16):
    return "".join(map(str, to_np(digits)[:n]))


# --- segmentation and categorization on single frames ----------------------

@functools.lru_cache(maxsize=None)
def _seg_cases():
    """The frames of tests/test_expiry_device.py and one with a dated line
    on each stripe: (names, frames (N, 270,
    428), vseg_y (N,), enabled (N,))."""
    def dated(seed):
        return synthetic.render_frame_with_expiry(
            "4111111111111111", "08/28", y0=150, offset=35, expiry_y=212,
            expiry_x=120, noise=1, seed=seed)

    cases = [(f"seed{s}", dated(s), 150, True) for s in range(3)]
    cases.append(("gate_off", dated(0), 150, False))
    heavy = synthetic.render_frame("4111111111111111", y0=120, offset=35,
                                   width=18.0, seed=0, noise=1)
    for row, x in ((175, 40), (175, 200), (200, 60), (225, 100), (250, 50)):
        heavy = synthetic.render_text_small(heavy, "01/29 08/31", row, x,
                                            size=20, spacing=12)
    cases.append(("text_heavy", heavy, 120, True))
    rng = np.random.RandomState(0)
    for trial in range(4):
        vy = 120 + (trial % 4) * 10
        y = synthetic.render_frame("4111111111111111", y0=vy, offset=30,
                                   width=18.0, seed=trial, noise=2)
        for _ in range(rng.randint(0, 3)):
            row = rng.randint(170, 248)
            x = rng.randint(30, 200)
            txt = "".join(rng.choice(list("0123456789/"))
                          for _ in range(rng.randint(4, 9)))
            y = synthetic.render_text_small(y, txt, row, x, size=20,
                                            spacing=12)
        cases.append((f"fuzzed{trial}", y, vy, True))
    lines = synthetic.render_frame("4111111111111111", y0=125, offset=35,
                                   width=18.0, seed=0, noise=1)
    for row in (175, 205, 235):       # a window on each of the 3 stripes
        lines = synthetic.render_text_small(lines, "08/28 11/29", row, 40,
                                            size=15, spacing=13)
    cases.append(("dated_lines", lines, 125, True))
    # uniform noise with the gate forced on, as the reference's bench steps
    # it: every rect position is a candidate, so the 8 non-overlap rounds
    # and the group and window caps truncate
    noise = np.random.RandomState(5).randint(0, 256, (2, 270, 428)).astype(
        np.uint8)
    cases.append(("noise_y150", noise[0], 150, True))
    cases.append(("noise_y125", noise[1], 125, True))
    names, frames, vseg_y, enabled = zip(*cases)
    return (names, np.stack(frames), np.asarray(vseg_y, np.int32),
            np.asarray(enabled))


SEG_CASES = ("seed0", "seed1", "seed2", "gate_off", "text_heavy", "fuzzed0",
             "fuzzed1", "fuzzed2", "fuzzed3", "dated_lines", "noise_y150",
             "noise_y125")


@functools.lru_cache(maxsize=None)
def _jax_seg_and_scores():
    """The JAX package's windows and window scores for _seg_cases(), one
    jitted call over all frames."""
    params = load_all_params()
    _, frames, vseg_y, enabled = _seg_cases()

    def one(y, vy, en):
        w = jx.best_expiry_seg_device(params["slash_mlp"], y, vy, en)
        return w, jx.categorize_windows(params["expiry_conv"], y, w)
    return fx._np(jax.jit(jax.vmap(one))(frames, vseg_y, enabled))


@functools.lru_cache(maxsize=None)
def _port_seg_and_scores():
    _, frames, vseg_y, enabled = _seg_cases()
    frames = _t(frames)
    w = tx.best_expiry_seg_device(port_params()["slash_mlp"], frames,
                                  _t(vseg_y), _t(enabled))
    return w, tx.categorize_windows(port_params()["expiry_conv"], frames, w)


def _case(tree, i):
    return jax.tree.map(lambda a: a[i:i + 1], tree)


@pytest.mark.parametrize("case", range(len(SEG_CASES)), ids=SEG_CASES)
def test_seg_matches_jax(case):
    assert _seg_cases()[0] == SEG_CASES
    ref, _ = _jax_seg_and_scores()
    got, _ = _port_seg_and_scores()
    assert_same(_case(ref, case), _case(got, case))


def test_seg_finds_the_rendered_windows():
    """What the cases are there for: a window on each dated frame, none
    with the gate off, the caps on the text-heavy frame."""
    w, _ = _port_seg_and_scores()
    valid = to_np(w.valid)
    assert valid[:3, 0].all() and not valid[3].any()
    heavy = SEG_CASES.index("text_heavy")
    assert valid[heavy].sum() <= tx.MAX_WINDOWS
    lefts = to_np(w.char_lefts)[heavy][valid[heavy]]
    tops = to_np(w.char_tops)[heavy][valid[heavy]]
    assert (lefts >= 0).all() and (lefts <= 428 - 11).all()
    assert (tops >= 0).all() and (tops <= 270 - 16).all()
    lines = SEG_CASES.index("dated_lines")
    assert to_np(w.top)[lines, :3].tolist() == [175, 205, 235]
    assert valid[lines].tolist() == [True, True, True, False]


@pytest.mark.parametrize("case", range(len(SEG_CASES)), ids=SEG_CASES)
def test_categorize_windows_matches_jax(case):
    _, ref = _jax_seg_and_scores()
    _, got = _port_seg_and_scores()
    assert got.shape == (len(SEG_CASES), tx.MAX_WINDOWS, 5, 10)
    np.testing.assert_allclose(to_np(got)[case], ref[case], atol=ATOL)
    assert not to_np(got)[case, :, 2].any()              # the slash row


def test_categorize_reads_the_rendered_date():
    w, scores = _port_seg_and_scores()
    digits = to_np(scores)[0, 0].argmax(-1)
    assert digits[[0, 1, 3, 4]].tolist() == [0, 8, 2, 8]


# --- aggregation and date extraction ---------------------------------------

def _random_tables(seed, n=64):
    """Random slot tables and window sets on a coarse grid of positions, so
    that windows match slots and each other often."""
    rng = np.random.RandomState(seed)

    def pos(shape):
        return (rng.randint(0, 4, shape) * 7 + 150).astype(np.int32)

    def scores(k):
        s = rng.rand(n, k, 5, 10).astype(np.float32) ** 4
        s[:, :, 2] = 0
        return s

    state = jx.ExpiryState(
        active=rng.rand(n, tx.MAX_SLOTS) < 0.6, top=pos((n, tx.MAX_SLOTS)),
        left=pos((n, tx.MAX_SLOTS)), scores=scores(tx.MAX_SLOTS),
        recently_seen=rng.randint(0, 4, (n, tx.MAX_SLOTS)).astype(np.int32),
        total_seen=rng.randint(0, 6, (n, tx.MAX_SLOTS)).astype(np.int32))
    windows = jx.ExpiryWindows(
        valid=rng.rand(n, tx.MAX_WINDOWS) < 0.6, top=pos((n, tx.MAX_WINDOWS)),
        left=pos((n, tx.MAX_WINDOWS)),
        char_tops=np.zeros((n, tx.MAX_WINDOWS, 5), np.int32),
        char_lefts=np.zeros((n, tx.MAX_WINDOWS, 5), np.int32))
    return state, windows, scores(tx.MAX_WINDOWS)


@pytest.mark.parametrize("seed", range(3))
def test_aggregate_windows_matches_jax(seed):
    state, windows, scores = _random_tables(seed)
    ref = jax.jit(jax.vmap(jx.aggregate_windows))(state, windows, scores)
    got = tx.aggregate_windows(_tree_t(state), _tree_t(windows), _t(scores))
    assert_same(fx._np(ref), got, atol=1e-6)


def test_aggregate_slot_assignment_is_exclusive():
    """Two new windows matching the same slot in one frame: only the first
    merges into it; the second opens a fresh slot (the case of
    tests/test_expiry_device.py)."""
    st = tx.expiry_state_init(1, "cpu")
    st = st._replace(active=_t([[True, False, False, False]]),
                     top=_t([[100, 0, 0, 0]], torch.int32),
                     left=_t([[50, 0, 0, 0]], torch.int32),
                     recently_seen=_t([[3, 0, 0, 0]], torch.int32),
                     total_seen=_t([[3, 0, 0, 0]], torch.int32))
    st.scores[0, 0, 0, 3] = 1.0
    # 92 and 108: both within 8 of the slot, 16 apart from each other
    w = tx.no_windows(1, "cpu")._replace(
        valid=_t([[True, True, False, False]]),
        top=_t([[92, 108, 0, 0]], torch.int32),
        left=_t([[50, 50, 0, 0]], torch.int32))
    scores = torch.zeros(1, tx.MAX_WINDOWS, 5, 10)
    scores[0, 0, 0, 1] = scores[0, 1, 0, 2] = 1.0
    st2 = tx.aggregate_windows(st, w, scores)
    assert int(st2.top[0, 0]) == 92 and int(st2.left[0, 0]) == 50
    assert float(st2.scores[0, 0, 0, 2]) == 0.0
    assert float(st2.scores[0, 0, 0, 1]) > 0.0
    assert (to_np(st2.active)[0] & (to_np(st2.top)[0] == 108)).any()
    ref = jax.jit(jax.vmap(jx.aggregate_windows))(
        *fx._np((jx.ExpiryState(*map(to_np, st)),
                 jx.ExpiryWindows(*map(to_np, w)), to_np(scores))))
    assert_same(fx._np(ref), st2, atol=1e-6)


def _date_tables(seed, n=256):
    """Slot tables whose digits are sharp two-digit months and years around
    `now`, with swapped, stale, far and unstable ones among them."""
    rng = np.random.RandomState(seed)
    month = rng.randint(0, 20, (n, tx.MAX_SLOTS))
    year = rng.choice([0, 5, 11, 12, 24, 25, 26, 27, 30, 31, 32, 61, 99],
                      (n, tx.MAX_SLOTS))
    scores = np.full((n, tx.MAX_SLOTS, 5, 10), 0.02, np.float32)
    sharp = rng.choice([0.9, 0.3], (n, tx.MAX_SLOTS, 5), p=[0.85, 0.15])
    for row, value in ((0, month // 10), (1, month % 10), (3, year // 10),
                       (4, year % 10)):
        np.put_along_axis(scores[:, :, row], value[..., None],
                          sharp[:, :, row, None].astype(np.float32), -1)
    state = jx.ExpiryState(
        active=rng.rand(n, tx.MAX_SLOTS) < 0.8,
        top=np.zeros((n, tx.MAX_SLOTS), np.int32),
        left=np.zeros((n, tx.MAX_SLOTS), np.int32), scores=scores,
        recently_seen=np.ones((n, tx.MAX_SLOTS), np.int32),
        total_seen=rng.randint(1, 6, (n, tx.MAX_SLOTS)).astype(np.int32))
    best = rng.rand(n) < 0.3             # some sessions hold a date already
    best_month = np.where(best, rng.randint(1, 13, n), 0).astype(np.int32)
    best_year = np.where(best, rng.randint(2026, 2031, n), 0).astype(np.int32)
    return state, best_month, best_year


@pytest.mark.parametrize("allow_past_dates", [False, True])
def test_extract_expiry_matches_jax(allow_past_dates):
    state, best_month, best_year = _date_tables(1)
    now_year = np.full_like(best_year, 2026)
    now_month = np.full_like(best_month, 8)
    ref = jax.jit(jax.vmap(functools.partial(
        jx.extract_expiry, allow_past_dates=allow_past_dates)))(
        state, best_month, best_year, now_year, now_month)
    got = tx.extract_expiry(_tree_t(state), _t(best_month), _t(best_year),
                            _t(now_year), _t(now_month),
                            allow_past_dates=allow_past_dates)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(to_np(g), np.asarray(r))
    months, years = to_np(got[0]), to_np(got[1])
    assert (months > 0).any() and (months == 0).any()
    assert (years[months > 0] < 2000).any() == allow_past_dates


def _one_slot_state(mmyy, total_seen=3):
    st = tx.expiry_state_init(1, "cpu")
    st = st._replace(active=_t([[True, False, False, False]]),
                     total_seen=_t([[total_seen, 0, 0, 0]], torch.int32))
    for row, digit in zip((0, 1, 3, 4), mmyy):
        st.scores[0, 0, row, int(digit)] = 0.9
    return st


@pytest.mark.parametrize("mmyy, now, want", [
    ("0828", (2026, 8), (8, 2028)),
    ("2808", (2026, 8), (8, 2028)),      # month > 12: month and year swap
    ("0826", (2026, 8), (8, 2026)),      # the window starts at now ...
    ("0726", (2026, 8), (0, 0)),         # ... a month earlier is refused
    ("1230", (2026, 1), (12, 2030)),     # now + 5 years is outside
    ("0131", (2026, 1), (0, 0)),
    ("0028", (2026, 8), (0, 0)),         # month 0
])
def test_extract_expiry_window(mmyy, now, want):
    zero = torch.zeros(1, dtype=torch.int32)
    month, year = tx.extract_expiry(
        _one_slot_state(mmyy), zero, zero, torch.full_like(zero, now[0]),
        torch.full_like(zero, now[1]))
    assert (int(month), int(year)) == want
    # a slot seen fewer than 3 times is not trusted
    month, _ = tx.extract_expiry(
        _one_slot_state(mmyy, total_seen=2), zero, zero,
        torch.full_like(zero, now[0]), torch.full_like(zero, now[1]))
    assert int(month) == 0


# --- the full scanner step -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _port_run():
    """The port's full step over the expiry fixture's 3 streams x 8 frames:
    one (state, frame result, scanner result, window scores) per step."""
    frames = torch.from_numpy(fx.expiry_frames())
    state = init_stream_states(len(frames), "cpu", fx.NOW)
    out = []
    for t in range(fx.EXPIRY_FRAMES):
        state, (frame, result) = batched_scanner_step(
            port_params(), state, frames[:, t], scan_expiry=True)
        scores = tx.categorize_windows(port_params()["expiry_conv"],
                                       frames[:, t], frame.expiry_groups)
        out.append((state, frame, result, scores))
    return out


@pytest.mark.parametrize("step", range(fx.EXPIRY_FRAMES))
def test_full_step_matches_jax_vmap(step):
    ref_state, ref_frame, ref_result, ref_scores = fx.jax_expiry_session()[
        step]
    state, frame, result, scores = _port_run()[step]
    assert_same(ref_frame, frame, atol=ATOL, rtol=1e-5)
    assert_same(ref_result, result)
    assert_same(ref_state, state, atol=ATOL)
    np.testing.assert_allclose(to_np(scores), ref_scores, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _noise_frames():
    """Three streams of 4 frames the bench's way: uniform noise; noise
    below a rendered card's upper 190 rows, so that the vseg gate passes
    and the expiry seg runs on noise; and the same with a dated line kept.
    (3, 4, 270, 428) uint8."""
    rng = np.random.RandomState(9)
    noise = rng.randint(0, 256, (3, 4, 270, 428)).astype(np.uint8)
    cards = fx.expiry_frames()
    noise[1, :, :190] = cards[0, :4, :190]
    noise[2, :, :232] = cards[1, :4, :232]
    return noise


@functools.lru_cache(maxsize=None)
def _noise_runs():
    """(the JAX package's run, the port's) of the full step over
    _noise_frames(): per step (state, frame, result, window scores). The
    JAX step is torch_fixture's jitted one, at its 3 streams."""
    frames = _noise_frames()
    state = fx._fresh_states(len(frames))
    ref = []
    for t in range(frames.shape[1]):
        state, *rest = fx.jax_expiry_step()(state, frames[:, t])
        ref.append(fx._np((state, *rest)))
    state = init_stream_states(len(frames), "cpu", fx.NOW)
    got = []
    for t in range(frames.shape[1]):
        y = torch.from_numpy(frames[:, t])
        state, (frame, result) = batched_scanner_step(
            port_params(), state, y, scan_expiry=True)
        got.append((state, frame, result, tx.categorize_windows(
            port_params()["expiry_conv"], y, frame.expiry_groups)))
    return ref, got


@pytest.mark.parametrize("step", range(4))
def test_full_step_on_noise_matches_jax_vmap(step):
    """The full step on noise frames, as the reference's bench steps them:
    every discrete output of frame, result and state equal, scores within
    1e-5, for all three streams: the pure-noise stream 0, which the vseg
    gate refuses, included with its vseg and hseg fields."""
    ref, got = _noise_runs()
    ref_state, ref_frame, ref_result, ref_scores = ref[step]
    state, frame, result, scores = got[step]
    usable_vseg = np.asarray(ref_frame.vseg.score) > 15.0
    assert usable_vseg.tolist() == [False, True, True]
    assert_same(ref_frame, frame, atol=ATOL, rtol=1e-5)
    assert_same(ref_result, result)
    assert_same(ref_state, state, atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(to_np(scores), ref_scores, atol=ATOL)


def test_scan_frames_reads_pan_and_date():
    state, (frames, results) = scan_frames(
        port_params(), torch.from_numpy(fx.expiry_frames()), fx.NOW,
        scan_expiry=True)
    assert [_pan(d) for d in state.completed_digits] == [
        "4111111111111111", "4530504390541813", "4111111111111111"]
    assert to_np(state.expiry_month).tolist() == [8, 11, 0]
    assert to_np(state.expiry_year).tolist() == [2028, 2029, 0]
    assert to_np(state.scan_expiry).all()
    # the undated card has its number but waits for the grace period
    assert to_np(state.number_complete).all()
    assert to_np(results.complete[:, -1]).tolist() == [True, True, False]
    assert to_np(results.expiry_month[:, -1]).tolist() == [8, 11, 0]
    assert to_np(results.expiry_year[:, 0]).tolist() == [0, 0, 0]
    assert frames.expiry_groups.valid.shape == (3, fx.EXPIRY_FRAMES, 4)
    assert_same(fx.jax_expiry_session()[-1][0], state, atol=ATOL)


def _jax_states(state):
    """A port ScannerState as the JAX package's, stream-major numpy."""
    from cardio_dmz_tpu.session.analytics import ScanAnalytics
    from cardio_dmz_tpu.session.state import ScannerState
    fields = {k: to_np(v) for k, v in state._asdict().items()
              if k not in ("expiry", "analytics")}
    return ScannerState(
        expiry=jx.ExpiryState(*map(to_np, state.expiry)),
        analytics=jax.tree.map(to_np, ScanAnalytics(*state.analytics)),
        **fields)


def test_grace_rule_completes_without_a_date():
    """A session that scans the expiry and has its number but no date
    completes once more than EXPIRY_GRACE_FRAMES frames have passed."""
    assert port_state.EXPIRY_GRACE_FRAMES == EXPIRY_GRACE_FRAMES == 30
    since = [0, 30, 31, 31, 31]
    state = scanner_reset(fx.NOW, 5, "cpu")._replace(
        number_complete=_t([True, True, True, True, False]),
        scan_expiry=_t([True, True, True, False, True]),
        completed_n=torch.full((5,), 16, dtype=torch.int32),
        frames_since_complete=_t(since, torch.int32))
    new_state, result = scanner_result(state)
    assert to_np(result.complete).tolist() == [False, False, True, True,
                                               False]
    assert not to_np(result.expiry_month).any()
    ref_state, ref_result = jax.vmap(jax_result)(_jax_states(state))
    assert_same(fx._np(ref_result), result)
    assert_same(fx._np(ref_state), new_state)
    # with a date the session completes at once and reports it
    dated = state._replace(expiry_month=torch.full((5,), 8, dtype=torch.int32),
                           expiry_year=torch.full((5,), 2028,
                                                  dtype=torch.int32))
    _, result = scanner_result(dated)
    assert to_np(result.complete).tolist() == [True, True, True, True, False]
    assert to_np(result.expiry_month).tolist() == [8, 8, 8, 0, 0]
    assert_same(fx._np(jax.vmap(jax_result)(_jax_states(dated))[1]), result)


def test_scan_forever_never_completes():
    """SCAN_FOREVER (scan.cpp:13,91-93): frames accumulate, the result
    never completes (tests/test_session.py)."""
    cfg = DEFAULT_CONFIG.replace(scan_forever=True, scan_expiry=False)
    frames = torch.from_numpy(fx.expiry_frames()[:1])
    state = init_stream_states(1, "cpu", fx.NOW)
    for t in range(6):
        state, (_, result) = batched_scanner_step(port_params(), state,
                                                  frames[:, t], config=cfg)
        assert not bool(result.complete[0])
    assert int(state.count16[0]) >= 4
    assert not bool(state.scan_expiry[0])     # the config's flag won
    ref_state, ref_result = jax.vmap(functools.partial(
        jax_result, scan_forever=True))(_jax_states(state))
    got_state, got_result = scanner_result(state, scan_forever=True)
    assert_same(fx._np(ref_result), got_result)
    assert_same(fx._np(ref_state), got_state)


def test_config_overrides_the_flag():
    """config.scan_expiry wins over the scan_expiry argument, as in the
    JAX package's scanner_step; the port's ScanConfig keeps the gates that
    mean something off the TPU, with the JAX package's defaults."""
    frames = torch.from_numpy(fx.expiry_frames()[:1, 0])
    state = init_stream_states(1, "cpu", fx.NOW)
    state, (frame, _) = batched_scanner_step(
        port_params(), state, frames, scan_expiry=False,
        config=ScanConfig())
    assert bool(state.scan_expiry[0]) and bool(frame.expiry_groups.valid.any())
    ref = JaxScanConfig()
    for field in ("scan_expiry", "collect_card_number", "scan_forever",
                  "expiry_allow_past_dates", "n_streams"):
        assert getattr(DEFAULT_CONFIG, field) == getattr(ref, field)
    with pytest.raises(TypeError):
        DEFAULT_CONFIG.replace(use_pallas=True)


def test_collect_card_number_off_drops_the_number_check():
    """frame.cpp:49-69: without collect_card_number a frame is usable on
    the vseg gate alone. A card whose digit rows are turned over keeps its
    vseg row but fails the number-score check."""
    turned = fx.expiry_frames()[0, 0].copy()
    turned[150:177] = turned[176:149:-1]
    frames = np.stack([fx.expiry_frames()[0, 0], turned])
    params = load_all_params()
    ref = fx._np(jax.jit(jax.vmap(lambda y: jax_scan_card_image(
        params, y, collect_card_number=False, scan_expiry=True)))(frames))
    got = scan_card_image(port_params(), _t(frames),
                          collect_card_number=False, scan_expiry=True)
    assert_same(ref, got, atol=ATOL, rtol=1e-5)
    with_check = scan_card_image(port_params(), _t(frames), scan_expiry=True)
    assert to_np(got.usable).tolist() == [True, True]
    assert to_np(with_check.usable).tolist() == [True, False]
    # the number-score check does not gate the expiry seg
    assert_same(got.expiry_groups, with_check.expiry_groups)


# --- the full camera step --------------------------------------------------

@functools.lru_cache(maxsize=None)
def _port_camera_run():
    y, cb, cr = (torch.from_numpy(a) for a in fx.expiry_camera_frames())
    state = init_stream_states(len(y), "cpu", fx.NOW)
    out = []
    for t in range(fx.EXPIRY_FRAMES):
        state, (found, frame, result) = batched_camera_step(
            port_params(), state, y[:, t], cb[:, t], cr[:, t],
            scan_expiry=True)
        out.append((state, found, frame, result))
    return out


@pytest.mark.parametrize("step", range(fx.EXPIRY_FRAMES))
def test_full_camera_step_matches_jax_vmap(step):
    ref_state, ref_found, ref_frame, ref_result, _, _ = \
        fx.jax_expiry_camera_session()[step]
    state, found, frame, result = _port_camera_run()[step]
    np.testing.assert_array_equal(to_np(found), ref_found)
    assert_same(ref_frame, frame, atol=ATOL, rtol=1e-5)
    assert_same(ref_result, result)
    assert_same(ref_state, state, atol=ATOL, rtol=1e-5)


def test_full_camera_sessions_read_pan_and_date():
    state, _, _, result = _port_camera_run()[-1]
    assert [_pan(d) for d in state.completed_digits] == [
        "4111111111111111", "4530504390541813", "4111111111111111"]
    assert to_np(result.expiry_month).tolist() == [8, 11, 0]
    assert to_np(result.expiry_year).tolist() == [2028, 2029, 0]
    assert to_np(result.complete).tolist() == [True, True, False]


# --- the fixture -----------------------------------------------------------

def test_expiry_fixture_is_current():
    """The committed expiry_session.npz is what the JAX package computes
    today, so that chip_smoke.py checks the port against current results."""
    fresh = fx.expiry_fixture_arrays()
    with np.load(fx.EXPIRY_FIXTURE) as committed:
        assert sorted(committed.files) == sorted(fresh)
        for k, v in fresh.items():
            if np.issubdtype(v.dtype, np.floating):
                np.testing.assert_allclose(committed[k], v, atol=ATOL,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(committed[k], v, err_msg=k)


def _fixture_fields(run, prefix):
    """A port run's per-frame arrays under the fixture's keys."""
    def per_frame(get):
        return np.stack([to_np(get(r)) for r in run], axis=1)

    out = {f"window_{k}": per_frame(lambda r: getattr(r[1].expiry_groups, k))
           for k in tx.ExpiryWindows._fields}
    out.update({f"expiry_{k}": per_frame(lambda r: getattr(r[0].expiry, k))
                for k in tx.ExpiryState._fields})
    out.update(expiry_month=per_frame(lambda r: r[0].expiry_month),
               expiry_year=per_frame(lambda r: r[0].expiry_year),
               complete=per_frame(lambda r: r[2].complete),
               result_month=per_frame(lambda r: r[2].expiry_month),
               result_year=per_frame(lambda r: r[2].expiry_year),
               completed_digits=to_np(run[-1][0].completed_digits))
    return {prefix + k: v for k, v in out.items()}


def test_expiry_fixture_through_port():
    """chip_smoke.py's expiry check, here on the CPU: the fixture's frames
    through the full scanner and camera steps give the recorded windows,
    states and dates."""
    with np.load(fx.EXPIRY_FIXTURE) as f:
        fixture = {k: f[k] for k in f.files}
    np.testing.assert_array_equal(fixture["frames"], fx.expiry_frames())
    got = _fixture_fields(_port_run(), "")
    got.update(_fixture_fields(
        [(s, f, r) for s, _, f, r in _port_camera_run()], "camera_"))
    got["window_scores"] = np.stack([to_np(r[3]) for r in _port_run()], 1)
    for k, v in got.items():
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(v, fixture[k], atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(v, fixture[k], err_msg=k)

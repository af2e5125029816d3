"""Cross-frame scanner session state machine (scan/scan.cpp), stream-major.

Counterpart of the JAX package's session/state.py, with the camera step
in front of it. Every field of ScannerState carries a
leading stream axis S, and every function steps all streams at once; a
fold over time is a Python loop.

Semantics mirrored from the C++:
* per-frame EWMA of score matrices, decay 0.8, into separate 15- and
  16-digit accumulators (scan.cpp:69-85)
* completion: >= 3-frame lead AND 2x count ratio between the 15/16
  hypotheses (scan.cpp:99-111), per-digit stability max/sum >= 0.7
  (scan.cpp:128-147), BIN-prefix and Luhn validation (scan.cpp:149-160)
* once complete, the result latches (scan.cpp:95-97)
* expiry grace: the reference waits about 1 s of wall time after the PAN
  completes for the date to resolve (scan.cpp:163-193). The step counts
  frames instead, as the JAX package does: EXPIRY_GRACE_FRAMES = 30, about
  1 s at the camera's 30 frames a second.
"""

import typing

import torch

from ..api import brightness_score, focus_score, preprocess_frame
from ..constants import (
    MIN_FRAME_LEAD,
    ORIENTATION_LANDSCAPE_RIGHT,
    PAN_DECAY_FACTOR,
    PAN_MIN_STABILITY,
)
from ..scan.expiry_device import (
    ExpiryState,
    aggregate_windows,
    categorize_windows,
    expiry_state_init,
    extract_expiry,
)
from ..scan.frame import FrameResult, scan_card_image, telemetry_zeros
from ..utils.olm import card_type_valid, luhn_checksum
from .analytics import ScanAnalytics, analytics_init, analytics_record_frame

EXPIRY_GRACE_FRAMES = 30  # ~1 s at 30 fps (scan.cpp:14,175)


class ScannerState(typing.NamedTuple):
    count15: torch.Tensor           # (S,) int32
    count16: torch.Tensor           # (S,) int32
    aggregated15: torch.Tensor      # (S, 16, 10) f32 (row 15 unused)
    aggregated16: torch.Tensor      # (S, 16, 10) f32
    # most recent usable segmentation (scan.cpp:71-72)
    last_offsets: torch.Tensor      # (S, 16) int32
    last_n_offsets: torch.Tensor    # (S,) int32
    last_number_width: torch.Tensor  # (S,) f32
    last_pattern_offset: torch.Tensor  # (S,) int32
    last_vseg_y: torch.Tensor       # (S,) int32
    last_vseg_pattern: torch.Tensor  # (S,) int32
    # completion latch (scan.cpp:95-97,158-159)
    number_complete: torch.Tensor   # (S,) bool
    completed_digits: torch.Tensor  # (S, 16) int32
    completed_n: torch.Tensor       # (S,) int32
    frames_since_complete: torch.Tensor  # (S,) int32
    # expiry (scan/expiry_device.py)
    scan_expiry: torch.Tensor       # (S,) bool
    expiry_month: torch.Tensor      # (S,) int32
    expiry_year: torch.Tensor       # (S,) int32
    expiry: ExpiryState
    now_year: torch.Tensor          # (S,) int32 (date for expiry sanity)
    now_month: torch.Tensor         # (S,) int32
    analytics: ScanAnalytics


class ScannerResult(typing.NamedTuple):
    """ScannerResult (scan/scan.h:19-31), one row per stream."""
    complete: torch.Tensor      # (S,) bool
    n_numbers: torch.Tensor     # (S,) int32
    predictions: torch.Tensor   # (S, 16) int32 digit values
    expiry_month: torch.Tensor  # (S,) int32
    expiry_year: torch.Tensor   # (S,) int32


def scanner_reset(now, n_streams, device) -> ScannerState:
    """scanner_reset (scan.cpp:23-35) for n_streams fresh sessions.
    now = (year, month), the date for the expiry sanity window (the
    reference reads the wall clock, expiry_categorize.cpp:352-354)."""
    def zeros(*shape, dtype=torch.int32):
        return torch.zeros((n_streams,) + shape, dtype=dtype, device=device)

    def full(v):
        return torch.full((n_streams,), int(v), dtype=torch.int32,
                          device=device)

    return ScannerState(
        count15=zeros(), count16=zeros(),
        aggregated15=zeros(16, 10, dtype=torch.float32),
        aggregated16=zeros(16, 10, dtype=torch.float32),
        last_offsets=zeros(16),
        last_n_offsets=zeros(),
        last_number_width=zeros(dtype=torch.float32),
        last_pattern_offset=zeros(),
        last_vseg_y=zeros(),
        last_vseg_pattern=zeros(),
        number_complete=zeros(dtype=torch.bool),
        completed_digits=zeros(16),
        completed_n=zeros(),
        frames_since_complete=zeros(),
        scan_expiry=zeros(dtype=torch.bool),
        expiry_month=zeros(),
        expiry_year=zeros(),
        expiry=expiry_state_init(n_streams, device),
        now_year=full(now[0]),
        now_month=full(now[1]),
        analytics=analytics_init(n_streams, device),
    )


def _select(mask, a, b):
    """Per stream: a where mask (S,) is set, else b; field by field through
    nested NamedTuples."""
    if isinstance(a, tuple):
        return type(a)(*(_select(mask, x, y) for x, y in zip(a, b)))
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def _stack(items, dim):
    """Stack a list of equal-shaped (nested) NamedTuples of tensors."""
    if isinstance(items[0], tuple):
        return type(items[0])(*(_stack(list(f), dim) for f in zip(*items)))
    return torch.stack(items, dim)


def _accumulate(state: ScannerState, frame: FrameResult) -> ScannerState:
    """EWMA update as for a usable frame (scan.cpp:69-85)."""
    is15 = frame.hseg.n_offsets == 15
    is16 = frame.hseg.n_offsets == 16

    def decayed(agg, active):
        upd = agg * PAN_DECAY_FACTOR + frame.scores * (1 - PAN_DECAY_FACTOR)
        return torch.where(active[:, None, None], upd, agg)

    return state._replace(
        aggregated15=decayed(state.aggregated15, is15),
        aggregated16=decayed(state.aggregated16, is16),
        count15=state.count15 + is15.to(torch.int32),
        count16=state.count16 + is16.to(torch.int32),
        last_offsets=frame.hseg.offsets,
        last_n_offsets=frame.hseg.n_offsets,
        last_number_width=frame.hseg.number_width,
        last_pattern_offset=frame.hseg.pattern_offset,
        last_vseg_y=frame.vseg.y_offset,
        last_vseg_pattern=frame.vseg.pattern_type,
    )


def scanner_add_frame(params, state: ScannerState, y, scan_expiry=False,
                      telemetry=None, frame_gate=None,
                      allow_past_dates=False, config=None):
    """scanner_add_frame_with_expiry (scan.cpp:41-86): run the frame
    pipeline and fold the result into every stream's session.

    y: (S, 270, 428) uint8. telemetry: optional FrameTelemetry (camera
    metadata, frame.h:15-27). frame_gate: optional (S,) bool, the camera
    path's "card was found": where it is False the frame is unusable and
    goes unrecorded, as the reference's host app never calls
    scanner_add_frame for a frame whose detection failed. config: optional
    ScanConfig for the frame's gates.
    Returns (new_state, FrameResult)."""
    still_need_number = ~state.number_complete
    expiry_gate = True
    if scan_expiry:
        # scan.cpp:44: the expiry seg runs only while the date is unresolved
        expiry_gate = (state.expiry_month == 0) | (state.expiry_year == 0)
        if frame_gate is not None:
            expiry_gate = expiry_gate & frame_gate
    frame = scan_card_image(params, y, scan_expiry=scan_expiry,
                            expiry_gate=expiry_gate, telemetry=telemetry,
                            config=config)
    record = ~frame.upside_down
    if frame_gate is not None:
        frame = frame._replace(usable=frame.usable & frame_gate)
        record = record & frame_gate
    state = state._replace(analytics=analytics_record_frame(
        state.analytics, frame, record))
    fold = frame.usable & ~frame.upside_down & still_need_number
    state = _select(fold, _accumulate(state, frame), state)

    if scan_expiry:
        # scan.cpp:62-66: categorize and aggregate the frame's groups
        windows = frame.expiry_groups
        scores = categorize_windows(params["expiry_conv"], y, windows)
        # expiry_extract is a no-op when segmentation found nothing
        # (expiry_categorize.cpp:454-456); windows.valid already holds the
        # vseg, room and still-needed gates. The session also drops an
        # unusable frame (scan.cpp:57), and `usable` there holds the
        # number-score check only while the number is being collected
        # (frame.cpp:49-69).
        session_ok = frame.usable | state.number_complete
        any_new = windows.valid.any(dim=1) & session_ok
        expiry_state = _select(
            any_new, aggregate_windows(state.expiry, windows, scores),
            state.expiry)
        month, year = extract_expiry(
            expiry_state, state.expiry_month, state.expiry_year,
            state.now_year, state.now_month,
            allow_past_dates=allow_past_dates)
        state = state._replace(
            expiry=expiry_state,
            expiry_month=torch.where(any_new, month, state.expiry_month),
            expiry_year=torch.where(any_new, year, state.expiry_year))

    state = state._replace(
        scan_expiry=state.scan_expiry | scan_expiry,
        frames_since_complete=torch.where(
            state.number_complete, state.frames_since_complete + 1, 0))
    return state, frame


def _try_complete(state: ScannerState):
    """The acceptance decision (scan.cpp:99-160). Returns
    (accept (S,) bool, digits (S, 16) int32, n (S,) int32)."""
    c15, c16 = state.count15, state.count16
    max_c = torch.maximum(c15, c16)
    min_c = torch.minimum(c15, c16)
    lead_ok = (max_c - min_c >= MIN_FRAME_LEAD) & (min_c * 2 <= max_c)

    use15 = c15 > c16
    aggregated = torch.where(use15[:, None, None], state.aggregated15,
                             state.aggregated16)
    n = torch.where(use15, 15, 16).to(torch.int32)

    digits = torch.argmax(aggregated, dim=-1).to(torch.int32)   # (S, 16)
    row_max = aggregated.amax(dim=-1)
    row_sum = aggregated.sum(dim=-1)
    stability = row_max / torch.where(row_sum > 0, row_sum, 1.0)
    active = torch.arange(16, device=n.device) < n[:, None]
    stable = torch.where(active, stability >= PAN_MIN_STABILITY, True).all(1)

    accept = (lead_ok & stable & luhn_checksum(digits, n)
              & card_type_valid(digits, n))
    return accept, digits, n


def scanner_result(state: ScannerState, scan_forever=False):
    """scanner_result (scan.cpp:88-194). Completion latches into the
    state, so callers thread the returned state. A session that scans the
    expiry completes once it has the number and either a date or more than
    EXPIRY_GRACE_FRAMES frames since the number. scan_forever mirrors
    SCAN_FOREVER (scan.cpp:13,91-93): never complete.
    Returns (new_state, ScannerResult)."""
    if scan_forever:
        return state, ScannerResult(
            complete=torch.zeros_like(state.number_complete),
            n_numbers=torch.zeros_like(state.completed_n),
            predictions=torch.zeros_like(state.completed_digits),
            expiry_month=torch.zeros_like(state.expiry_month),
            expiry_year=torch.zeros_like(state.expiry_year))
    accept, digits, n = _try_complete(state)
    newly = accept & ~state.number_complete
    state = state._replace(
        number_complete=state.number_complete | accept,
        completed_digits=torch.where(newly[:, None], digits,
                                     state.completed_digits),
        completed_n=torch.where(newly, n, state.completed_n),
    )
    expiry_found = (state.expiry_month > 0) & (state.expiry_year > 0)
    grace_over = state.frames_since_complete > EXPIRY_GRACE_FRAMES
    expiry_done = ~state.scan_expiry | expiry_found | grace_over
    complete = state.number_complete & expiry_done
    with_date = complete & state.scan_expiry
    result = ScannerResult(
        complete=complete,
        n_numbers=state.completed_n,
        predictions=state.completed_digits,
        expiry_month=torch.where(with_date, state.expiry_month, 0),
        expiry_year=torch.where(with_date, state.expiry_year, 0),
    )
    return state, result


def scanner_step(params, state: ScannerState, y, scan_expiry=False,
                 config=None, telemetry=None, frame_gate=None):
    """One frame for every stream: add_frame + result. config (a
    ScanConfig) overrides scan_expiry and supplies scan_forever and
    expiry_allow_past_dates.
    Returns (state, (FrameResult, ScannerResult))."""
    scan_forever = allow_past_dates = False
    if config is not None:
        scan_expiry = config.scan_expiry
        scan_forever = config.scan_forever
        allow_past_dates = config.expiry_allow_past_dates
    state, frame = scanner_add_frame(params, state, y, scan_expiry,
                                     telemetry=telemetry,
                                     frame_gate=frame_gate,
                                     allow_past_dates=allow_past_dates,
                                     config=config)
    state, result = scanner_result(state, scan_forever=scan_forever)
    return state, (frame, result)


def _metadata(value, dtype, like):
    """One camera metadata input as an (S,) tensor of `dtype` on the
    frames' device; None reads as zeros."""
    if value is None:
        return torch.zeros(like.shape[:1], dtype=dtype, device=like.device)
    value = torch.as_tensor(value, device=like.device).to(dtype)
    if value.shape != like.shape[:1]:
        raise ValueError(f"camera metadata must be (S,) = "
                         f"{tuple(like.shape[:1])}; got {tuple(value.shape)}")
    return value


def camera_scanner_step(params, state: ScannerState, y, cb, cr,
                        scan_expiry=False, config=None,
                        orientation=ORIENTATION_LANDSCAPE_RIGHT,
                        iso_speed=None, shutter_speed=None, torch_is_on=None):
    """Camera frame -> digits for every stream: the reference's
    per-preview-frame host loop (dmz_detect_edges + dmz_transform_card,
    dmz.cpp:371-497, then scanner_add_frame) in one step.

    y: (S, 480, 640) u8 luma; cb/cr: (S, 240, 320) u8 half-size chroma.
    iso_speed, shutter_speed, torch_is_on: the camera's metadata, (S,)
    tensors or None (zeros). They and the frame's focus and brightness go
    into its telemetry and the analytics ring. A frame where the card is
    not found contributes nothing (frame_gate).
    Returns (state, (found, FrameResult, ScannerResult))."""
    found, card = preprocess_frame(y, cb, cr, orientation)
    telemetry = telemetry_zeros(y.shape[0], y.device)._replace(
        focus_score=focus_score(y), brightness_score=brightness_score(y),
        iso_speed=_metadata(iso_speed, torch.int32, y),
        shutter_speed=_metadata(shutter_speed, torch.float32, y),
        torch_is_on=_metadata(torch_is_on, torch.bool, y))
    state, (frame, result) = scanner_step(params, state, card, scan_expiry,
                                          config, telemetry=telemetry,
                                          frame_gate=found)
    return state, (found, frame, result)


def scan_frames(params, frames, now, scan_expiry=False):
    """Fold (S, T, 270, 428) frames through S fresh sessions, one step per
    frame. Returns (final_state, (FrameResults, ScannerResults)), the
    per-frame results stacked as (S, T, ...)."""
    state = scanner_reset(now, frames.shape[0], frames.device)
    per_frame = []
    for t in range(frames.shape[1]):
        state, out = scanner_step(params, state, frames[:, t], scan_expiry)
        per_frame.append(out)
    frame_results, results = zip(*per_frame)
    return state, (_stack(list(frame_results), 1), _stack(list(results), 1))

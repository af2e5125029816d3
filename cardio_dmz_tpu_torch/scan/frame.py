"""Per-frame orchestration on rectified 428x270 card images, per stream.

Counterpart of the JAX package's scan/frame.py (the reference's
scan_card_image, scan/frame.cpp:24-81): vseg -> upside-down check ->
usability gate -> hseg on the 27-row strip -> digit scores -> usability.
Every stage runs for every stream; the reference's early-outs become the
masks the gates compute.
"""

import typing

import torch

from ..config import DEFAULT_CONFIG
from ..constants import (
    CARD_HEIGHT,
    FLIP_VSEG_Y_OFFSET_CUTOFF,
    MAX_NUMBER_SCORE_DELTA,
    MIN_VSEG_SCORE,
    NUMBER_HEIGHT,
    SMALL_CHARACTER_HEIGHT,
)
from .categorize import number_scores
from .expiry_device import ExpiryWindows, best_expiry_seg_device, no_windows
from .hseg import HSeg, best_n_hseg
from .vseg import VSeg, best_n_vseg


class FrameTelemetry(typing.NamedTuple):
    """Host/camera-supplied per-frame metadata (frame.h:15-27 tail fields)."""
    focus_score: torch.Tensor       # (S,) f32
    brightness_score: torch.Tensor  # (S,) f32
    iso_speed: torch.Tensor         # (S,) int32
    shutter_speed: torch.Tensor     # (S,) f32
    torch_is_on: torch.Tensor       # (S,) bool
    flipped: torch.Tensor           # (S,) bool


def telemetry_zeros(n_streams, device) -> FrameTelemetry:
    def zeros(dtype):
        return torch.zeros((n_streams,), dtype=dtype, device=device)

    return FrameTelemetry(
        focus_score=zeros(torch.float32),
        brightness_score=zeros(torch.float32),
        iso_speed=zeros(torch.int32),
        shutter_speed=zeros(torch.float32),
        torch_is_on=zeros(torch.bool),
        flipped=zeros(torch.bool),
    )


class FrameResult(typing.NamedTuple):
    """FrameScanResult (frame.h:14-28), one row per stream."""
    vseg: VSeg
    hseg: HSeg
    scores: torch.Tensor           # (S, 16, 10) float32
    usable: torch.Tensor           # (S,) bool
    upside_down: torch.Tensor      # (S,) bool
    focus_score: torch.Tensor      # (S,) f32 (frame.h:15)
    brightness_score: torch.Tensor  # (S,) f32 (frame.h:24)
    iso_speed: torch.Tensor        # (S,) int32 (frame.h:25)
    shutter_speed: torch.Tensor    # (S,) f32 (frame.h:26)
    torch_is_on: torch.Tensor      # (S,) bool (frame.h:27)
    flipped: torch.Tensor          # (S,) bool (frame.h:23)
    expiry_groups: ExpiryWindows   # (frame.h:19)
    name_groups: ExpiryWindows     # (frame.h:20), always empty in serving


def pan_strip(y, y_offset):
    """The 27 rows from clip(y_offset, 0, 243) of each stream's frame
    (frame.cpp:50). y: (S, 270, 428) u8 -> (S, 27, 428) u8, contiguous."""
    y_off = y_offset.to(torch.int64).clamp(0, CARD_HEIGHT - NUMBER_HEIGHT)
    rows = y_off[:, None] + torch.arange(NUMBER_HEIGHT, device=y.device)
    return torch.gather(y, 1, rows[:, :, None].expand(-1, -1, y.shape[2]))


def scan_card_image(params, y, collect_card_number=None, scan_expiry=False,
                    expiry_gate=True, telemetry=None,
                    config=None) -> FrameResult:
    """y: (S, 270, 428) uint8 rectified card luma; params: load_all_params().

    Gates of frame.cpp:24-81:
    * upside_down iff vseg.y_offset < (270 - 27) / 2 (frame.cpp:38-41)
    * usable iff vseg.score > 15 (frame.cpp:43)
    * and, while the card number is collected, n_offsets - sum(scores) < 3
      (frame.cpp:63-64); collect_card_number None takes config's, and
      config None is DEFAULT_CONFIG
    * expiry segmentation (scan_expiry) where the frame passed the vseg
      gate, is right side up and leaves >= 2 small char heights below the
      number row (frame.cpp:71-80), and expiry_gate, True or (S,) bool, is
      set: the session's "date still needed" (scan.cpp:44). The
      number-score check does not gate it.

    telemetry: the camera's FrameTelemetry, carried into the result; zeros
    when None.
    """
    if collect_card_number is None:
        collect_card_number = (config or DEFAULT_CONFIG).collect_card_number
    n_streams, device = y.shape[0], y.device
    if telemetry is None:
        telemetry = telemetry_zeros(n_streams, device)
    vseg = best_n_vseg(params["vseg_mlp"], y)

    upside_down = vseg.y_offset < FLIP_VSEG_Y_OFFSET_CUTOFF
    vseg_usable = vseg.score > MIN_VSEG_SCORE

    strip = pan_strip(y, vseg.y_offset)
    hseg = best_n_hseg(strip, vseg.pattern_type, vseg.number_length)
    scores = number_scores(params, strip, hseg.offsets, hseg.n_offsets)

    number_score = hseg.n_offsets.to(torch.float32) - scores.sum(dim=(1, 2))
    number_usable = number_score < MAX_NUMBER_SCORE_DELTA
    usable = vseg_usable & ~upside_down
    if collect_card_number:
        usable = usable & number_usable

    if scan_expiry:
        room = vseg.y_offset < CARD_HEIGHT - 2 * SMALL_CHARACTER_HEIGHT
        expiry_groups = best_expiry_seg_device(
            params["slash_mlp"], y, vseg.y_offset,
            vseg_usable & ~upside_down & room & expiry_gate)
    else:
        expiry_groups = no_windows(n_streams, device)

    return FrameResult(
        vseg=vseg,
        hseg=hseg,
        scores=scores,
        usable=usable,
        upside_down=upside_down,
        focus_score=telemetry.focus_score,
        brightness_score=telemetry.brightness_score,
        iso_speed=telemetry.iso_speed,
        shutter_speed=telemetry.shutter_speed,
        torch_is_on=telemetry.torch_is_on,
        flipped=telemetry.flipped,
        expiry_groups=expiry_groups,
        name_groups=no_windows(n_streams, device),
    )

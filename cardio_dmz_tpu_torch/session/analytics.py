"""Per-session frame analytics ring buffer (scan/scan_analytics.cpp),
stream-major.

The reference keeps a 20-frame ring of per-frame scan records for
telemetry (scan_analytics.h:22-32). Numeric fields only: consumers format
on the host.
"""

import typing

import torch

RING_SIZE = 20  # kScanSessionAnalyticsMaxScannedFrames


class ScanAnalytics(typing.NamedTuple):
    n_recorded: torch.Tensor        # (S,) int32 total frames recorded
    write_idx: torch.Tensor         # (S,) int32 ring cursor
    vseg_score: torch.Tensor        # (S, 20) f32
    vseg_y: torch.Tensor            # (S, 20) int32
    pattern_type: torch.Tensor      # (S, 20) int32
    hseg_score: torch.Tensor        # (S, 20) f32
    usable: torch.Tensor            # (S, 20) bool
    # camera telemetry carried on FrameScanResult (frame.h:15-27)
    focus_score: torch.Tensor       # (S, 20) f32
    brightness_score: torch.Tensor  # (S, 20) f32
    iso_speed: torch.Tensor         # (S, 20) int32
    shutter_speed: torch.Tensor     # (S, 20) f32
    torch_is_on: torch.Tensor       # (S, 20) bool
    upside_down: torch.Tensor       # (S, 20) bool
    flipped: torch.Tensor           # (S, 20) bool


_DTYPES = {"vseg_score": torch.float32, "vseg_y": torch.int32,
           "pattern_type": torch.int32, "hseg_score": torch.float32,
           "usable": torch.bool, "focus_score": torch.float32,
           "brightness_score": torch.float32, "iso_speed": torch.int32,
           "shutter_speed": torch.float32, "torch_is_on": torch.bool,
           "upside_down": torch.bool, "flipped": torch.bool}


def analytics_init(n_streams, device) -> ScanAnalytics:
    zero = torch.zeros((n_streams,), dtype=torch.int32, device=device)
    return ScanAnalytics(
        n_recorded=zero, write_idx=zero.clone(),
        **{k: torch.zeros((n_streams, RING_SIZE), dtype=d, device=device)
           for k, d in _DTYPES.items()})


def analytics_record_frame(a: ScanAnalytics, frame, record) -> ScanAnalytics:
    """scan_analytics_record_frame (scan_analytics.cpp:34-54): write the
    frame's record at each stream's cursor where `record` (S,) is set."""
    i = a.write_idx
    slot = record[:, None] & (
        torch.arange(RING_SIZE, device=i.device) == i[:, None])

    values = {"vseg_score": frame.vseg.score, "vseg_y": frame.vseg.y_offset,
              "pattern_type": frame.vseg.pattern_type,
              "hseg_score": frame.hseg.score, "usable": frame.usable,
              "focus_score": frame.focus_score,
              "brightness_score": frame.brightness_score,
              "iso_speed": frame.iso_speed,
              "shutter_speed": frame.shutter_speed,
              "torch_is_on": frame.torch_is_on,
              "upside_down": frame.upside_down, "flipped": frame.flipped}
    return ScanAnalytics(
        n_recorded=a.n_recorded + record.to(torch.int32),
        write_idx=torch.where(record, (i + 1) % RING_SIZE, i),
        **{k: torch.where(slot, v[:, None].to(_DTYPES[k]), getattr(a, k))
           for k, v in values.items()})

"""Expiry types, stream-major (the JAX package's scan/expiry_device.py:47-97).

Only the types that FrameResult and ScannerState carry, so that both match
the JAX ones field for field. The in-graph expiry read itself belongs to
the next slice of the port (ROADMAP.md); until then the windows are always
empty and the state stays at its initial value.
"""

import typing

import torch

MAX_WINDOWS = 4               # emitted MM/YY windows per frame
MAX_SLOTS = 4                 # aggregated cross-frame group slots


class ExpiryWindows(typing.NamedTuple):
    """Per-frame MM/YY candidate windows (fixed MAX_WINDOWS slots)."""
    valid: torch.Tensor       # (S, W) bool
    top: torch.Tensor         # (S, W) int32 group top (min char top)
    left: torch.Tensor        # (S, W) int32 first char left
    char_tops: torch.Tensor   # (S, W, 5) int32
    char_lefts: torch.Tensor  # (S, W, 5) int32


def _zeros(n_streams, device, *shape, dtype=torch.int32):
    return torch.zeros((n_streams,) + shape, dtype=dtype, device=device)


def no_windows(n_streams, device) -> ExpiryWindows:
    """An all-invalid window set for every stream."""
    return ExpiryWindows(
        valid=_zeros(n_streams, device, MAX_WINDOWS, dtype=torch.bool),
        top=_zeros(n_streams, device, MAX_WINDOWS),
        left=_zeros(n_streams, device, MAX_WINDOWS),
        char_tops=_zeros(n_streams, device, MAX_WINDOWS, 5),
        char_lefts=_zeros(n_streams, device, MAX_WINDOWS, 5))


class ExpiryState(typing.NamedTuple):
    """Cross-frame aggregated group table (the GroupedRectsList role)."""
    active: torch.Tensor         # (S, SLOTS) bool
    top: torch.Tensor            # (S, SLOTS) int32
    left: torch.Tensor           # (S, SLOTS) int32
    scores: torch.Tensor         # (S, SLOTS, 5, 10) f32
    recently_seen: torch.Tensor  # (S, SLOTS) int32
    total_seen: torch.Tensor     # (S, SLOTS) int32


def expiry_state_init(n_streams, device) -> ExpiryState:
    return ExpiryState(
        active=_zeros(n_streams, device, MAX_SLOTS, dtype=torch.bool),
        top=_zeros(n_streams, device, MAX_SLOTS),
        left=_zeros(n_streams, device, MAX_SLOTS),
        scores=_zeros(n_streams, device, MAX_SLOTS, 5, 10,
                      dtype=torch.float32),
        recently_seen=_zeros(n_streams, device, MAX_SLOTS),
        total_seen=_zeros(n_streams, device, MAX_SLOTS),
    )

"""Vertical segmentation: find the PAN row and pattern type, per stream.

Counterpart of the JAX package's scan/vseg.py (the reference's
best_n_vseg, scan/n_vseg.cpp:94-168). Every one of the 270 strip rows goes
through the MLP: 408-px strip at x=10 -> 1-D morph gradient -> 2x
downsample -> min-max normalize -> MLP(204->50->3) = P(nothing / visa-like
row / amex-like row). A window's score is the sum of 27 consecutive row
probabilities; the best (pattern, offset) is the first maximum with visa
checked before amex at each offset (n_vseg.cpp:74-85).
"""

import functools
import typing

import torch

from ..constants import (
    CARD_HEIGHT,
    NUMBER_LENGTH_FOR_PATTERN,
    PATTERN_LENGTH_FOR_PATTERN,
    PATTERN_MASKS,
    PATTERN_UNKNOWN,
    VSEG_STRIP_WIDTH,
    VSEG_STRIP_X,
    VSEG_WINDOW,
)
from ..ops import lineardown2_1d_u8, morph_grad3_1d_u8, norm_convert_minmax
from ..ops.prefix import cumsum

N_WINDOWS = CARD_HEIGHT - VSEG_WINDOW + 1  # 244


class VSeg(typing.NamedTuple):
    """NVerticalSegmentation (scan/n_vseg.h:14-21), one row per stream."""
    y_offset: torch.Tensor        # (S,) int32
    pattern_type: torch.Tensor    # (S,) int32: 0 unknown, 1 visa, 2 amex
    score: torch.Tensor           # (S,) float32, sum of 27 row probabilities
    number_length: torch.Tensor   # (S,) int32: 16 / 15 / 0
    pattern_length: torch.Tensor  # (S,) int32: 19 / 17 / 0
    pattern_mask: torch.Tensor    # (S, 19) int32 digit-presence mask


@functools.lru_cache(maxsize=None)
def _pattern_tables(device):
    """(number length, pattern length, digit mask) rows per pattern type,
    kept on `device`: building them per call would copy from the host and
    stall the stream."""
    return tuple(torch.tensor(rows, dtype=torch.int32, device=device)
                 for rows in (NUMBER_LENGTH_FOR_PATTERN,
                              PATTERN_LENGTH_FOR_PATTERN, PATTERN_MASKS))


def vseg_row_probabilities(vseg_mlp, y):
    """y: (..., 270, 428) uint8 -> (..., 270, 3) float32."""
    strips = y[..., VSEG_STRIP_X:VSEG_STRIP_X + VSEG_STRIP_WIDTH]
    down = lineardown2_1d_u8(morph_grad3_1d_u8(strips))   # (..., 270, 204)
    return vseg_mlp(norm_convert_minmax(down, dim=-1))


def best_n_vseg(vseg_mlp, y) -> VSeg:
    """y: (S, 270, 428) uint8."""
    probs = vseg_row_probabilities(vseg_mlp, y)            # (S, 270, 3)
    # prefix sums of [0, p0, p1, ...] per pattern, in the JAX package's
    # order (ops/prefix.py): a near-tie between windows breaks as there
    c = cumsum(torch.nn.functional.pad(probs[..., 1:].transpose(1, 2),
                                       (1, 0))).transpose(1, 2)  # (S, 271, 2)
    windows = c[:, VSEG_WINDOW:] - c[:, :-VSEG_WINDOW]     # (S, 244, 2)
    # first max of [vis0, amex0, vis1, amex1, ...]
    flat = windows.reshape(windows.shape[0], -1)
    best = torch.argmax(flat, dim=1)
    best_score = torch.gather(flat, 1, best[:, None])[:, 0]
    # all-zero scores -> unknown (n_vseg.cpp:59-61)
    found = best_score > 0.0
    pattern = torch.where(found, best % 2 + 1, PATTERN_UNKNOWN).to(torch.int32)
    y_offset = torch.where(found, best // 2, 0).to(torch.int32)

    number_length, pattern_length, pattern_mask = (
        table[pattern.long()] for table in _pattern_tables(y.device))
    return VSeg(
        y_offset=y_offset,
        pattern_type=pattern,
        score=best_score,
        number_length=number_length,
        pattern_length=pattern_length,
        pattern_mask=pattern_mask,
    )

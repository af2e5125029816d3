"""PAN digit categorization: score all 16 digit cells of every stream.

Counterpart of the JAX package's scan/categorize.py (the reference's
scan/n_categorize.cpp). Per digit cell (n_categorize.cpp:94-101): 19x27
crop at its hseg offset -> 2-D cross morph gradient clamped at the CELL
border -> histogram equalize -> [0, 1] f32 -> 3-model conv ensemble
(r0 + r1 + r2 - max) / 2 (n_categorize.cpp:69-71).
"""

import torch

from ..constants import NUMBER_WIDTH
from ..models import pan_digit_scores
from ..ops.cuda.digit_prep import (  # noqa: F401
    prepare_cells, prepare_digit_cells)


def extract_cells(y_strip, offsets):
    """The 16 digit cells: y_strip[:, off:off + 19] for each offset.
    y_strip: (27, 428) u8; offsets: (16,) int in [0, 409] ->
    (16, 27, 19) u8."""
    return torch.stack([y_strip[:, o:o + NUMBER_WIDTH]
                        for o in offsets.tolist()])


def number_scores(params, y_strip, offsets, n_offsets):
    """(S, 16, 10) scores; rows >= n_offsets are zero (NumberScores,
    scan/n_categorize.h:14; unused rows stay Zero, n_categorize.cpp:93).

    params: load_all_params(); y_strip: (S, 27, 428) u8; offsets: (S, 16)
    int32; n_offsets: (S,) int. Cell crop and prep go through the
    digit-prep kernel for CUDA tensors and its plain version on the CPU."""
    prepped = prepare_digit_cells(y_strip.contiguous(),
                                  offsets.to(torch.int32).contiguous())
    scores = pan_digit_scores(params["pan_conv_a"], params["pan_conv_b"],
                              params["pan_conv_c"], prepped)  # (S, 16, 10)
    active = torch.arange(16, device=y_strip.device) < n_offsets[:, None]
    return torch.where(active[:, :, None], scores, 0.0)

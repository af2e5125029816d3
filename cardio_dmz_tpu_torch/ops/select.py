"""Narrow column windows of a shared band, one per candidate.

The expiry stages (expiry_seg.cpp:255-331 trimming, :29-54 slash crops,
expiry_categorize.cpp:149-252 digit crops) each need, per candidate k, a
few columns of a band from a position of its own. The JAX package builds
them from one-hot contractions; here it is a gather.
"""

import torch


def window_select(band, lefts, x_width):
    """crops[..., k, r, x] = band[..., r, clip(lefts[..., k]) + x], x <
    x_width, with lefts clipped to [0, C - x_width].

    band: (..., R, C); lefts: (..., K) int, the same batch dims as band.
    Returns (..., K, R, x_width) in band's dtype."""
    r, c = band.shape[-2:]
    k = lefts.shape[-1]
    l0 = lefts.to(torch.int64).clamp(0, c - x_width)
    cols = l0[..., None] + torch.arange(x_width, device=band.device)
    batch = band.shape[:-2]
    return torch.gather(
        band[..., None, :, :].expand(batch + (k, r, c)), -1,
        cols[..., None, :].expand(batch + (k, r, x_width)))

"""Morphological gradients on u8 images (cv/morph.cpp equivalents).

Borders replicate: the reference clamps indices at ROI edges
(cv/morph.cpp:79-104, 190-215). Leading dims are batch dims; the last one
or two are spatial.
"""

import torch


def _shift(x, dim, step):
    """x shifted by one along `dim` with the border replicated: step=+1
    reads the previous element, step=-1 the next one."""
    n = x.shape[dim]
    if step > 0:
        return torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    return torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)


def morph_grad3_1d_u8(x):
    """Horizontal 3-tap gradient, dilate - erode (cv/morph.cpp:22-106).
    x: (..., W) uint8 -> (..., W) uint8."""
    left, right = _shift(x, -1, 1), _shift(x, -1, -1)
    mx = torch.maximum(torch.maximum(left, x), right)
    mn = torch.minimum(torch.minimum(left, x), right)
    return mx - mn


def morph_grad3_2d_cross_u8(x):
    """Cross-shaped (N, W, C, E, S) gradient, max5 - min5
    (cv/morph.cpp:174-255). x: (..., H, W) uint8 -> same shape uint8."""
    w, e = _shift(x, -1, 1), _shift(x, -1, -1)
    n, s = _shift(x, -2, 1), _shift(x, -2, -1)
    mx = torch.maximum(torch.maximum(torch.maximum(n, s),
                                     torch.maximum(w, e)), x)
    mn = torch.minimum(torch.minimum(torch.minimum(n, s),
                                     torch.minimum(w, e)), x)
    return mx - mn

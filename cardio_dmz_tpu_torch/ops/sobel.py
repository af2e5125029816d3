"""Sobel derivatives on u8 images (cv/sobel.cpp equivalents).

Counterpart of the JAX package's ops/sobel.py: the separable 7x7 Sobel
with replicate borders and int16 saturation (llcv_sobel7), the 3x3
cross derivative of the focus score (llcv_sobel3_dx_dy) and the |d/dx|,
|d/dy| Scharr of the slash model's training crops (llcv_scharr3_*_abs).
Integer arithmetic throughout, so the results equal the JAX package's
exactly.
Leading dims are batch dims.
"""

import torch

EDGE_KERNEL_7 = (-1, -4, -5, 0, 5, 4, 1)
SMOOTH_KERNEL_7 = (1, 6, 15, 20, 15, 6, 1)


def _correlate(x, kernel, dim):
    """1-D correlation along `dim` with replicate padding (kernel length 7,
    anchor 3)."""
    n = x.shape[dim]
    anchor = len(kernel) // 2
    idx = torch.arange(-anchor, n + anchor, device=x.device).clamp(0, n - 1)
    xp = x.index_select(dim, idx)
    out = None
    for i, w in enumerate(kernel):
        if w == 0:
            continue
        term = xp.narrow(dim, i, n) * w
        out = term if out is None else out + term
    return out


def sobel7(x, dx, dy):
    """7x7 Sobel derivative, llcv_sobel7 (cv/sobel.cpp:483-530).
    x: (..., H, W) uint8; exactly one of dx/dy true.
    Returns (..., H, W) int32 saturated to the int16 range."""
    if bool(dx) == bool(dy):
        raise ValueError("exactly one of dx, dy")
    xi = x.to(torch.int32)
    if dx:
        out = _correlate(_correlate(xi, EDGE_KERNEL_7, -1),
                         SMOOTH_KERNEL_7, -2)
    else:
        out = _correlate(_correlate(xi, SMOOTH_KERNEL_7, -1),
                         EDGE_KERNEL_7, -2)
    return out.clamp(-32768, 32767)


def sobel3_dx_dy(x):
    """The focus metric's cross derivative, kernel [[1,0,-1],[0,0,0],
    [-1,0,1]] over the clamped 8-neighbourhood: tl - tr - bl + br
    (cv/sobel.cpp:556-...). x: (..., H, W) uint8 -> (..., H, W) int32."""
    xi = x.to(torch.int32)
    h, w = xi.shape[-2], xi.shape[-1]
    rows = torch.arange(-1, h + 1, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=x.device).clamp(0, w - 1)
    xp = xi.index_select(-2, rows).index_select(-1, cols)
    up, dn = xp[..., :h, :], xp[..., 2:, :]
    return (up[..., :w] - up[..., 2:]) - (dn[..., :w] - dn[..., 2:])


def _clamped_neighbours(x, dim):
    """(previous, next) along `dim`, each with the border sample repeated."""
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device)
    return (x.index_select(dim, (idx - 1).clamp(0, n - 1)),
            x.index_select(dim, (idx + 1).clamp(0, n - 1)))


def scharr3_dx_abs(x):
    """|d/dx| Scharr, llcv_scharr3_dx_abs (cv/sobel.cpp:700-830). The
    reference's quirk is kept: abs of the horizontal central difference
    first, then the vertical (3, 10, 3) smoothing (smooth-of-abs, not
    abs-of-scharr). Borders clamp.
    x: (..., H, W) uint8 -> (..., H, W) int32."""
    left, right = _clamped_neighbours(x.to(torch.int32), -1)
    d = (right - left).abs()
    up, dn = _clamped_neighbours(d, -2)
    return 3 * (up + dn) + 10 * d


def scharr3_dy_abs(x):
    """|d/dy| Scharr, llcv_scharr3_dy_abs (cv/sobel.cpp:838-905): abs of the
    vertical central difference, then the horizontal (3, 10, 3) smoothing.
    x: (..., H, W) uint8 -> (..., H, W) int32."""
    up, dn = _clamped_neighbours(x.to(torch.int32), -2)
    d = (dn - up).abs()
    left, right = _clamped_neighbours(d, -1)
    return 3 * (left + right) + 10 * d

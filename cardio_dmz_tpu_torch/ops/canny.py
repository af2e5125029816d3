"""Canny edges from precomputed aperture-7 Sobel derivatives (cv/canny.cpp).

Counterpart of the JAX package's ops/canny.py on batched bands
(..., H, W):

* magnitude |dx| + |dy|, and non-maximum suppression with the reference's
  fixed-point tan 22.5 degree sectors (cv/canny.cpp:222-285); neighbours
  outside the band read 0, as the reference's zero border does;
* hysteresis with DEFAULT_SWEEPS = 3 fixed sweeps, the serving definition
  (the JAX package's hysteresis_bounded, whose boolean form is
  hysteresis_bounded_unpacked): each sweep is a dilate8 masked by the
  candidates, then a horizontal and a vertical candidate-run flood. It
  equals the exact flood on bands that hold a card edge, and returns a
  subset of it on card-free noise bands. The JAX package packs 32 columns
  per word for the TPU; the port keeps the masks as they are.
"""

import torch
import torch.nn.functional as F

from .sobel import sobel7

CANNY_SHIFT = 15
TG22 = int(0.4142135623730950488016887242097 * (1 << CANNY_SHIFT) + 0.5)
DEFAULT_SWEEPS = 3


def _neighbours(x):
    """x zero-padded by one on its last two dims, and a function giving
    the (di, dj)-shifted view: out[i, j] = x[i + di, j + dj], 0 outside."""
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (1, 1, 1, 1))

    def nb(di, dj):
        return xp[..., 1 + di:1 + di + h, 1 + dj:1 + dj + w]
    return nb


def canny_nms(dx, dy, low):
    """Per-pixel NMS candidate mask (cv/canny.cpp:220-285). dx, dy:
    (..., H, W) int32 with int16-range values; low broadcasts against
    them. Returns bool. The sector products run in int64, where the
    reference's uint32 ones cannot wrap (< 2.6e9)."""
    adx, ady = dx.abs(), dy.abs()
    x = adx.to(torch.int64)
    y = ady.to(torch.int64) << CANNY_SHIFT
    m = adx + ady
    same_sign = (dx ^ dy) >= 0

    tg22x = x * TG22
    tg67x = tg22x + ((x + x) << CANNY_SHIFT)

    nb = _neighbours(m)
    diag_a = torch.where(same_sign, nb(-1, -1), nb(-1, 1))  # above, col j-s
    diag_b = torch.where(same_sign, nb(1, 1), nb(1, -1))    # below, col j+s
    keep_h = (m > nb(0, -1)) & (m >= nb(0, 1))
    keep_v = (m > nb(-1, 0)) & (m >= nb(1, 0))
    keep_d = (m > diag_a) & (m > diag_b)
    keep = torch.where(y < tg22x, keep_h,
                       torch.where(y > tg67x, keep_v, keep_d))
    return (m > low) & keep


def _dilate8(mask):
    nb = _neighbours(mask.to(torch.uint8))
    out = mask.clone()
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di or dj:
                out |= nb(di, dj).bool()
    return out


def _run_flood(edge, candidate, dim):
    """Light every candidate in any maximal candidate run along `dim` that
    holds a lit pixel, by prefix max/min scans of run breaks and seeds
    (the JAX package's _run_flood_scan). A flood along the last dim runs
    on the transposed masks: PyTorch's CUDA scan along the innermost dim
    of many short rows is ~10x slower than along an outer dim (H100,
    PERF.md)."""
    if dim == edge.dim() - 1:
        flood = _run_flood(edge.transpose(-1, -2).contiguous(),
                           candidate.transpose(-1, -2).contiguous(), dim - 1)
        return flood.transpose(-1, -2)
    n = edge.shape[dim]
    shape = [1] * edge.dim()
    shape[dim] = n
    idx = torch.arange(n, dtype=torch.int32, device=edge.device).reshape(
        shape)
    big = n + 1
    brk_f = torch.cummax(torch.where(candidate, -1, idx), dim).values
    seed_f = torch.cummax(torch.where(edge, idx, -1), dim).values
    lit_f = candidate & (seed_f > brk_f)

    def suffix_min(v):
        return torch.cummin(v.flip(dim), dim).values.flip(dim)

    brk_b = suffix_min(torch.where(candidate, big, idx))
    seed_b = suffix_min(torch.where(edge, idx, big))
    lit_b = candidate & (seed_b < brk_b)
    return edge | lit_f | lit_b


def hysteresis_bounded(candidate, strong, sweeps=DEFAULT_SWEEPS):
    """`sweeps` fixed sweeps of dilate8-and-mask, then horizontal and
    vertical run floods (canny.py:325-378 of the JAX package)."""
    edge = strong & candidate
    for _ in range(sweeps):
        edge = (_dilate8(edge) & candidate) | edge
        edge = _run_flood(edge, candidate, edge.dim() - 1)
        edge = _run_flood(edge, candidate, edge.dim() - 2)
    return edge


def canny7_precomputed_sobel(dx, dy, low, high, sweeps=DEFAULT_SWEEPS):
    """llcv_canny7_precomputed_sobel (cv/canny.cpp:327-335): the u8 edge
    map, 255 on an edge. low/high: integer thresholds broadcasting
    against dx (one per band as (B, 1, 1))."""
    m = dx.abs() + dy.abs()
    candidate = canny_nms(dx, dy, low)
    strong = candidate & (m > high)
    edge = hysteresis_bounded(candidate, strong, sweeps)
    return edge.to(torch.uint8) * 255


def adaptive_canny7(image, dx=None, dy=None, sweeps=DEFAULT_SWEEPS):
    """llcv_adaptive_canny7_precomputed_sobel (cv/canny.cpp:568-580): the
    thresholds are floor(mean) and floor(3 * mean) of |dx| + |dy| over each
    image of the batch.

    image: (..., H, W) uint8; dx/dy: its sobel7 derivatives where the
    caller has them. Returns (edges u8, dx, dy): the Hough stage takes
    dx/dy again. The mean is a quotient of tensors: a Python divisor on a
    CUDA tensor multiplies by its reciprocal, and a one-ulp change of the
    mean can move an integer threshold."""
    if dx is None:
        dx = sobel7(image, dx=True, dy=False)
    if dy is None:
        dy = sobel7(image, dx=False, dy=True)
    h, w = image.shape[-2:]
    total = (dx.abs() + dy.abs()).sum(dim=(-2, -1))
    mean = total.to(torch.float32) / torch.full(
        (), float(h * w), dtype=torch.float32, device=image.device)
    low = torch.floor(mean).to(torch.int32)[..., None, None]
    high = torch.floor(3.0 * mean).to(torch.int32)[..., None, None]
    return canny7_precomputed_sobel(dx, dy, low, high, sweeps), dx, dy


def canny7(image, low, high, sweeps=DEFAULT_SWEEPS):
    """llcv_canny7 (cv/canny.cpp:338-352): canny with the given integer
    thresholds. image: (..., H, W) uint8 -> u8 edge map."""
    dx = sobel7(image, dx=True, dy=False)
    dy = sobel7(image, dx=False, dy=True)
    return canny7_precomputed_sobel(dx, dy, int(low), int(high), sweeps)

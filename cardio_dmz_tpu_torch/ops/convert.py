"""Format conversions on the scan path (cv/convert.cpp equivalents)."""

import torch


def lineardown2_1d_u8(x):
    """2x horizontal downsample by rounding-halving pair average, the NEON
    vrhadd path (cv/convert.cpp:132-193): dst[i] = (src[2i] + src[2i+1] + 1)
    >> 1, summed in int32. x: (..., W) uint8, W even -> (..., W//2) uint8."""
    a = x[..., 0::2].to(torch.int32)
    b = x[..., 1::2].to(torch.int32)
    return ((a + b + 1) >> 1).to(torch.uint8)


def norm_convert_minmax(x, dim=-1):
    """Min-max normalize u8 -> f32 in [0, 1] along `dim`
    (cv/convert.cpp:295-378): out = (x - min) * m with m = 1/(max - min),
    or m = 0.5 when max == min. Multiplies by the reciprocal, as the
    reference does, so that the bits match."""
    xf = x.to(torch.float32)
    mn = xf.amin(dim=dim, keepdim=True)
    mx = xf.amax(dim=dim, keepdim=True)
    delta = mx - mn
    flat = delta == 0
    mult = torch.where(flat, 0.5, 1.0 / torch.where(flat, 1.0, delta))
    return (xf - mn) * mult

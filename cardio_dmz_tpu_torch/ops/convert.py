"""Format conversions on the scan path (cv/convert.cpp equivalents)."""

import torch


def split_u8(interleaved):
    """Deinterleave a 2-channel image into (even-byte, odd-byte) planes,
    llcv_split_u8's NEON path (cv/convert.cpp:19-72, vld2q_u8).
    interleaved: (..., H, 2*W) uint8 viewed as W 2-byte pixels; the planes
    are views."""
    return interleaved[..., 0::2], interleaved[..., 1::2]


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


def ycbcr_to_rgb(y, cb, cr, add_alpha=False):
    """Fixed-point YCbCr -> RGB(A), bit-exact with llcv_YCbCr2RGB_u8_c
    (cv/convert.cpp:449-504): coefficients 29049 / -5636 / -11698 / 22987,
    descale by (x + 2^13) >> 14, saturate to u8.
    y/cb/cr: (..., H, W) uint8 -> (..., H, W, 3 or 4) uint8."""
    yi = y.to(torch.int32)
    scb = cb.to(torch.int32) - 128
    scr = cr.to(torch.int32) - 128

    def descale14(v):
        return (v + (1 << 13)) >> 14

    b = yi + descale14(scb * 29049)
    g = yi + descale14(scb * -5636 + scr * -11698)
    r = yi + descale14(scr * 22987)
    rgb = torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)
    if add_alpha:
        alpha = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8,
                           device=rgb.device)
        rgb = torch.cat([rgb, alpha], dim=-1)
    return rgb


def deinterleave_rgba_to_r(rgba):
    """The R plane of interleaved RGBA bytes (dmz_deinterleave_RGBA_to_R,
    dmz.cpp:66-110). rgba: (..., 4*N) uint8 -> (..., N) uint8, a view."""
    return rgba[..., 0::4]

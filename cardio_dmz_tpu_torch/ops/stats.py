"""Histogram equalization (cv/stats.cpp:116-159)."""

import torch


def equalize_hist(x):
    """cvEqualizeHist on u8 images: 256-bin histogram -> CDF ->
    lut[v] = sat_u8(round(cdf[v] * 255/N)) in f32, lut[0] = 0; rounding is
    half to even (cvRound), as torch.round does.
    x: (..., H, W) uint8 -> same shape uint8."""
    h, w = x.shape[-2:]
    n = h * w
    flat = x.reshape(-1, n).to(torch.int64)
    hist = torch.zeros(flat.shape[0], 256, dtype=torch.int32, device=x.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    cdf = torch.cumsum(hist, dim=1).to(torch.float32)   # exact: counts <= n
    lut = torch.clamp(torch.round(cdf * (255.0 / n)), 0, 255)
    lut[:, 0] = 0
    return torch.gather(lut, 1, flat).to(torch.uint8).reshape(x.shape)

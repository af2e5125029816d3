"""Statistics on u8 images (cv/stats.cpp): focus stddev, brightness,
histogram equalization."""

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


def stddev_of_abs(x):
    """Population stddev of |x| over the last two dims
    (llcv_stddev_of_abs, cv/stats.cpp:17-111); the sum of squares uses
    x^2 == |x|^2. x: (..., H, W) int -> (...) float32. The divisor is a
    0-d tensor so that the division is a true one on a CUDA tensor too."""
    xf = x.abs().to(torch.float32)
    n = torch.full((), float(x.shape[-2] * x.shape[-1]), dtype=torch.float32,
                   device=x.device)
    mean = xf.sum(dim=(-2, -1)) / n
    sumsq = (xf * xf).sum(dim=(-2, -1))
    return torch.sqrt(sumsq / n - mean * mean)


def brightness_mean(x):
    """cvAvg over the last two dims (dmz_brightness_score_for_image,
    dmz.cpp:128-135). x: (..., H, W) uint8 -> (...) float32."""
    return x.to(torch.float32).mean(dim=(-2, -1))

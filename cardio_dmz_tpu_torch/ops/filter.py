"""Small smoothing filters: the 3x3 bilateral filter of the expiry digit
prep, and the median blur that hides digits for display.

The reference calls cvSmooth(CV_BILATERAL, 3, 3, 0.95, 2/3)
(scan/expiry_categorize.cpp:55-60; its variable names are swapped against
OpenCV's parameter order, so the effective call is bilateralFilter(d=3,
sigmaColor=0.95, sigmaSpace=2/3)).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

# effective sigmas of the reference call (expiry_categorize.cpp:56-58)
BILATERAL_SIGMA_COLOR = (3 / 2.0 - 1.0) * 0.3 + 0.8   # 0.95
BILATERAL_SIGMA_SPACE = (3 - 1) / 3.0                  # 0.6667


def bilateral3x3(img, sigma_color=BILATERAL_SIGMA_COLOR,
                 sigma_space=BILATERAL_SIGMA_SPACE):
    """3x3 bilateral filter on u8 images, reflect-101 border.

    img: (..., H, W) uint8 -> same shape uint8. Weights in OpenCV's form:
    w = exp(-0.5 (d/sigma_space)^2) * exp(-0.5 (dI/sigma_color)^2),
    normalized, center included; the quotient rounds half to even."""
    h, w = img.shape[-2:]
    x = img.reshape(-1, h, w).to(torch.float32)
    pad = F.pad(x[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]

    gauss_space = -0.5 / (sigma_space * sigma_space)
    gauss_color = -0.5 / (sigma_color * sigma_color)

    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            nb = pad[:, 1 + di:1 + di + h, 1 + dj:1 + dj + w]
            sw = math.exp((di * di + dj * dj) * gauss_space)
            d = nb - x
            wgt = torch.exp(d * d * gauss_color) * sw
            num = num + nb * wgt
            den = den + wgt
    return torch.round(num / den).to(torch.uint8).reshape(img.shape)


def median_blur(img, ksize=25):
    """Median blur (dmz_blur_card's digit blurring, dmz.cpp:499-515), on
    the host in numpy: blurring digits for display is a cosmetic step after
    the scan, not part of it. The border replicates.
    img: (H, W[, C]) uint8 numpy array -> the same shape and dtype."""
    img = np.asarray(img)
    r = ksize // 2
    img3 = img[:, :, None] if img.ndim == 2 else img
    padded = np.pad(img3, ((r, r), (r, r), (0, 0)), mode="edge")
    h, w, c = img3.shape
    windows = np.lib.stride_tricks.sliding_window_view(
        padded, (ksize, ksize), axis=(0, 1))  # (h, w, c, k, k)
    out = np.median(windows.reshape(h, w, c, -1), axis=-1).astype(img.dtype)
    return out[:, :, 0] if img.ndim == 2 else out

"""Gradient-gated single-best-line polar Hough transform (cv/hough.cpp).

Counterpart of the JAX package's ops/hough.py on batched bands. Kept from
the reference, as there:

* fixed-point sin/cos tables x1024 with floor, built on the host in f32
  with the angle summed in f32 (cv/hough.cpp:109-115);
* rho bin r = (j*tabCos + i*tabSin) >> 10, centred (cv/hough.cpp:154-156);
* the gradient gate: a pixel votes only if its dy/dx slope lies within
  +-gradient_angle_threshold of the expected edge normal
  (cv/hough.cpp:117-150);
* the argmax order: r-major, angle-minor, strict > (cv/hough.cpp:163-176).

The TPU's two-level one-hot contraction of the votes becomes a
scatter-add of each pixel's votes into a small (angle x rho bin) table.
"""

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _tables(h, w, rho, theta, theta_min, theta_max, vertical,
            gradient_angle_threshold):
    """Host-static tables for one band shape: (numangle, numrho, the vote
    slot a*numrho + r of every (pixel, angle) as (H*W*numangle,) int64,
    slope_a, slope_b)."""
    numangle = int(round((theta_max - theta_min) / theta))
    numrho = int(round(((w + h) * 2 + 1) / rho))
    irho = 1.0 / rho

    # the reference's f32 tables: sinf/cosf of an angle accumulated by f32
    # addition (cv/hough.cpp:113-115)
    ang = np.float32(theta_min)
    t32 = np.float32(theta)
    irho32 = np.float32(irho)
    tab_sin = np.empty(numangle, np.int64)
    tab_cos = np.empty(numangle, np.int64)
    for n in range(numangle):
        tab_sin[n] = np.floor(np.float32(1024.0)
                              * np.sin(ang, dtype=np.float32) * irho32)
        tab_cos[n] = np.floor(np.float32(1024.0)
                              * np.cos(ang, dtype=np.float32) * irho32)
        ang = np.float32(ang + t32)

    # gradient gate: degrees -> radians in f64, cast to f32, tan in f32
    base_deg = 180.0 if vertical else 90.0
    slope_a = np.tan(np.float32(math.radians(
        base_deg - gradient_angle_threshold)), dtype=np.float32)
    slope_b = np.tan(np.float32(math.radians(
        base_deg + gradient_angle_threshold)), dtype=np.float32)

    center = (numrho - 1) // 2
    jj = np.arange(w, dtype=np.int64)[None, :, None]
    ii = np.arange(h, dtype=np.int64)[:, None, None]
    r = ((jj * tab_cos + ii * tab_sin) >> 10) + center        # (H, W, A)
    assert r.min() >= 0 and r.max() < numrho
    slot = np.arange(numangle, dtype=np.int64) * numrho + r
    return numangle, numrho, slot.reshape(-1), float(slope_a), \
        float(slope_b)


@functools.lru_cache(maxsize=None)
def _device_tables(device, key):
    numangle, numrho, slot, _, _ = _tables(*key)
    r = torch.arange(numrho, dtype=torch.int64, device=device)
    a = torch.arange(numangle, dtype=torch.int64, device=device)
    scan_key = (r[None, :] * numangle + a[:, None]).reshape(-1)
    return torch.from_numpy(slot).to(device), scan_key


def hough_best_line(edge_mask, dx, dy, *, rho=1.0, theta=math.pi / 180.0,
                    threshold=0, theta_min=0.0, theta_max=math.pi,
                    vertical=False, gradient_angle_threshold=10.0):
    """The single best (rho, theta) line of each band, llcv_hough
    (cv/hough.cpp:52-195).

    edge_mask: (B, H, W) u8 canny output (nonzero = edge); dx, dy:
    (B, H, W) int sobel7 derivatives. Returns (is_null (B,) bool,
    rho (B,) f32, theta (B,) f32); rho and theta are 0 where is_null."""
    b, h, w = edge_mask.shape
    key = (h, w, float(rho), float(theta), float(theta_min),
           float(theta_max), bool(vertical), float(gradient_angle_threshold))
    numangle, numrho, _, slope_a, slope_b = _tables(*key)
    slot, scan_key = _device_tables(edge_mask.device, key)

    dxf, dyf = dx.to(torch.float32), dy.to(torch.float32)
    slope = dyf / torch.where(dx == 0, 1.0, dxf)
    if vertical:
        gate = (dx != 0) & (slope >= slope_a) & (slope <= slope_b)
    else:
        gate = (dx == 0) | (slope >= slope_a) | (slope <= slope_b)
    use = (edge_mask != 0) & gate                            # (B, H, W)

    votes = use.to(torch.int32).reshape(b, h * w, 1).expand(
        b, h * w, numangle).reshape(b, -1)
    counts = torch.zeros((b, numangle * numrho), dtype=torch.int32,
                         device=edge_mask.device)
    counts.scatter_add_(1, slot.expand(b, -1), votes)

    # first maximum in r-major, angle-minor order: with K above every scan
    # key, count*K - key is unique and largest there
    k = numangle * numrho
    best = torch.argmax(counts.to(torch.int64) * k - scan_key, dim=1)
    max_val = counts.gather(1, best[:, None])[:, 0]
    r_best, n_best = best % numrho, best // numrho

    is_null = max_val <= threshold
    line_rho = (r_best.to(torch.float32) - (numrho - 1) * 0.5) * rho
    line_angle = n_best.to(torch.float32) * theta + theta_min
    return is_null, torch.where(is_null, 0.0, line_rho), \
        torch.where(is_null, 0.0, line_angle)

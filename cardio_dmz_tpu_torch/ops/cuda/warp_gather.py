"""The exact card warp's gather: the CUDA kernel and its plain version.

The kernel, csrc/warp_gather.cu, replaces the Pallas TPU kernel
cardio_dmz_tpu/ops/pallas/warp_gather.py (warp_gather_exact /
_warp_gather_kernel with _chunk_qsets): cvWarpPerspective INTER_LINEAR +
FILL_OUTLIERS from quantized 1/32-px source maps X, Y (ops/persp.py
warp_coord_maps). Taps (x0, y0) .. (x0+1, y0+1) with x0 = X >> 5,
ax = X & 31 (likewise y) weigh (32-ax)(32-ay)*32 and so on, the sum is
(acc + 2^14) >> 15 saturated to u8, and a tap outside the image reads 0.

One thread per output pixel, each gathering its four taps straight from
its stream's frame. The TPU kernel's source windows, band bases and lane
slices work around Mosaic's gather limits and are not carried over. For
every quad the detector can reach the JAX package's windows cover every
tap (tests/test_warp_envelope.py), so the direct gather equals its
windowed forms there; the tests draw their quads from that envelope.

What bounds it on an H100: bytes and launch. Per stream it reads ~4 taps
per output pixel from a 307 KB frame that sits in L2 and the two int32
maps (924 KB), and writes 115 KB.

The plain version is persp_host.warp_exact's per-pixel gather, batched
over streams. A CPU tensor takes it; a CUDA tensor takes the kernel.
"""

import ctypes

import torch

from ._build import CudaKernel

KERNEL = CudaKernel("warp_gather", "warp_gather_launch",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])

# Launches of the CUDA kernel since the last reset; the plain version does
# not count.
LAUNCHES = 0

_MAX_STREAMS = 65535   # the launch grid's y dimension


def _check(image, xq, yq):
    if image.dtype != torch.uint8 or xq.dtype != torch.int32 \
            or yq.dtype != torch.int32:
        raise TypeError(f"image must be uint8 and maps int32; got "
                        f"{image.dtype}, {xq.dtype}, {yq.dtype}")
    if image.dim() != 3 or xq.dim() != 3 or xq.shape != yq.shape \
            or xq.shape[0] != image.shape[0]:
        raise ValueError(f"want image (S, H, W) and maps (S, h, w); got "
                         f"{tuple(image.shape)}, {tuple(xq.shape)}, "
                         f"{tuple(yq.shape)}")
    if not (image.device == xq.device == yq.device):
        raise ValueError(f"image on {image.device}, maps on {xq.device} and "
                         f"{yq.device}")
    if not (image.is_contiguous() and xq.is_contiguous()
            and yq.is_contiguous()):
        raise ValueError("image and maps must be contiguous")


def warp_gather_reference(image, xq, yq):
    """The plain PyTorch version. image (S, H, W) u8, xq/yq (S, h, w)
    int32 -> (S, h, w) u8."""
    s, in_h, in_w = image.shape
    flat = image.reshape(s, -1)
    x0, ax = xq >> 5, xq & 31
    y0, ay = yq >> 5, yq & 31

    def tap(yy, xx):
        valid = (xx >= 0) & (xx < in_w) & (yy >= 0) & (yy < in_h)
        idx = (yy.clamp(0, in_h - 1).to(torch.int64) * in_w
               + xx.clamp(0, in_w - 1))
        v = torch.gather(flat, 1, idx.reshape(s, -1)).reshape(xq.shape)
        return torch.where(valid, v.to(torch.int32), 0)

    acc = (tap(y0, x0) * ((32 - ax) * (32 - ay) * 32)
           + tap(y0, x0 + 1) * (ax * (32 - ay) * 32)
           + tap(y0 + 1, x0) * ((32 - ax) * ay * 32)
           + tap(y0 + 1, x0 + 1) * (ax * ay * 32))
    return ((acc + (1 << 14)) >> 15).clamp(0, 255).to(torch.uint8)


def warp_gather_exact(image, xq, yq):
    """Every stream's frame resampled at its quantized maps.

    image: (S, H, W) uint8; xq, yq: (S, h, w) int32 source positions in
    1/32 px. Returns (S, h, w) uint8. A CUDA tensor goes through the CUDA
    kernel; a CPU tensor through the plain version."""
    global LAUNCHES
    _check(image, xq, yq)
    if image.device.type == "cpu":
        return warp_gather_reference(image, xq, yq)
    if image.device.type != "cuda":
        raise ValueError(f"no warp-gather route for {image.device}")
    s, in_h, in_w = image.shape
    out = torch.empty(xq.shape, dtype=torch.uint8, device=image.device)
    n_pixels = xq.shape[1] * xq.shape[2]
    if s == 0 or n_pixels == 0:
        return out
    if s > _MAX_STREAMS:
        raise ValueError(f"at most {_MAX_STREAMS} streams a launch; got {s}")
    with torch.cuda.device(image.device):
        KERNEL.launch(image.data_ptr(), xq.data_ptr(), yq.data_ptr(),
                      out.data_ptr(), s, in_h, in_w, n_pixels,
                      torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return out

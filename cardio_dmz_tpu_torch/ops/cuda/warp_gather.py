"""The exact card warp: the CUDA kernel and its plain route.

The kernel, csrc/warp_gather.cu, replaces the Pallas TPU kernel
cardio_dmz_tpu/ops/pallas/warp_gather.py (warp_gather_exact /
_warp_gather_kernel with _chunk_qsets) and the coordinate maps that feed
it: cvWarpPerspective INTER_LINEAR + FILL_OUTLIERS from the frame and the
f32 homography. For each stream it inverts double(m) by cofactors, computes
each output pixel's quantized 1/32-px source position (X, Y) in float64 as
ops/persp.py warp_coord_maps does, and takes the four 5-bit-weighted taps:
(x0, y0) .. (x0+1, y0+1) with x0 = X >> 5, ax = X & 31 (likewise y) weigh
(32-ax)(32-ay)*32 and so on, the sum is (acc + 2^14) >> 15 saturated to u8,
and a tap outside the frame reads 0. No map goes through device memory.

The TPU kernel's source windows, band bases and lane slices work around
Mosaic's gather limits and are not carried over: one block per stream
walks its card 4 pixels a thread, reading the taps straight from the
frame. For every quad the detector can reach the JAX package's windows
cover every tap (tests/test_warp_envelope.py), so the direct gather equals
its windowed forms there; the tests draw their quads from that envelope.

What bounds it on an H100: instruction issue, mostly the integer work of
the quantization and the taps beside ~25 float64 operations a pixel (the
correctly rounded division 32 / den about 10); the bytes (the tapped frame
region and the card) would take a seventh of its time. A portrait card's
rows run down the frame, so that warp walks the card column by column.

The plain route is warp_coord_maps, then persp_host.warp_exact's per-pixel
gather batched over streams (warp_gather_reference); the kernel equals it
bit for bit, NaN homographies included. A CPU tensor takes it; a CUDA
tensor takes the kernel.
"""

import ctypes

import torch

from ..persp import warp_coord_maps
from ._build import CudaKernel, counted_launch

KERNEL = CudaKernel("warp_gather", "warp_exact_launch",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p], flags=("--fmad=false",))

# Launches of the CUDA kernel since the last reset; the plain route does not
# count.
LAUNCHES = 0

_MAX_STREAMS = 65535   # the launch grid's y dimension
# float64 operations per output pixel: three linear forms (a x + b y) + c at
# 2 multiplies and 2 adds each, 32 / den, and the two products num * W
F64_PER_PIXEL = 15
# per stream: 18 multiplies and 9 subtractions of the cofactors, 3 + 2 of
# the determinant, 1 / det, 9 products
F64_PER_STREAM = 42


def _check(image, m, out_shape, transpose):
    if image.dtype != torch.uint8 or m.dtype != torch.float32:
        raise TypeError(f"image must be uint8 and homographies float32; got "
                        f"{image.dtype} and {m.dtype}")
    if not isinstance(transpose, bool):
        raise TypeError(f"transpose must be a bool; got {transpose!r}")
    if image.dim() != 3 or m.shape != (image.shape[0], 3, 3):
        raise ValueError(f"want image (S, H, W) and homographies (S, 3, 3); "
                         f"got {tuple(image.shape)} and {tuple(m.shape)}")
    if (len(out_shape) != 2
            or not all(isinstance(n, int) and n > 0 for n in out_shape)):
        raise ValueError(f"want out_shape (h, w) of positive ints; got "
                         f"{out_shape!r}")
    if image.device != m.device:
        raise ValueError(f"image on {image.device}, homographies on "
                         f"{m.device}")
    if not (image.is_contiguous() and m.is_contiguous()):
        raise ValueError("image and homographies must be contiguous")


def tapped_pixels(image, m, out_shape, transpose=False):
    """How many frame pixels the warp's taps read, over all streams."""
    s, in_h, in_w = image.shape
    xq, yq = warp_coord_maps(m, out_shape)
    if transpose:
        xq, yq = yq, xq
    x0, y0 = (xq >> 5).reshape(s, -1), (yq >> 5).reshape(s, -1)
    read = torch.zeros((s, in_h * in_w + 1), dtype=torch.bool,
                       device=m.device)
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = x0 + dx, y0 + dy
            inside = (x >= 0) & (x < in_w) & (y >= 0) & (y < in_h)
            # taps outside the frame land on the spare last column
            idx = torch.where(inside, y * in_w + x, in_h * in_w)
            read.scatter_(1, idx.to(torch.int64), True)
    return int(read[:, :-1].sum())


def work(image, m_src_to_dst, out_shape, transpose=False):
    """(flops, bytes, kind) of one launch on these inputs: the frame pixels
    its taps read, the homographies and the card written; the float64
    operations of the maps."""
    s = image.shape[0]
    pixels = s * out_shape[0] * out_shape[1]
    return (pixels * F64_PER_PIXEL + s * F64_PER_STREAM,
            tapped_pixels(image, m_src_to_dst, out_shape, transpose)
            + m_src_to_dst.numel() * 4 + pixels, "f64")


def warp_gather_reference(image, xq, yq):
    """The plain gather: image (S, H, W) u8 resampled at quantized maps
    xq/yq (S, h, w) int32 -> (S, h, w) u8."""
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


def warp_perspective_reference(image, m_src_to_dst, out_shape,
                               transpose=False):
    """The plain route: the float64 maps, then the gather; transpose=True
    resamples the transposed frame with the maps swapped, as the JAX
    package does."""
    xq, yq = warp_coord_maps(m_src_to_dst, out_shape)
    if transpose:
        image, xq, yq = image.transpose(-1, -2), yq, xq
    return warp_gather_reference(image, xq, yq)


def warp_perspective_exact(image, m_src_to_dst, out_shape, transpose=False):
    """cvWarpPerspective INTER_LINEAR + FILL_OUTLIERS, exactly.

    image: (S, H, W) uint8 frames; m_src_to_dst: (S, 3, 3) float32 forward
    homographies; out_shape: (h, w). transpose=True (portrait orientations)
    resamples the transposed frame with X and Y swapped, as the JAX package
    does; img.T(X, Y) == img(Y, X), so the card is the same. Returns (S, h,
    w) uint8. A CUDA tensor goes through the CUDA kernel, which computes
    the maps itself and reads the untransposed frame; a CPU tensor through
    the plain route."""
    global LAUNCHES
    _check(image, m_src_to_dst, out_shape, transpose)
    with counted_launch("warp_gather", work, image, m_src_to_dst, out_shape,
                        transpose):
        if image.device.type == "cpu":
            return warp_perspective_reference(image, m_src_to_dst, out_shape,
                                              transpose)
        if image.device.type != "cuda":
            raise ValueError(f"no warp route for {image.device}")
        s, in_h, in_w = image.shape
        out_h, out_w = out_shape
        out = torch.empty((s, out_h, out_w), dtype=torch.uint8,
                          device=image.device)
        if s == 0:
            return out
        if s > _MAX_STREAMS:
            raise ValueError(f"at most {_MAX_STREAMS} streams a launch; "
                             f"got {s}")
        if in_h * in_w >= 2**31:
            raise ValueError(f"a frame must hold fewer than 2^31 pixels; got "
                             f"{in_h}x{in_w}")
        with torch.cuda.device(image.device):
            KERNEL.launch(image.data_ptr(), m_src_to_dst.data_ptr(),
                          out.data_ptr(), s, in_h, in_w, out_h, out_w,
                          int(transpose),
                          torch.cuda.current_stream().cuda_stream)
        LAUNCHES += 1
        return out

"""PAN digit-cell preparation: the CUDA kernel and its plain version.

The kernel, csrc/digit_prep.cu, replaces the Pallas TPU kernel
cardio_dmz_tpu/ops/pallas/digit_prep.py (prepare_digit_cells_pallas /
_digit_prep_kernel): for every stream and each of its 16 hseg offsets it
crops a 27x19 cell from the 27x428 PAN strip, takes the cross morph
gradient clamped at the cell border, histogram-equalizes it and divides by
255. One thread block per stream, with the strip in shared memory, and one
warp per cell, with its own histogram and an in-warp prefix sum.

What bounds it on an H100: bytes. At 256 streams it reads ~2.1 MB of the
strips (the columns its cells cover) and writes 8.4 MB of f32 cells,
~3.1 us at 3.35 TB/s. Fusing the output into the first conv GEMM is later
work.

On the serving path on a GPU this kernel is the route for CUDA tensors.
(On the TPU the JAX package keeps its kernel off for serving, because its
grid runs serially per stream under vmap; blocks on a GPU run in
parallel.)

The library is built on first use with nvcc, from csrc/ only, into
cardio_dmz_tpu_torch/_build/, and bound with ctypes (ops/cuda/_build.py).
"""

import ctypes

import torch

from ...constants import CARD_WIDTH, NUMBER_HEIGHT, NUMBER_WIDTH
from ..morph import morph_grad3_2d_cross_u8
from ..stats import equalize_hist
from ._build import CudaKernel, counted_launch

N_CELLS = 16

KERNEL = CudaKernel("digit_prep", "digit_prep_launch",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])

# Launches of the CUDA kernel since the last reset; the plain version does
# not count.
LAUNCHES = 0


def _check(strip, offsets):
    if strip.dtype != torch.uint8 or offsets.dtype != torch.int32:
        raise TypeError(f"strip must be uint8 and offsets int32; got "
                        f"{strip.dtype} and {offsets.dtype}")
    s = strip.shape[0]
    if (strip.shape != (s, NUMBER_HEIGHT, CARD_WIDTH)
            or offsets.shape != (s, N_CELLS)):
        raise ValueError(f"want strip (S, 27, 428) and offsets (S, 16); got "
                         f"{tuple(strip.shape)} and {tuple(offsets.shape)}")
    if strip.device != offsets.device:
        raise ValueError(f"strip on {strip.device}, offsets on "
                         f"{offsets.device}")
    if not (strip.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("strip and offsets must be contiguous")


def work(strip, offsets):
    """(flops, bytes, kind) of one launch on these inputs: the bytes it must
    move (the strip columns some cell covers, 27 rows each, the offsets and
    the f32 cells written) and its one f32 division a cell pixel."""
    s = offsets.shape[0]
    cols = (offsets.to(torch.int64).clamp(0, CARD_WIDTH - NUMBER_WIDTH)[
        :, :, None] + torch.arange(NUMBER_WIDTH, device=offsets.device)
            ).reshape(s, -1)
    covered = torch.zeros((s, CARD_WIDTH), dtype=torch.bool,
                          device=offsets.device)
    covered.scatter_(1, cols, True)
    cells = s * N_CELLS * NUMBER_HEIGHT * NUMBER_WIDTH
    return (cells, int(covered.sum()) * NUMBER_HEIGHT + offsets.numel() * 4
            + cells * 4, "f32")


def prepare_cells(cells):
    """morph grad -> equalize -> [0, 1] f32 (n_categorize.cpp:96-99).
    cells: (..., 27, 19) u8 -> same shape f32."""
    eq = equalize_hist(morph_grad3_2d_cross_u8(cells)).to(torch.float32)
    # A true division, as the kernel and the JAX package divide: torch
    # multiplies by the reciprocal when the divisor is a Python number on a
    # CUDA tensor, which can differ in the last bit. torch.full fills the
    # divisor on the device (no copy from the host), so a CUDA graph can
    # capture this version.
    return eq / torch.full((), 255.0, device=eq.device)


def prepare_digit_cells_reference(strip, offsets):
    """The plain PyTorch version: gather the 16 cells at their offsets
    (clipped to [0, 409]), then prepare_cells.
    strip: (S, 27, 428) u8; offsets: (S, 16) int32 -> (S, 16, 27, 19) f32."""
    off = offsets.to(torch.int64).clamp(0, CARD_WIDTH - NUMBER_WIDTH)
    cols = off[:, :, None] + torch.arange(NUMBER_WIDTH, device=strip.device)
    s = strip.shape[0]
    cells = torch.gather(
        strip[:, None].expand(s, N_CELLS, NUMBER_HEIGHT, CARD_WIDTH), 3,
        cols[:, :, None, :].expand(s, N_CELLS, NUMBER_HEIGHT, NUMBER_WIDTH))
    return prepare_cells(cells)


def prepare_digit_cells(strip, offsets):
    """All 16 digit cells of every stream, cropped and prepared.

    strip: (S, 27, 428) uint8; offsets: (S, 16) int32 cell left edges.
    Returns (S, 16, 27, 19) float32. A CUDA tensor goes through the CUDA
    kernel; a CPU tensor through the plain version."""
    global LAUNCHES
    _check(strip, offsets)
    with counted_launch("digit_prep", work, strip, offsets):
        if strip.device.type == "cpu":
            return prepare_digit_cells_reference(strip, offsets)
        if strip.device.type != "cuda":
            raise ValueError(f"no digit-prep route for {strip.device}")
        s = strip.shape[0]
        out = torch.empty((s, N_CELLS, NUMBER_HEIGHT, NUMBER_WIDTH),
                          dtype=torch.float32, device=strip.device)
        if s == 0:
            return out
        with torch.cuda.device(strip.device):
            KERNEL.launch(strip.data_ptr(), offsets.data_ptr(),
                          out.data_ptr(), s,
                          torch.cuda.current_stream().cuda_stream)
        LAUNCHES += 1
        return out

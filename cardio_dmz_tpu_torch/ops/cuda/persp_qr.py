"""The card homography: the CUDA kernel and its plain version.

The kernel, csrc/persp_qr.cu, replaces the Pallas TPU kernel
cardio_dmz_tpu/ops/pallas/persp_qr.py (eigen_persp_transform_batched /
_qr_kernel / _qr_solve_lanes): for every stream, the 8x8 system of
llcv_calc_persp_transform (cv/warp.cpp:34-125) from its four source
corners to four destination corners (the card's, shared by every stream,
or a set per stream as the TPU kernel takes them), solved as Eigen 3.2's
f32 HouseholderQR does it, op for op. The f32 sequence is the numpy twin
cardio_dmz_tpu/ops/persp_host.py's.

What bounds it on an H100: the solve's chain of dependent operations
(each Householder step's norm, square root, divisions and next-column
update, then eight divisions of the back-substitution), not bytes. So the
kernel gives each stream a group of 16 lanes, lane j < 8 holding column j
of the system and lane 8 its right-hand side: a step's rank-1 update runs
on every trailing column at once, each lane summing its own dot products
in Eigen's order, and a step's divisions run one a lane, side by side, so
that only the chain stays serial. Two streams a warp and four warps a
block spread 256 streams over 32 SMs. The TPU kernel rebuilt
correctly rounded division and square root by a Markstein correction;
CUDA's __fdiv_rn/__fsqrt_rn are IEEE, and the library is built with
--fmad=false so that no multiply and add fuse into an FMA.

The plain version runs the same sequence batched over streams, each f32
op its own PyTorch op (the square root taken in float64 and rounded, so
that it is correctly rounded on the CPU too). A CPU tensor takes it; a
CUDA tensor takes the kernel.
"""

import ctypes

import torch

from ._build import CudaKernel

KERNEL = CudaKernel("persp_qr", "persp_qr_launch",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p],
                    flags=("--fmad=false",))

# Launches of the CUDA kernel since the last reset; the plain version does
# not count.
LAUNCHES = 0


def _check(src, dst):
    if src.dtype != torch.float32 or dst.dtype != torch.float32:
        raise TypeError(f"corners must be float32; got {src.dtype} and "
                        f"{dst.dtype}")
    if (src.dim() != 3 or src.shape[1:] != (4, 2)
            or dst.shape not in ((4, 2), (src.shape[0], 4, 2))):
        raise ValueError(f"want source (S, 4, 2) and dest (4, 2) or (S, 4, "
                         f"2); got {tuple(src.shape)} and {tuple(dst.shape)}")
    if src.device != dst.device:
        raise ValueError(f"source on {src.device}, dest on {dst.device}")
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("source and dest corners must be contiguous")


def _redux(p):
    """Eigen's packet sum over dim 1 of p (S, n, ...): n < 4 serially,
    else (p0 + p2) + (p1 + p3) and then a serial tail."""
    n = p.shape[1]
    if n < 4:
        r = p[:, 0]
        for i in range(1, n):
            r = r + p[:, i]
        return r
    r = (p[:, 0] + p[:, 2]) + (p[:, 1] + p[:, 3])
    for i in range(4, n):
        r = r + p[:, i]
    return r


def _sqrt(x):
    """Correctly rounded f32 square root: the square root of the f32 value
    in float64, rounded to f32. PyTorch's f32 sqrt on the CPU is not
    correctly rounded (one ulp off for 0.7% of random inputs)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def persp_transform_reference(src, dst):
    """The plain PyTorch version: persp_host.persp_transform batched over
    streams. src (S, 4, 2) f32, dst (4, 2) or (S, 4, 2) f32 -> (S, 3, 3)
    f32."""
    s = src.shape[0]
    dst = dst.expand(s, 4, 2)
    sx, sy = src[:, :, 0], src[:, :, 1]                    # (S, 4)
    dx, dy = dst[:, :, 0], dst[:, :, 1]
    zero, one = torch.zeros_like(sx), torch.ones_like(sx)
    top = torch.stack([sx, sy, one, zero, zero, zero, (-sx) * dx,
                       (-sy) * dx], dim=2)
    bot = torch.stack([zero, zero, zero, sx, sy, one, (-sx) * dy,
                       (-sy) * dy], dim=2)
    a = torch.cat([top, bot], dim=1)                       # (S, 8, 8)
    c = torch.cat([dx, dy], dim=1)                         # (S, 8)

    taus = []
    for k in range(8):
        c0 = a[:, k, k]
        tail = a[:, k + 1:, k]
        tsq = _redux(tail * tail) if k < 7 else torch.zeros_like(c0)
        degenerate = tsq == 0
        beta_n = _sqrt(c0 * c0 + tsq)
        beta_n = torch.where(c0 >= 0, -beta_n, beta_n)
        tau = torch.where(degenerate, 0.0, (beta_n - c0) / beta_n)
        ess = torch.where(degenerate[:, None], tail * 0,
                          tail / (c0 - beta_n)[:, None])
        a[:, k, k] = torch.where(degenerate, c0, beta_n)
        a[:, k + 1:, k] = ess
        if k < 7:
            bottom = a[:, k + 1:, k + 1:]
            tmp = _redux(ess[:, :, None] * bottom) + a[:, k, k + 1:]
            a[:, k, k + 1:] = a[:, k, k + 1:] - tau[:, None] * tmp
            scaled = tau[:, None] * ess
            a[:, k + 1:, k + 1:] = bottom - scaled[:, :, None] * tmp[:, None]
        taus.append(tau)

    for k in range(8):
        if k == 7:
            c[:, 7] = c[:, 7] * (1 - taus[7])
        else:
            ess = a[:, k + 1:, k]
            t = _redux(ess * c[:, k + 1:]) + c[:, k]
            c[:, k] = c[:, k] - taus[k] * t
            c[:, k + 1:] = c[:, k + 1:] - (taus[k][:, None] * ess) * t[:, None]
    for j in range(7, -1, -1):
        c[:, j] = c[:, j] / a[:, j, j]
        if j:
            c[:, :j] = c[:, :j] - c[:, j:j + 1] * a[:, :j, j]
    return torch.cat([c, torch.ones_like(c[:, :1])], dim=1).reshape(s, 3, 3)


def eigen_persp_transform_batched(src, dst):
    """Every stream's src -> dst homography.

    src: (S, 4, 2) float32 source corners (x, y); dst: float32
    destination corners, (4, 2) for every stream or (S, 4, 2), one set a
    stream. Returns (S, 3, 3) float32, row-major, m22 = 1.
    A CUDA tensor goes through the CUDA kernel; a CPU tensor through the
    plain version."""
    global LAUNCHES
    _check(src, dst)
    if src.device.type == "cpu":
        return persp_transform_reference(src, dst)
    if src.device.type != "cuda":
        raise ValueError(f"no persp-QR route for {src.device}")
    s = src.shape[0]
    out = torch.empty((s, 3, 3), dtype=torch.float32, device=src.device)
    if s == 0:
        return out
    with torch.cuda.device(src.device):
        KERNEL.launch(src.data_ptr(), dst.data_ptr(), out.data_ptr(), s,
                      0 if dst.dim() == 2 else 8,
                      torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return out

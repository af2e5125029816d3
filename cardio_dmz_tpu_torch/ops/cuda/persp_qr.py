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

from ._build import CudaKernel, counted_launch

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


def persp_qr_ops(cycles=None):
    """A model of one stream's solve in Eigen 3.2's f32 order (the order
    that csrc/persp_qr.cu and persp_transform_reference keep, whichever
    lane does an operation), on a system with no degenerate step:
    (operations, chain, on_chain); tests/test_torch_warp.py holds its
    count against a closed form. operations counts every multiply, add,
    divide and square root; chain is the longest run of them each of
    which waits for the one before,
    each kind weighted by cycles[kind] ("add" for adds and subtractions,
    "mul", "div", "sqrt"; 1 each by default, which counts operations), so
    that no bit-exact order of this solve can finish sooner; on_chain
    counts each kind on that run."""
    cycles = cycles or {"add": 1, "mul": 1, "div": 1, "sqrt": 1}
    n_ops = [0]
    leaf = (0, {})

    def op(kind, *args):       # a value is (chain cycles, kinds on it)
        n_ops[0] += 1
        length, kinds = max(args, key=lambda v: v[0])
        return length + cycles[kind], {**kinds, kind: kinds.get(kind, 0) + 1}

    def mul(x, y):
        return op("mul", x, y)

    def add(x, y):
        return op("add", x, y)

    def redux(p):
        if len(p) < 4:
            r = p[0]
        else:
            r, p = add(add(p[0], p[2]), add(p[1], p[3])), p[3:]
        for v in p[1:]:
            r = add(r, v)
        return r

    n = 8
    a = [[leaf] * n for _ in range(n)]
    c = [leaf] * n
    for i in range(n):
        a[i][6], a[i][7] = mul(leaf, leaf), mul(leaf, leaf)
    taus = []
    for k in range(n - 1):      # the last step is degenerate: tau 0
        nt = n - 1 - k
        c0 = a[k][k]
        tsq = redux([mul(a[i][k], a[i][k]) for i in range(k + 1, n)])
        beta = op("sqrt", add(mul(c0, c0), tsq))
        d = add(c0, beta)
        ess = [op("div", a[i][k], d) for i in range(k + 1, n)]
        tau = op("div", add(beta, c0), beta)
        taus.append((tau, ess))
        a[k][k] = beta
        scaled = [mul(tau, e) for e in ess]
        for j in range(k + 1, n):
            tmp = add(redux([mul(ess[i], a[k + 1 + i][j])
                             for i in range(nt)]), a[k][j])
            a[k][j] = add(a[k][j], mul(tau, tmp))
            for i in range(nt):
                a[k + 1 + i][j] = add(a[k + 1 + i][j], mul(scaled[i], tmp))
    for k, (tau, ess) in enumerate(taus):              # c = Q^T b
        t = add(redux([mul(ess[i], c[k + 1 + i])
                       for i in range(len(ess))]), c[k])
        c[k] = add(c[k], mul(tau, t))
        for i in range(len(ess)):
            c[k + 1 + i] = add(c[k + 1 + i], mul(mul(tau, ess[i]), t))
    c[n - 1] = mul(c[n - 1], add(leaf, leaf))          # H_7: 1 - tau
    for j in range(n - 1, -1, -1):                     # back-substitution
        c[j] = op("div", c[j], a[j][j])
        for i in range(j):
            c[i] = add(c[i], mul(c[j], a[i][j]))
    chain, on_chain = max(c, key=lambda v: v[0])
    return n_ops[0], chain, on_chain


def work(src, dst):
    """(flops, bytes, kind) of one launch on these inputs: the corners read,
    the homographies written; persp_qr_ops' f32 operations a stream."""
    s = src.shape[0]
    return (s * persp_qr_ops()[0],
            src.numel() * 4 + dst.numel() * 4 + s * 9 * 4, "f32")


def eigen_persp_transform_batched(src, dst):
    """Every stream's src -> dst homography.

    src: (S, 4, 2) float32 source corners (x, y); dst: float32
    destination corners, (4, 2) for every stream or (S, 4, 2), one set a
    stream. Returns (S, 3, 3) float32, row-major, m22 = 1.
    A CUDA tensor goes through the CUDA kernel; a CPU tensor through the
    plain version."""
    global LAUNCHES
    _check(src, dst)
    with counted_launch("persp_qr", work, src, dst):
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

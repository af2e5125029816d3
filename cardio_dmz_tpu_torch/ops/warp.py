"""Perspective rectification (cv/warp.cpp equivalents).

Counterpart of the JAX package's ops/warp.py, two of its methods:

* "exact", the camera serving default: the Eigen-f32-QR homography
  (ops/persp.py) and cvWarpPerspective's quantized float64 coordinate maps
  with its 5-bit fixed-point bilinear gather, in one step
  (ops/cuda/warp_gather.py: the CUDA kernel, which computes the maps
  itself, for CUDA tensors; the plain route, ops/persp.py
  warp_coord_maps and then the gather, for CPU tensors). Bit for bit the
  reference chain.
* "gather", the per-pixel oracle: calc_persp_transform (the 8x8 a/b
  system through torch.linalg.solve_ex) and warp_perspective (f32
  coordinates; the fixed-point bilinear for integer images, the float
  bilinear for float ones). Torch ops on the inputs' device: it makes
  test inputs (tools/accuracy_sweep.py places cards in previews with it)
  and is no serving route. Its homography and pixels are not the JAX
  package's bits: another LU, inverse and order of sums flip a few 1/32
  coordinate bins.

The JAX package's "dense" method and its bf16 warp are not ported.
"""

import functools

import torch

from ..constants import CARD_HEIGHT, CARD_WIDTH
from .cuda.warp_gather import warp_perspective_exact
from .persp import eigen_persp_transform


def calc_persp_transform(source_points, dest_points):
    """Solve for the 3x3 homographies H mapping source -> dest.

    source_points/dest_points: (..., 4, 2) of (x, y), broadcast against
    each other. Mirrors llcv_calc_persp_transform's a/b setup
    (cv/warp.cpp:46-67); the 8x8 system is solved in float32 by
    torch.linalg.solve_ex: the LU of torch.linalg.solve, bit for bit,
    without its check, which reads the LU's info back to the host to raise
    on a singular matrix (a read a CUDA graph cannot hold); a singular
    system gives inf or NaN entries, as jnp.linalg.solve does. Returns
    (..., 3, 3) float32 on source_points' device."""
    sp = torch.as_tensor(source_points, dtype=torch.float32)
    dp = torch.as_tensor(dest_points, dtype=torch.float32, device=sp.device)
    sp, dp = torch.broadcast_tensors(sp, dp)
    sx, sy = sp[..., 0], sp[..., 1]
    dx, dy = dp[..., 0], dp[..., 1]
    zeros = torch.zeros_like(sx)
    ones = torch.ones_like(sx)
    top = torch.stack([sx, sy, ones, zeros, zeros, zeros, -sx * dx,
                       -sy * dx], dim=-1)
    bot = torch.stack([zeros, zeros, zeros, sx, sy, ones, -sx * dy,
                       -sy * dy], dim=-1)
    a = torch.cat([top, bot], dim=-2)
    b = torch.cat([dx, dy], dim=-1)
    x, _ = torch.linalg.solve_ex(a, b)
    h = torch.cat([x, ones[..., :1]], dim=-1)
    return h.reshape(*x.shape[:-1], 3, 3)


def warp_perspective(image, h_matrix, out_shape, fill_value=0.0,
                     fixed_point=True):
    """dst(p) = src(H^-1 p) with bilinear sampling, fill_value outside.

    image: (..., H, W) u8 or float; h_matrix: (3, 3), or (..., 3, 3) with
    the image's leading shape, mapping src -> dst coordinates; out_shape:
    (out_h, out_w). Runs on the image's device.

    fixed_point=True (integer images) follows cvWarpPerspective's
    INTER_LINEAR scheme: source coordinates quantized to 1/32 px
    (INTER_BITS=5, round half to even), integer tap weights, accumulation
    in int32, then (acc + 2^14) >> 15 with u8 saturation. Otherwise (and
    for float images) float bilinear weights, rounded back for integer
    images."""
    out_h, out_w = out_shape
    dev = image.device
    h = torch.as_tensor(h_matrix, dtype=torch.float32, device=dev)
    # inv_ex: torch.linalg.inv's bits without its check, which reads the
    # LU's info back to the host (a read a CUDA graph cannot hold)
    hinv, _ = torch.linalg.inv_ex(h)
    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float32,
                                         device=dev),
                            torch.arange(out_w, dtype=torch.float32,
                                         device=dev), indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, -1)
    src = torch.matmul(hinv, grid)                      # (..., 3, P)
    sx = src[..., 0, :] / src[..., 2, :]
    sy = src[..., 1, :] / src[..., 2, :]

    lead = image.shape[:-2]
    in_h, in_w = image.shape[-2], image.shape[-1]
    flat = image.reshape(-1, in_h * in_w)

    def sample(yi, xi):
        """(B, P) float32 taps of the flat images at rows yi, columns xi
        ((P,) or (B, P)); fill_value outside."""
        valid = (xi >= 0) & (xi < in_w) & (yi >= 0) & (yi < in_h)
        idx = (yi.clamp(0, in_h - 1) * in_w + xi.clamp(0, in_w - 1)).reshape(
            -1, out_h * out_w).to(torch.int64)
        vals = torch.gather(flat, 1, idx.expand(flat.shape[0], -1))
        return torch.where(valid.reshape(-1, out_h * out_w),
                           vals.to(torch.float32), fill_value)

    integer = not torch.is_floating_point(image)
    if fixed_point and integer:
        sxq = torch.round(sx * 32.0).to(torch.int32)    # cvRound(fX*32)
        syq = torch.round(sy * 32.0).to(torch.int32)
        x0i, y0i = sxq >> 5, syq >> 5
        ax, ay = sxq & 31, syq & 31
        v00 = sample(y0i, x0i).to(torch.int32)
        v01 = sample(y0i, x0i + 1).to(torch.int32)
        v10 = sample(y0i + 1, x0i).to(torch.int32)
        v11 = sample(y0i + 1, x0i + 1).to(torch.int32)
        acc = (v00 * ((32 - ax) * (32 - ay) * 32)
               + v01 * (ax * (32 - ay) * 32)
               + v10 * ((32 - ax) * ay * 32)
               + v11 * (ax * ay * 32))
        out = torch.clamp((acc + (1 << 14)) >> 15, 0, 255)
        return out.to(image.dtype).reshape(*lead, out_h, out_w)

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    v00 = sample(y0i, x0i)
    v01 = sample(y0i, x0i + 1)
    v10 = sample(y0i + 1, x0i)
    v11 = sample(y0i + 1, x0i + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    if integer:
        out = torch.round(out).to(image.dtype)
    return out.reshape(*lead, out_h, out_w)


@functools.lru_cache(maxsize=None)
def _dest_points(out_shape, device):
    """The card's corners tl, tr, bl, br: the rect (0, 0, W-1, H-1)
    (dmz.cpp:484), kept on `device`."""
    out_h, out_w = out_shape
    return torch.tensor([[0.0, 0.0], [out_w - 1.0, 0.0],
                         [0.0, out_h - 1.0], [out_w - 1.0, out_h - 1.0]],
                        dtype=torch.float32, device=device)


def unwarp_card(image, source_points, out_shape=(CARD_HEIGHT, CARD_WIDTH),
                transpose=False, method="exact"):
    """llcv_unwarp (cv/warp.cpp:130-169): rectify each stream's quad (tl,
    tr, bl, br) to a 428x270 card. image: (S, H, W) u8; source_points:
    (S, 4, 2) f32. method="exact" (the serving route) or "gather" (the
    oracle: calc_persp_transform and warp_perspective); transpose (the
    portrait orientations, source_points in the transposed frame) is the
    exact method's."""
    dest = _dest_points(tuple(out_shape), image.device)
    if method == "gather":
        if transpose:
            raise ValueError("transpose is the exact method's")
        return warp_perspective(image, calc_persp_transform(
            source_points, dest), tuple(out_shape))
    if method != "exact":
        raise ValueError(f"unknown warp method {method!r}; the port has "
                         f"'exact' and 'gather'")
    m = eigen_persp_transform(source_points, dest)
    return warp_perspective_exact(image.contiguous(), m, tuple(out_shape),
                                  transpose=transpose)

"""Reference-exact perspective math: the homography and cvWarpPerspective's
coordinate maps.

Counterpart of the JAX package's ops/persp.py. The homography is Eigen
3.2's f32 HouseholderQR solve of llcv_calc_persp_transform, op for op
(ops/cuda/persp_qr.py: the CUDA kernel for CUDA tensors, its plain version
for CPU tensors). The maps are computed in native float64, as
cvWarpPerspective computes them; the JAX package emulates that double
math in double-float arithmetic for the TPU, which the port does not
need. On the card the warp kernel computes the maps itself
(ops/cuda/warp_gather.py); warp_coord_maps is its plain route's first half
and the CPU route.
"""

import torch

from .cuda.persp_qr import eigen_persp_transform_batched

_MAP_LIMIT = 2.0**31 - 256
_NAN_MAP = -2**31   # cvRound(NaN) on x86


def eigen_persp_transform(source_points, dest_points):
    """Every stream's src -> dst homography, llcv_calc_persp_transform
    (cv/warp.cpp:34-125). source_points: (S, 4, 2) f32; dest_points:
    (4, 2) f32, shared by every stream, or (S, 4, 2), a set a stream, as
    the JAX package's batched form takes them. Returns (S, 3, 3) f32,
    row-major, m22 = 1."""
    return eigen_persp_transform_batched(source_points.contiguous(),
                                         dest_points.contiguous())


def _inverse3x3(m):
    """The inverse of each (3, 3) float64 matrix by its cofactors times
    1/det: elementwise ops only, so the CPU and the card agree bit for
    bit. m: (S, 3, 3) -> (S, 3, 3)."""
    e = [[m[:, r, c] for c in range(3)] for r in range(3)]

    def cof(r1, r2, c1, c2):
        return e[r1][c1] * e[r2][c2] - e[r1][c2] * e[r2][c1]

    c00, c01, c02 = cof(1, 2, 1, 2), cof(1, 2, 2, 0), cof(1, 2, 0, 1)
    det = e[0][0] * c00 + e[0][1] * c01 + e[0][2] * c02
    d = torch.ones_like(det) / det
    inv = [[c00, cof(0, 2, 2, 1), cof(0, 1, 1, 2)],
           [c01, cof(0, 2, 0, 2), cof(0, 1, 2, 0)],
           [c02, cof(0, 2, 1, 0), cof(0, 1, 0, 1)]]
    return torch.stack([torch.stack([v * d for v in row], dim=1)
                        for row in inv], dim=1)


def warp_coord_maps(m, out_shape):
    """cvWarpPerspective's per-pixel quantized source maps: M =
    inv(double(m)); den = M20 x + M21 y + M22; W = 32/den, or 0 where
    den == 0; X = round(num_x * W) after a clip to +-(2^31 - 256), half to
    even as cvRound. A NaN coordinate (from a NaN homography, where no
    card was found) becomes INT32_MIN, as cvRound gives it on x86 and
    persp_host does: every tap then lies outside the frame and the card is
    0, as the reference's and the JAX package's are.

    m: (S, 3, 3) f32 src -> dst homographies. Returns X, Y: (S, out_h,
    out_w) int32 source positions in 1/32 px."""
    out_h, out_w = out_shape
    minv = _inverse3x3(m.to(torch.float64))
    xs = torch.arange(out_w, dtype=torch.float64, device=m.device)[None, None]
    ys = torch.arange(out_h, dtype=torch.float64,
                      device=m.device)[None, :, None]

    def linform(r):
        return (minv[:, r, 0, None, None] * xs + minv[:, r, 1, None, None]
                * ys) + minv[:, r, 2, None, None]

    den = linform(2)
    w = torch.where(den != 0, torch.full_like(den, 32.0) / den, 0.0)

    def quantize(num):
        f = num * w
        nan = torch.isnan(f)
        q = torch.round(torch.where(nan, 0.0, f).clamp(-_MAP_LIMIT,
                                                       _MAP_LIMIT))
        return torch.where(nan, _NAN_MAP, q.to(torch.int32))

    return quantize(linform(0)), quantize(linform(1))

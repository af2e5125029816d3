"""Perspective rectification, the exact form (cv/warp.cpp equivalents).

Counterpart of the JAX package's ops/warp.py for method="exact", the
camera serving default: the Eigen-f32-QR homography (ops/persp.py) and
cvWarpPerspective's quantized float64 coordinate maps with its 5-bit
fixed-point bilinear gather, in one step (ops/cuda/warp_gather.py: the
CUDA kernel, which computes the maps itself, for CUDA tensors; the plain
route, ops/persp.py warp_coord_maps and then the gather, for CPU
tensors). Bit for bit the reference chain. The JAX package's "dense" and
"gather" methods and its bf16 warp are not ported.
"""

import functools

import torch

from ..constants import CARD_HEIGHT, CARD_WIDTH
from .cuda.warp_gather import warp_perspective_exact
from .persp import eigen_persp_transform


@functools.lru_cache(maxsize=None)
def _dest_points(out_shape, device):
    """The card's corners tl, tr, bl, br: the rect (0, 0, W-1, H-1)
    (dmz.cpp:484), kept on `device`."""
    out_h, out_w = out_shape
    return torch.tensor([[0.0, 0.0], [out_w - 1.0, 0.0],
                         [0.0, out_h - 1.0], [out_w - 1.0, out_h - 1.0]],
                        dtype=torch.float32, device=device)


def unwarp_card(image, source_points, out_shape=(CARD_HEIGHT, CARD_WIDTH),
                transpose=False):
    """llcv_unwarp (cv/warp.cpp:130-169), the exact method: rectify each
    stream's quad (tl, tr, bl, br) to a 428x270 card. image: (S, H, W) u8;
    source_points: (S, 4, 2) f32."""
    dest = _dest_points(tuple(out_shape), image.device)
    m = eigen_persp_transform(source_points, dest)
    return warp_perspective_exact(image.contiguous(), m, tuple(out_shape),
                                  transpose=transpose)

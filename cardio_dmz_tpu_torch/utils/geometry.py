"""Parametric (rho, theta) line geometry (geometry.h / geometry.cpp).

Counterpart of the JAX package's utils/geometry.py. Lines are (rho, theta)
pairs; "none" is theta == FLT_MAX (geometry.cpp:10-12). The scalar Python
forms keep the reference's names (ParametricLine, parametric_intersect,
line_by_shifting_origin, inset_rect); the forms on batched tensors that
the detection runs carry the suffix _torch, as the JAX package's carry
_jax. Two numeric rules make the tensor forms' corners equal the
reference's bit for bit:

* sin and cos are taken in float64 and rounded to float32. The angles
  that reach here are the Hough stage's f32 angles (and 0 for a line
  that was not found); at every one of them this equals XLA:CPU's f32
  jnp.sin/jnp.cos, which f32 torch.sin/torch.cos on the CPU do not, and
  which CUDA's f32 sinf/cosf do not promise
  (tests/test_torch_camera_ops.py holds the table).
* every f32 multiply and add is its own op. The TPU and the reference's
  compiled C++ round each one; XLA:CPU under jit may fuse a multiply that
  feeds an add into an FMA, so the JAX package's jitted corners can differ
  from these in the last bit on the CPU (ROADMAP.md, queue 3).
"""

import math
from dataclasses import dataclass

import torch

_FLT_MAX = 3.4028235e38


@dataclass(frozen=True)
class ParametricLine:
    rho: float
    theta: float


def parametric_line_none() -> ParametricLine:
    return ParametricLine(0.0, _FLT_MAX)


def is_parametric_line_none(line: ParametricLine) -> bool:
    return line.theta == _FLT_MAX


def parametric_intersect(line1: ParametricLine, line2: ParametricLine):
    """geometry.cpp:14-32 on two scalar lines. Returns (ok, x, y)."""
    if is_parametric_line_none(line1) or is_parametric_line_none(line2):
        return False, 0.0, 0.0
    c1, s1 = math.cos(line1.theta), math.sin(line1.theta)
    c2, s2 = math.cos(line2.theta), math.sin(line2.theta)
    det = c1 * s2 - s1 * c2
    if det < 1e-10:
        return False, 0.0, 0.0
    x = (s2 * line1.rho - s1 * line2.rho) / det
    y = (-c2 * line1.rho + c1 * line2.rho) / det
    return True, x, y


def line_by_shifting_origin(line: ParametricLine, x_offset,
                            y_offset) -> ParametricLine:
    """geometry.cpp:34-43: re-express an ROI-local line in full-image
    coordinates."""
    if x_offset == 0:
        offset_angle = math.pi / 2.0
    else:
        offset_angle = math.atan(float(y_offset) / float(x_offset))
    delta_angle = line.theta - offset_angle + math.pi / 2.0
    offset_magnitude = math.sqrt(x_offset * x_offset + y_offset * y_offset)
    delta_rho = offset_magnitude * math.cos(math.pi / 2.0 - delta_angle)
    return ParametricLine(line.rho + delta_rho, line.theta)


def inset_rect(x, y, w, h, dx, dy):
    """cvInsetRect (geometry.h:10-15): shrink a rect by (dx, dy) a side."""
    return x + dx, y + dy, w - 2 * dx, h - 2 * dy


def sin_cos(theta):
    """sin and cos of f32 angles, computed in float64 and rounded to f32."""
    t = theta.to(torch.float64)
    return torch.sin(t).to(torch.float32), torch.cos(t).to(torch.float32)


def parametric_intersect_torch(rho1, theta1, rho2, theta2):
    """geometry.cpp:14-32 on batched lines. Returns (ok, x, y); like the
    reference, ok tests the signed determinant, det >= 1e-10."""
    s1, c1 = sin_cos(theta1)
    s2, c2 = sin_cos(theta2)
    det = c1 * s2 - s1 * c2
    ok = det >= 1e-10
    safe_det = torch.where(ok, det, 1.0)
    x = (s2 * rho1 - s1 * rho2) / safe_det
    y = (-c2 * rho1 + c1 * rho2) / safe_det
    return ok, torch.where(ok, x, 0.0), torch.where(ok, y, 0.0)


def line_by_shifting_origin_torch(rho, theta, x_offset, y_offset):
    """geometry.cpp:34-43: re-express a band-local line in full-image
    coordinates; the offsets are the band's (static) origin."""
    if x_offset == 0:
        offset_angle = math.pi / 2.0
    else:
        offset_angle = math.atan(float(y_offset) / float(x_offset))
    delta_angle = theta - offset_angle + math.pi / 2.0
    offset_magnitude = math.sqrt(x_offset * x_offset + y_offset * y_offset)
    _, cos = sin_cos(math.pi / 2.0 - delta_angle)
    return rho + offset_magnitude * cos, theta

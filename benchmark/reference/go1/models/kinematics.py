"""Analytic 3-DOF leg kinematics for the A1/Go1 quadruped.

Port of the JAX package's ``models/kinematics.py``: the forward chain

    p = [ox, oy, 0] + Rx(q1) @ ([0, cy + d, 0]
                                + Ry(q2) @ ([0, 0, -lt]
                                            + Ry(q3) @ [cx, 0, -(lc - cz)]))

with rho_opt = (cx, cy, cz) and rho_fix = (ox, oy, d, lt, lc)
(A1Kinematics.h:16-19), its analytic Jacobian, the calibration
derivatives (dfk/drho, dJ/dq, dJ/drho, by forward-mode autodiff with
``torch.func``) and the closed-form IK the simulator uses. All functions
take arbitrary leading batch dimensions.
"""

from typing import NamedTuple

import torch

RHO_OPT_SIZE = 3
RHO_FIX_SIZE = 5


class LegGeometry(NamedTuple):
    """Per-leg geometry stacked over legs.

    Attributes:
      rho_fix: (..., 4, 5) = (offset_x, offset_y, motor_offset,
        upper_leg_length, lower_leg_length).
      rho_opt: (..., 4, 3) contact-point calibration (cx, cy, cz).
    """
    rho_fix: torch.Tensor
    rho_opt: torch.Tensor


def a1_leg_geometry(dtype=torch.float32, device=None):
    """Gazebo/hardware A1/Go1 geometry (GazeboA1ROS.cpp:76-89); leg order
    0-FL 1-FR 2-RL 3-RR."""
    rho_fix = torch.tensor(
        [[0.1881, 0.04675, 0.08, 0.213, 0.213],
         [0.1881, -0.04675, -0.08, 0.213, 0.213],
         [-0.1881, 0.04675, 0.08, 0.213, 0.213],
         [-0.1881, -0.04675, -0.08, 0.213, 0.213]], dtype=torch.float64)
    return LegGeometry(rho_fix=rho_fix.to(device=device, dtype=dtype),
                       rho_opt=torch.zeros((4, 3), dtype=dtype,
                                           device=device))


def _split(q, rho_opt, rho_fix):
    q1, q2, q3 = q.unbind(-1)
    cx, cy, cz = rho_opt.unbind(-1)
    ox, oy, d, lt, lc = rho_fix.unbind(-1)
    return q1, q2, q3, cx, cy, cz, ox, oy, d, lt, lc


def fk(q, rho_opt, rho_fix):
    """(..., 3) joint angles -> (..., 3) foot position in the body frame."""
    q1, q2, q3, cx, cy, cz, ox, oy, d, lt, lc = _split(q, rho_opt, rho_fix)
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s2, c2 = torch.sin(q2), torch.cos(q2)
    s23, c23 = torch.sin(q2 + q3), torch.cos(q2 + q3)
    calf = lc - cz          # effective calf length after contact offset
    hip = cy + d            # abduction offset along rolled y
    x_plane = cx * c23 - calf * s23 - lt * s2
    a = lt * c2 + calf * c23 + cx * s23  # downward leg extension
    px = ox + x_plane
    py = oy + hip * c1 + a * s1
    pz = hip * s1 - a * c1
    return torch.stack([px, py, pz], dim=-1)


def jac(q, rho_opt, rho_fix):
    """Analytic foot Jacobian d fk / d q, (..., 3, 3) with columns over
    (q1, q2, q3) (A1Kinematics.cpp:13-17)."""
    q1, q2, q3, cx, cy, cz, _, _, d, lt, lc = _split(q, rho_opt, rho_fix)
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s2, c2 = torch.sin(q2), torch.cos(q2)
    s23, c23 = torch.sin(q2 + q3), torch.cos(q2 + q3)
    calf = lc - cz
    hip = cy + d
    a = lt * c2 + calf * c23 + cx * s23
    da_dq2 = -lt * s2 - calf * s23 + cx * c23
    da_dq3 = -calf * s23 + cx * c23
    b = calf * c23 + cx * s23
    zero = torch.zeros_like(a)
    col1 = torch.stack([zero, -hip * s1 + a * c1, hip * c1 + a * s1], dim=-1)
    col2 = torch.stack([-a, s1 * da_dq2, -c1 * da_dq2], dim=-1)
    col3 = torch.stack([-b, s1 * da_dq3, -c1 * da_dq3], dim=-1)
    return torch.stack([col1, col2, col3], dim=-1)


def inverse_kinematics(p_body, rho_fix):
    """Closed-form leg IK (rho_opt = 0): (..., 3) body-frame foot position
    -> (..., 3) joint angles on the knee-bent-backward branch (q3 < 0)."""
    ox, oy, d, lt, lc = rho_fix.unbind(-1)
    hip = d  # only the motor offset rotates with the hip roll (see fk)
    x = p_body[..., 0] - ox
    y = p_body[..., 1] - oy
    z = p_body[..., 2]
    r2 = y * y + z * z
    a = torch.sqrt(torch.clamp(r2 - hip * hip, min=1e-12))
    # y = hip c1 + a s1, z = hip s1 - a c1  ->  solve the linear system
    s1 = (hip * z + a * y) / torch.clamp(r2, min=1e-12)
    c1 = (hip * y - a * z) / torch.clamp(r2, min=1e-12)
    q1 = torch.atan2(s1, c1)
    # planar 2-link: (x, -a) reached by lt @ q2 and lc @ q2+q3
    l2 = x * x + a * a
    cos_knee = torch.clamp((l2 - lt * lt - lc * lc) / (2 * lt * lc),
                           -1.0, 1.0)
    q3 = -torch.arccos(cos_knee)
    k1 = lt + lc * torch.cos(q3)
    k2 = lc * torch.sin(q3)
    q2 = torch.atan2(-x * k1 - a * k2, a * k1 - x * k2)
    return torch.stack([q1, q2, q3], dim=-1)

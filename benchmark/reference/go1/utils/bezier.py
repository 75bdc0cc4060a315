"""Degree-4 Bezier swing-foot trajectory.

Port of the JAX package's ``utils/bezier.py``
(BezierUtils::get_foot_pos_curve, Utils.cpp:64-107).
"""

import math

import torch

from reference.go1.config.params import (
    FOOT_SWING_CLEARANCE1,
    FOOT_SWING_CLEARANCE2,
)

# Binomial coefficients of the degree-4 Bernstein basis (Utils.cpp:101).
_BINOM = (1.0, 4.0, 6.0, 4.0, 1.0)


def bernstein4(t, control_points):
    """sum_i C(4,i) t^i (1-t)^(4-i) P_i for t (...) and control points
    (..., 5)."""
    one_m_t = 1.0 - t
    out = torch.zeros(torch.broadcast_shapes(t.shape,
                                             control_points.shape[:-1]),
                      dtype=control_points.dtype,
                      device=control_points.device)
    for i in range(5):
        basis = _BINOM[i] * t ** i * one_m_t ** (4 - i)
        out = out + basis * control_points[..., i]
    return out


def swing_foot_pos(t, foot_pos_start, foot_pos_final,
                   terrain_pitch_angle=0.0):
    """Swing-foot position at phase ``t`` (...) between (..., 3) liftoff
    and foothold points; control points per axis are (start, start, final,
    final, final) with the z clearance bumps of Utils.cpp:87-94."""
    s = foot_pos_start
    f = foot_pos_final
    ctrl = torch.stack([s, s, f, f, f], dim=-1)          # (..., 3, 5)
    sin = torch.sin if torch.is_tensor(terrain_pitch_angle) else math.sin
    bump2 = FOOT_SWING_CLEARANCE2 + 0.5 * sin(terrain_pitch_angle)
    ctrl[..., 2, 1] = ctrl[..., 2, 1] + FOOT_SWING_CLEARANCE1
    ctrl[..., 2, 2] = ctrl[..., 2, 2] + bump2
    return bernstein4(t[..., None], ctrl)

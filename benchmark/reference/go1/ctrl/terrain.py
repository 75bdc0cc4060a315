"""Terrain plane estimation and pitch adaptation.

Port of the JAX package's ``ctrl/terrain.py``
(A1RobotControl::compute_walking_surface, A1RobotControl.cpp:566-582, and
the terrain block of compute_grf, :334-376), batch first: a ridge-
regularized least-squares plane through the recent contact points, its
dihedral angle to flat ground through a height-gated 100-sample moving
average, clamped to +-0.5 rad, signed by the front/rear height difference.
"""

import torch

from reference.go1.utils import filters, rotations
from reference.go1.utils.device import const


def compute_walking_surface(foot_pos_recent_contact):
    """Plane fit z = a0 + a1 x + a2 y over (B, 4, 3) contact points;
    returns (B, 3) coefficients (a1, a2, -1)."""
    fp = foot_pos_recent_contact
    w = torch.cat([torch.ones_like(fp[..., :1]), fp[..., :2]], dim=-1)
    z = fp[..., 2]
    w_t = w.transpose(-1, -2)
    gram = w_t @ w
    ridge = 1e-6 * torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1) + 1e-12
    gram = gram + ridge[:, None, None] * torch.eye(3, dtype=fp.dtype,
                                                   device=fp.device)
    a = rotations.solve_3x3(gram, (w_t @ z[..., None])[..., 0])
    return torch.stack([a[:, 1], a[:, 2], -torch.ones_like(a[:, 0])],
                       dim=-1)


def terrain_adaptation(state, use_terrain_adapt=True):
    """Update the desired pitch from the estimated terrain plane (MPC mode,
    A1RobotControl.cpp:335-376); returns the updated batched CtrlState."""
    surf = compute_walking_surface(state.foot_pos_recent_contact)
    flat = const((0.0, 0.0, 1.0), surf.dtype, surf.device)
    angle_raw = rotations.cal_dihedral_angle(flat, surf)
    # fold into the filter only while the body is high enough (:340-345)
    body_high = state.root_pos[:, 2] > 0.1
    new_filter, angle_avg = filters.moving_window_update_masked(
        state.terrain_angle_filter, angle_raw, body_high)
    terrain_angle = torch.where(body_high, angle_avg,
                                torch.zeros_like(angle_avg))
    terrain_angle = torch.clamp(terrain_angle, -0.5, 0.5)

    # sign from the front-vs-rear contact height difference (:354-364)
    z = state.foot_pos_recent_contact[..., 2]
    f_r_diff = z[:, 0] + z[:, 1] - z[:, 2] - z[:, 3]
    pitch_d = torch.where(f_r_diff > 0.05, -terrain_angle, terrain_angle)
    root_euler_d = state.root_euler_d
    if use_terrain_adapt:
        root_euler_d = torch.cat([root_euler_d[:, :1], pitch_d[:, None],
                                  root_euler_d[:, 2:]], dim=-1)
    return state._replace(
        terrain_angle_filter=new_filter,
        terrain_pitch_angle=terrain_angle,
        root_euler_d=root_euler_d,
    )

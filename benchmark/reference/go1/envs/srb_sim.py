"""Single-rigid-body plant for closed-loop batched rollouts.

Port of the JAX package's ``envs/srb_sim.py``, batch first. The trunk is
one rigid body driven by stance-foot forces recovered from the commanded
joint torques (f = -J^-T tau, inverting the controller's stance map,
A1RobotControl.cpp:303); swing feet track the controller's Bezier plan
kinematically and joints follow by closed-form IK; stance feet stay where
they touched down. The sensor model produces what the robot adapters feed
the controller (IMU specific force, body-frame gyro, joints, foot forces).
"""

from typing import NamedTuple

import torch

from reference.go1.config import params as P
from reference.go1.ctrl.controller import SensorData
from reference.go1.models import kinematics
from reference.go1.utils import rotations
from reference.go1.utils.device import const


class SimState(NamedTuple):
    """World-frame plant state, batch first.

    Attributes:
      root_pos: (B, 3) trunk CoM position.
      root_rot: (B, 3, 3) trunk orientation (body -> world).
      root_lin_vel: (B, 3) world-frame velocity.
      root_ang_vel: (B, 3) world-frame angular velocity.
      foot_pos_world: (B, 4, 3) foot contact points.
      prev_contacts: (B, 4) bool, last tick's stance flags.
      prev_joint_pos: (B, 12) for joint-velocity finite differences.
      last_acc_world: (B, 3) CoM acceleration (for the IMU model).
    """
    root_pos: torch.Tensor
    root_rot: torch.Tensor
    root_lin_vel: torch.Tensor
    root_ang_vel: torch.Tensor
    foot_pos_world: torch.Tensor
    prev_contacts: torch.Tensor
    prev_joint_pos: torch.Tensor
    last_acc_world: torch.Tensor


def ground_height(ground_coef, xy):
    """Planar terrain z = g0 + gx x + gy y for (3,) ``ground_coef`` and
    (..., 2) ``xy``."""
    return (ground_coef[0] + ground_coef[1] * xy[..., 0]
            + ground_coef[2] * xy[..., 1])


def _ground(ground_coef, like):
    if ground_coef is None:
        return torch.zeros(3, dtype=like.dtype, device=like.device)
    return ground_coef


def _integrate_rotation(rot, omega_world, dt):
    """R <- (I + skew(w dt)) R, re-orthonormalized by one Gram-Schmidt pass
    over the columns."""
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    r_new = (eye + rotations.skew(omega_world * dt)) @ rot
    c0 = r_new[..., 0]
    c0 = c0 / torch.linalg.norm(c0, dim=-1, keepdim=True)
    c1 = r_new[..., 1]
    c1 = c1 - torch.sum(c0 * c1, dim=-1, keepdim=True) * c0
    c1 = c1 / torch.linalg.norm(c1, dim=-1, keepdim=True)
    c2 = rotations.cross(c0, c1)
    return torch.stack([c0, c1, c2], dim=-1)


def _feet_body(sim):
    return (sim.foot_pos_world - sim.root_pos[:, None]) @ sim.root_rot


def read_sensors(sim, model, contacts, stance_forces_z, dt):
    """Observations of the current plant state (HardwareA1ROS.cpp:260-312):
    IMU specific force, body-frame gyro and orientation quaternion, joints
    from foot IK, finite-difference joint velocities, foot forces."""
    batch = sim.root_pos.shape[0]
    g_vec = const((0.0, 0.0, -P.GRAVITY), sim.root_pos.dtype,
                  sim.root_pos.device)
    q = kinematics.inverse_kinematics(
        _feet_body(sim), model.leg_geometry.rho_fix).reshape(batch, 12)
    rot_t = sim.root_rot.transpose(-1, -2)
    return SensorData(
        quat_wxyz=_rot_to_quat(sim.root_rot),
        imu_acc=(rot_t @ (sim.last_acc_world - g_vec)[..., None])[..., 0],
        imu_ang_vel=(rot_t @ sim.root_ang_vel[..., None])[..., 0],
        joint_pos=q, joint_vel=(q - sim.prev_joint_pos) / dt,
        foot_force=torch.where(contacts,
                               torch.clamp(stance_forces_z, min=0.0),
                               torch.zeros_like(stance_forces_z)))


def step(sim, model, joint_torques, contacts, swing_targets_rel, dt,
         ground_coef=None):
    """Advance the plant by ``dt``.

    Args:
      joint_torques: (B, 12) commanded torques.
      contacts: (B, 4) bool stance schedule from the controller.
      swing_targets_rel: (B, 4, 3) yaw-frame swing-foot targets.
      ground_coef: optional (3,) planar terrain; None = flat.

    Returns:
      (new SimState, (B, 4) applied stance normal forces).
    """
    dtype, device = sim.root_pos.dtype, sim.root_pos.device
    batch = sim.root_pos.shape[0]
    rot = sim.root_rot
    rot_z = rotations.rot_z(torch.atan2(rot[:, 1, 0], rot[:, 0, 0]))
    geom = model.leg_geometry

    # joints consistent with the current feet
    q_legs = kinematics.inverse_kinematics(_feet_body(sim), geom.rho_fix)
    j_legs = kinematics.jac(q_legs, geom.rho_opt, geom.rho_fix)

    # stance forces from torques: tau = J^T (-f_body) -> f = -J^-T tau
    tau_legs = joint_torques.reshape(batch, 4, 3)
    f_body = -rotations.solve_3x3(j_legs.transpose(-1, -2), tau_legs)
    f_world = f_body @ rot.transpose(-1, -2)
    f_world = torch.where(contacts[..., None], f_world,
                          torch.zeros_like(f_world))

    # SRB dynamics
    g_vec = const((0.0, 0.0, -P.GRAVITY), dtype, device)
    acc = torch.sum(f_world, dim=1) / model.mass + g_vec
    arms = sim.foot_pos_world - sim.root_pos[:, None]
    torque_world = torch.sum(rotations.cross(arms, f_world), dim=1)
    i_world = rot @ model.trunk_inertia @ rot.transpose(-1, -2)
    ang_acc = rotations.solve_3x3(i_world, torque_world)

    lin_vel = sim.root_lin_vel + acc * dt
    ang_vel = sim.root_ang_vel + ang_acc * dt
    root_pos = sim.root_pos + lin_vel * dt
    rot_new = _integrate_rotation(rot, ang_vel, dt)

    # stance feet stay pinned; swing feet track the plan kinematically
    swing_world = (swing_targets_rel @ rot_z.transpose(-1, -2)
                   + root_pos[:, None])
    feet = torch.where(contacts[..., None], sim.foot_pos_world, swing_world)
    # feet cannot go below the terrain
    gz = ground_height(_ground(ground_coef, feet), feet[..., :2])
    feet = torch.cat([feet[..., :2],
                      torch.maximum(feet[..., 2], gz)[..., None]], dim=-1)

    new_sim = SimState(
        root_pos=root_pos, root_rot=rot_new, root_lin_vel=lin_vel,
        root_ang_vel=ang_vel, foot_pos_world=feet, prev_contacts=contacts,
        prev_joint_pos=q_legs.reshape(batch, 12), last_acc_world=acc)
    return new_sim, torch.clamp(f_world[..., 2], min=0.0)


def _rot_to_quat(r):
    """(B, 3, 3) rotation -> (B, 4) quaternion (w, x, y, z), branchless."""
    w = 0.5 * torch.sqrt(torch.clamp(
        1.0 + r[:, 0, 0] + r[:, 1, 1] + r[:, 2, 2], min=1e-12))
    denom = torch.clamp(4.0 * w, min=1e-9)
    return torch.stack([w, (r[:, 2, 1] - r[:, 1, 2]) / denom,
                        (r[:, 0, 2] - r[:, 2, 0]) / denom,
                        (r[:, 1, 0] - r[:, 0, 1]) / denom], dim=-1)

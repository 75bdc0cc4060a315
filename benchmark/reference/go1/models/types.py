"""Core state containers: robot model, control parameters, controller state.

Port of the JAX package's ``models/types.py``. ``RobotModel`` and
``CtrlParams`` are shared by a whole batch (no batch axis); every leaf of a
``CtrlState`` carries a leading batch axis ``B``. Foot quantities are
(4, 3) leg-major, as in the JAX package.
"""

from typing import NamedTuple

import numpy as np
import torch

from reference.go1.config import params as P
from reference.go1.models import kinematics
from reference.go1.utils import filters
from reference.go1.utils.device import resolve_device


class RobotModel(NamedTuple):
    """Physical robot description (A1CtrlStates.h:40-47).

    Attributes:
      mass: () trunk mass in kg.
      trunk_inertia: (3, 3) body-frame inertia.
      leg_geometry: kinematics.LegGeometry.
      default_foot_pos: (4, 3) nominal stance feet in the body frame.
    """
    mass: torch.Tensor
    trunk_inertia: torch.Tensor
    leg_geometry: kinematics.LegGeometry
    default_foot_pos: torch.Tensor


class CtrlParams(NamedTuple):
    """Controller gains / weights / gait parameters (A1CtrlStates.h:20-321)."""
    q_weights: torch.Tensor        # (13,) MPC state weights
    r_weights: torch.Tensor        # (12,) MPC force weights
    kp_foot: torch.Tensor          # (4, 3) swing foot P gains
    kd_foot: torch.Tensor          # (4, 3) swing foot D gains
    km_foot: torch.Tensor          # (3,) swing torque scaling
    kp_linear: torch.Tensor        # (3,) balance-QP gains (unused by MPC)
    kd_linear: torch.Tensor        # (3,)
    kp_angular: torch.Tensor       # (3,)
    kd_angular: torch.Tensor       # (3,)
    torques_gravity: torch.Tensor  # (12,) gravity-compensation torques
    gait_counter_speed: torch.Tensor  # (4,) phase increments per tick
    counter_per_gait: torch.Tensor    # () gait cycle length in counts
    counter_per_swing: torch.Tensor   # () stance/swing split in counts
    control_dt: torch.Tensor          # () main-loop period (s)
    mpc_dt: torch.Tensor              # () MPC discretization step (s)


class CtrlState(NamedTuple):
    """Batched dynamic controller state; shapes below are per scenario,
    each leaf has an extra leading batch axis."""
    movement_mode: torch.Tensor        # () int32: 0 stand, 1 walk
    counter: torch.Tensor              # () int32 tick counter
    mpc_init_counter: torch.Tensor     # () int32 warmup counter
    gait_counter: torch.Tensor         # (4,) per-leg phase counters
    root_pos_d: torch.Tensor           # (3,)
    root_euler_d: torch.Tensor         # (3,)
    root_lin_vel_d: torch.Tensor       # (3,) body frame
    root_ang_vel_d: torch.Tensor       # (3,)
    root_pos: torch.Tensor             # (3,)
    root_euler: torch.Tensor           # (3,)
    root_rot_mat: torch.Tensor         # (3, 3)
    root_rot_mat_z: torch.Tensor       # (3, 3) yaw-only
    root_lin_vel: torch.Tensor         # (3,) world frame
    root_ang_vel: torch.Tensor         # (3,)
    imu_acc: torch.Tensor              # (3,)
    imu_ang_vel: torch.Tensor          # (3,)
    joint_pos: torch.Tensor            # (12,)
    joint_vel: torch.Tensor            # (12,)
    foot_force: torch.Tensor           # (4,)
    foot_pos_rel: torch.Tensor         # (4, 3) body frame (FK)
    foot_pos_abs: torch.Tensor         # (4, 3) world-aligned, body-centered
    foot_vel_rel: torch.Tensor         # (4, 3)
    j_foot: torch.Tensor               # (4, 3, 3)
    foot_pos_target_rel: torch.Tensor      # (4, 3)
    foot_pos_target_abs: torch.Tensor      # (4, 3)
    foot_pos_target_world: torch.Tensor    # (4, 3)
    foot_pos_start: torch.Tensor           # (4, 3) swing liftoff points
    foot_pos_rel_last_time: torch.Tensor   # (4, 3)
    foot_pos_target_last_time: torch.Tensor  # (4, 3)
    foot_pos_recent_contact: torch.Tensor  # (4, 3)
    contacts: torch.Tensor             # (4,) bool actual contact schedule
    plan_contacts: torch.Tensor        # (4,) bool planned schedule
    early_contacts: torch.Tensor       # (4,) bool swing-interrupt flags
    foot_forces_kin: torch.Tensor      # (4, 3) swing PD forces
    foot_forces_grf: torch.Tensor      # (4, 3) stance GRFs (body frame)
    joint_torques: torch.Tensor        # (12,)
    terrain_pitch_angle: torch.Tensor  # ()
    terrain_angle_filter: filters.MovingWindowState   # window 100
    recent_contact_filter: filters.MovingWindowState  # 4 legs, (3,)
    estimator_x: torch.Tensor          # (18,)
    estimator_P: torch.Tensor          # (18, 18)
    estimated_contacts: torch.Tensor   # (4,) bool
    qp_warm_x: torch.Tensor            # (120,) primal carry (12 H stagewise)
    qp_warm_y: torch.Tensor            # (200,) dual carry (20 H stagewise)
    qp_warm_rho: torch.Tensor          # () adapted ADMM step size
    qp_warm_minv: torch.Tensor         # (120, 120) carried KKT inverse
                                       # ((1, 1) placeholder stagewise)
    qp_warm_contacts: torch.Tensor     # (4,) pattern the carry was built for
    qp_warm_grad: torch.Tensor         # (120,) gradient the carry solved


def default_ctrl_params(dtype=torch.float32, device=None):
    """A1CtrlStates::reset() gain/weight defaults (A1CtrlStates.h:49-133)."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
        device=device, dtype=dtype)
    return CtrlParams(
        q_weights=t([80.0, 80.0, 1.0, 0.0, 0.0, 270.0,
                     1.0, 1.0, 20.0, 20.0, 20.0, 20.0, 0.0]),
        r_weights=t([1e-5, 1e-5, 1e-6] * 4),
        kp_foot=t(np.tile([300.0, 400.0, 400.0], (4, 1))),
        kd_foot=t(np.full((4, 3), 8.0)),
        km_foot=t([0.1, 0.1, 0.1]),
        kp_linear=t([1000.0, 1000.0, 1000.0]),
        kd_linear=t([200.0, 70.0, 120.0]),
        kp_angular=t([650.0, 35.0, 1.0]),
        kd_angular=t([4.5, 4.5, 30.0]),
        torques_gravity=t([0.80, 0, 0, -0.80, 0, 0,
                           0.80, 0, 0, -0.80, 0, 0]),
        gait_counter_speed=t(np.full((4,), 2.0)),
        counter_per_gait=t(240.0),
        counter_per_swing=t(120.0),
        control_dt=t(P.MAIN_UPDATE_PERIOD_MS / 1000.0),
        mpc_dt=t(P.HARDWARE_MPC_DT),
    )


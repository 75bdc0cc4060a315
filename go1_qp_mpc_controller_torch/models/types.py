"""Core state containers: robot model, control parameters, controller state.

Port of the JAX package's ``models/types.py``. ``RobotModel`` and
``CtrlParams`` are shared by a whole batch (no batch axis); every leaf of a
``CtrlState`` carries a leading batch axis ``B``. Foot quantities are
(4, 3) leg-major, as in the JAX package.
"""

from typing import NamedTuple

import numpy as np
import torch

from go1_qp_mpc_controller_torch.config import params as P
from go1_qp_mpc_controller_torch.models import kinematics
from go1_qp_mpc_controller_torch.utils import filters
from go1_qp_mpc_controller_torch.utils.device import resolve_device


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


def default_robot_model(dtype=torch.float32, device=None):
    """A1CtrlStates::reset() physical defaults (A1CtrlStates.h:40-47)."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
        device=device, dtype=dtype)
    return RobotModel(
        mass=t(15.0),
        trunk_inertia=t(np.diag([0.0168352186, 0.0656071082,
                                 0.0742720659])),
        leg_geometry=kinematics.a1_leg_geometry(dtype, device),
        default_foot_pos=t([[0.17, 0.15, -0.35], [0.17, -0.15, -0.35],
                            [-0.17, 0.15, -0.35], [-0.17, -0.15, -0.35]]),
    )


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


def init_ctrl_state(model, batch, dtype=torch.float32, device=None,
                    horizon=P.PLAN_HORIZON):
    """Fresh batched controller state in the default stand pose.

    Gait counters start at the trot offsets (0, 120, 120, 0)
    (A1CtrlStates.h:323-327). The carried contact pattern starts all-false,
    which differs from every reachable schedule, so the first MPC tick
    always takes the cold branch.

    Args:
      horizon: the MPC horizon the warm-carry fields are sized for. The
        default PLAN_HORIZON = 10 gives the condensed solver's shapes
        (120 / 200 and the carried KKT inverse); any other value sizes the
        primal / dual / gradient carries 12 H / 20 H / 12 H for the
        stagewise solver (``controller.compute_grf_mpc_stagewise``), which
        carries no KKT inverse: qp_warm_minv is a (B, 1, 1) placeholder.
    """
    device = resolve_device(device)
    b = (batch,)
    kw = dict(dtype=dtype, device=device)
    zeros = lambda *shape: torch.zeros(b + shape, **kw)
    izeros = lambda: torch.zeros(b, dtype=torch.int32, device=device)
    bzeros = lambda: torch.zeros(b + (4,), dtype=torch.bool, device=device)
    rep = lambda a: a.to(**kw).expand(b + a.shape).clone()
    eye = lambda n: rep(torch.eye(n, **kw))
    feet = model.default_foot_pos
    return CtrlState(
        movement_mode=izeros(), counter=izeros(), mpc_init_counter=izeros(),
        gait_counter=rep(torch.tensor([0.0, 120.0, 120.0, 0.0])),
        root_pos_d=zeros(3), root_euler_d=zeros(3), root_lin_vel_d=zeros(3),
        root_ang_vel_d=zeros(3), root_pos=zeros(3), root_euler=zeros(3),
        root_rot_mat=eye(3), root_rot_mat_z=eye(3),
        root_lin_vel=zeros(3), root_ang_vel=zeros(3),
        imu_acc=zeros(3), imu_ang_vel=zeros(3),
        joint_pos=zeros(12), joint_vel=zeros(12), foot_force=zeros(4),
        foot_pos_rel=rep(feet), foot_pos_abs=rep(feet),
        foot_vel_rel=zeros(4, 3),
        j_foot=rep(torch.eye(3, **kw).expand(4, 3, 3)),
        foot_pos_target_rel=rep(feet), foot_pos_target_abs=rep(feet),
        foot_pos_target_world=rep(feet), foot_pos_start=rep(feet),
        foot_pos_rel_last_time=zeros(4, 3),
        foot_pos_target_last_time=zeros(4, 3),
        foot_pos_recent_contact=rep(feet),
        contacts=bzeros(), plan_contacts=bzeros(), early_contacts=bzeros(),
        foot_forces_kin=zeros(4, 3), foot_forces_grf=zeros(4, 3),
        joint_torques=zeros(12), terrain_pitch_angle=zeros(),
        terrain_angle_filter=filters.moving_window_init(
            100, b, (), dtype, device),
        recent_contact_filter=filters.moving_window_init_stacked(
            4, 60, b, (3,), dtype, device),
        estimator_x=zeros(18), estimator_P=3.0 * eye(18),
        estimated_contacts=bzeros(),
        qp_warm_x=zeros(P.NUM_DOF * horizon),
        qp_warm_y=zeros(P.MPC_CONSTRAINT_DIM * horizon),
        qp_warm_rho=torch.full(b, 0.1, **kw),
        qp_warm_minv=(eye(P.MPC_NV) if horizon == P.PLAN_HORIZON
                      else zeros(1, 1)),
        qp_warm_contacts=bzeros(), qp_warm_grad=zeros(P.NUM_DOF * horizon),
    )

"""Swing-leg trajectory tracking and contact bookkeeping.

Port of the JAX package's ``ctrl/swing.py``
(A1RobotControl::generate_swing_legs_ctrl, A1RobotControl.cpp:204-287),
batch first: Bezier interpolation from the liftoff point to the planned
foothold, PD forces in the yaw-aligned body frame, early-contact detection
from the foot-force sensors, and gated moving-average filtering of recent
contact positions.
"""

import torch

from reference.go1.config import params as P
from reference.go1.utils import bezier, filters


def generate_swing_legs_ctrl(state, params, dt):
    """One swing-control tick for a batched CtrlState; ``dt`` is the
    control period of the finite-difference velocities."""
    # current feet in the yaw-aligned frame (A1RobotControl.cpp:224)
    foot_pos_cur = state.foot_pos_abs @ state.root_rot_mat_z

    cps = params.counter_per_swing
    stance = state.gait_counter <= cps
    spline_time = torch.where(stance, torch.zeros_like(state.gait_counter),
                              (state.gait_counter - cps) / cps)
    # liftoff point refreshes while in stance (A1RobotControl.cpp:229-236)
    foot_pos_start = torch.where(stance[..., None], foot_pos_cur,
                                 state.foot_pos_start)

    foot_pos_target = bezier.swing_foot_pos(
        spline_time, foot_pos_start, state.foot_pos_target_rel)

    foot_vel_cur = (foot_pos_cur - state.foot_pos_rel_last_time) / dt
    foot_vel_target = (foot_pos_target
                       - state.foot_pos_target_last_time) / dt
    foot_forces_kin = (params.kp_foot * (foot_pos_target - foot_pos_cur)
                       + params.kd_foot * (foot_vel_target - foot_vel_cur))

    # early contact detection (A1RobotControl.cpp:259-271)
    late_swing = state.gait_counter > cps * 1.5
    early = state.early_contacts & late_swing
    early = early | (~state.plan_contacts & late_swing
                     & (state.foot_force > P.FOOT_FORCE_LOW))
    contacts = state.plan_contacts | early

    # gated recent-contact filters (A1RobotControl.cpp:274-281)
    new_filter, recent_avg = filters.moving_window_update_masked(
        state.recent_contact_filter, state.foot_pos_abs, contacts)
    foot_pos_recent_contact = torch.where(
        contacts[..., None], recent_avg, state.foot_pos_recent_contact)

    return state._replace(
        foot_pos_start=foot_pos_start,
        foot_pos_rel_last_time=foot_pos_cur,
        foot_pos_target_last_time=foot_pos_target,
        early_contacts=early,
        contacts=contacts,
        recent_contact_filter=new_filter,
        foot_pos_recent_contact=foot_pos_recent_contact,
        foot_forces_kin=foot_forces_kin,
    )

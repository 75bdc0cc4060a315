"""Gait scheduling and Raibert foot placement.

Port of the JAX package's ``ctrl/gait.py`` (A1RobotControl::update_plan,
A1RobotControl.cpp:148-202), batch first: per-leg phase counters advanced
mod the gait period, the contact schedule from the stance/swing split, and
the Raibert foothold

    delta = sqrt(|z0| / g) (v - v_d) + (T_swing / 2) v_d

clamped to +-0.1 m.
"""

import torch

from reference.go1.config import params as P
from reference.go1.utils.device import const

TROT_OFFSETS = (0.0, 120.0, 120.0, 0.0)  # A1CtrlStates.h:323-327


def update_plan(state, params, model):
    """Advance gait counters and plan footholds for a batched CtrlState.

    In stand mode (movement_mode == 0) all feet are planned in contact and
    the counters reset to the trot phase offsets (A1RobotControl.cpp:150-153).
    """
    dtype, device = state.root_pos.dtype, state.root_pos.device
    walking = (state.movement_mode != 0)[:, None]

    adv = torch.remainder(state.gait_counter + params.gait_counter_speed,
                          params.counter_per_gait)
    offsets = const(TROT_OFFSETS, dtype, device)
    gait_counter = torch.where(walking, adv, offsets)
    plan_contacts = torch.where(walking,
                                gait_counter <= params.counter_per_swing,
                                torch.ones_like(walking))

    # Raibert heuristic (A1RobotControl.cpp:168-201)
    lin_vel_rel = (state.root_rot_mat_z.transpose(-1, -2)
                   @ state.root_lin_vel[..., None])[..., 0]
    stance_height = torch.abs(model.default_foot_pos[0, 2])
    t_half_swing = ((params.counter_per_swing / params.gait_counter_speed)
                    * params.control_dt) / 2.0             # (4,)
    k = torch.sqrt(stance_height / P.GRAVITY)
    vel_d = state.root_lin_vel_d[:, None, :2]
    delta_xy = (k * (lin_vel_rel[:, None, :2] - vel_d)
                + t_half_swing[None, :, None] * vel_d)
    lim = const((P.FOOT_DELTA_X_LIMIT, P.FOOT_DELTA_Y_LIMIT), dtype,
                device)
    delta_xy = torch.clamp(delta_xy, -lim, lim)

    target_rel = model.default_foot_pos + torch.nn.functional.pad(
        delta_xy, (0, 1))
    target_abs = target_rel @ state.root_rot_mat.transpose(-1, -2)
    target_world = target_abs + state.root_pos[:, None, :]

    return state._replace(
        counter=state.counter + 1,
        gait_counter=gait_counter,
        plan_contacts=plan_contacts,
        foot_pos_target_rel=target_rel,
        foot_pos_target_abs=target_abs,
        foot_pos_target_world=target_world,
    )

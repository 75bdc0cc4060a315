"""Joystick command processing: raw axes -> desired root state.

Port of the JAX package's ``ctrl/command.py``, batch first (the joystick
block of GazeboA1ROS::main_update, GazeboA1ROS.cpp:117-190, and the joy
callback's axis mapping, :381-415): body-height integration with clamps,
desired-euler integration, walk/stand mode toggling and the xy
position-locking logic. Branchless; every ``JoyState`` / ``JoyAxes`` leaf
carries a leading batch axis ``B``.
"""

from typing import NamedTuple

import torch

from go1_qp_mpc_controller_torch.config import params as P
from go1_qp_mpc_controller_torch.utils.device import const


class JoyState(NamedTuple):
    """Persistent joystick-interpretation state, each leaf (B,).

    Attributes:
      body_height: integrated height command (JOY_CMD_BODY_HEIGHT_*).
      ctrl_state: int32, 0 stand / 1 walk.
      toggle_request: bool latch (the A-button edge).
      exit_request: bool (ends the host loop).
    """
    body_height: torch.Tensor
    ctrl_state: torch.Tensor
    toggle_request: torch.Tensor
    exit_request: torch.Tensor


class JoyAxes(NamedTuple):
    """One joystick sample per scenario, each leaf (B,), already scaled to
    command units (GazeboA1ROS.cpp:381-410)."""
    velx: torch.Tensor        # m/s, clamp +-JOY_CMD_VELX_MAX
    vely: torch.Tensor        # m/s
    velz: torch.Tensor        # m/s body-height rate
    yaw_rate: torch.Tensor    # rad/s
    pitch_rate: torch.Tensor  # rad/s
    roll_rate: torch.Tensor   # rad/s
    toggle: torch.Tensor      # bool, A-button edge
    exit: torch.Tensor        # bool


def axes_from_raw(raw_axes, raw_buttons):
    """Map raw /joy samples to scaled JoyAxes (GazeboA1ROS.cpp:391-415):
    axis 4 -> forward velocity, 3 -> lateral velocity, 1 -> body-height
    rate, 0 -> yaw rate, 7 -> pitch rate, 6 -> roll rate; button 0 (A)
    requests the stand/walk toggle, button 4 (LB) the exit.

    Args:
      raw_axes: (B, 8) float axes in [-1, 1].
      raw_buttons: (B, >=5) int or bool buttons.
    """
    return JoyAxes(
        velx=raw_axes[:, 4] * P.JOY_CMD_VELX_MAX,
        vely=raw_axes[:, 3] * P.JOY_CMD_VELY_MAX,
        velz=raw_axes[:, 1] * P.JOY_CMD_BODY_HEIGHT_VEL,
        yaw_rate=raw_axes[:, 0] * P.JOY_CMD_YAW_MAX,
        pitch_rate=raw_axes[:, 7] * P.JOY_CMD_PITCH_MAX,
        roll_rate=raw_axes[:, 6] * P.JOY_CMD_ROLL_MAX,
        toggle=raw_buttons[:, 0] != 0,
        exit=raw_buttons[:, 4] != 0)


def latch_buttons(joy, axes):
    """OR-latch the button requests of one sample into JoyState: the joy
    callback may fire many times between control ticks, and a later
    main_update consumes and clears the request (GazeboA1ROS.cpp:396-398,
    411-415)."""
    return joy._replace(toggle_request=joy.toggle_request | axes.toggle,
                        exit_request=joy.exit_request | axes.exit)


def init_joy_state(batch, height=0.3, dtype=torch.float32, device=None):
    """Fresh JoyState for ``batch`` scenarios standing at ``height``."""
    return JoyState(
        body_height=torch.full((batch,), height, dtype=dtype, device=device),
        ctrl_state=torch.zeros((batch,), dtype=torch.int32, device=device),
        toggle_request=torch.zeros((batch,), dtype=torch.bool,
                                   device=device),
        exit_request=torch.zeros((batch,), dtype=torch.bool, device=device))


def clamp_axes(axes):
    """Apply the A1Params joystick limits (A1Params.h:16-23)."""
    clip = lambda v, m: torch.clamp(v, -m, m)
    return axes._replace(
        velx=clip(axes.velx, P.JOY_CMD_VELX_MAX),
        vely=clip(axes.vely, P.JOY_CMD_VELY_MAX),
        velz=clip(axes.velz, P.JOY_CMD_BODY_HEIGHT_VEL),
        yaw_rate=clip(axes.yaw_rate, P.JOY_CMD_YAW_MAX),
        pitch_rate=clip(axes.pitch_rate, P.JOY_CMD_PITCH_MAX),
        roll_rate=clip(axes.roll_rate, P.JOY_CMD_ROLL_MAX))


def is_terminal_state(joint_pos):
    """(B,) bool: a joint at or past its position limit
    (GazeboA1ROS::isTerminalState, GazeboA1ROS.cpp:418-425; limits
    GazeboA1ROS.h:175-179).

    Args:
      joint_pos: (B, 12) joint angles, (hip, thigh, calf) x 4 legs.
    """
    limits = const(tuple(v for row in P.JOINT_POS_LIMITS for v in row),
                   joint_pos.dtype, joint_pos.device).reshape(3, 2)
    q = joint_pos.reshape(-1, P.NUM_LEG, 3)
    return torch.any(((q <= limits[:, 0]) | (q >= limits[:, 1])).reshape(
        q.shape[0], -1), dim=-1)


def apply_commands(joy, axes, ctrl, params, dt):
    """Process one joystick sample per scenario into the controller state
    (GazeboA1ROS.cpp:122-190): height integration, mode toggle with the
    leave-walk position lock, desired velocity / euler updates and the
    walking-mode xy lock. The xy gains of ``kp_linear`` are zeroed while
    translating and set to ``params.kp_linear``'s xy entries otherwise.

    Args:
      joy: JoyState; axes: JoyAxes (scaled; clamp_axes for the limits).
      ctrl: CtrlState (batch B); params: CtrlParams; dt: tick period, a
        float.

    Returns:
      (JoyState, CtrlState, CtrlParams): the new ``kp_linear`` is (B, 3),
      one row per scenario.
    """
    dtype = ctrl.root_pos.dtype
    height = torch.clamp(joy.body_height + axes.velz * dt,
                         P.JOY_CMD_BODY_HEIGHT_MIN, P.JOY_CMD_BODY_HEIGHT_MAX)
    new_state = torch.where(joy.toggle_request,
                            torch.remainder(joy.ctrl_state + 1, 2),
                            joy.ctrl_state)
    entering_stand = (new_state == 0) & (joy.ctrl_state == 1)
    walking = new_state == 1

    root_lin_vel_d = torch.stack([axes.velx, axes.vely, axes.velz],
                                 dim=-1).to(dtype)
    root_ang_vel_d = torch.stack(
        [axes.roll_rate, axes.pitch_rate, axes.yaw_rate], dim=-1).to(dtype)
    root_euler_d = ctrl.root_euler_d + root_ang_vel_d * dt
    root_pos_d = torch.cat([ctrl.root_pos_d[:, 0:2],
                            height[:, None].to(dtype)], dim=-1)
    xy_here = torch.cat([ctrl.root_pos[:, 0:2], height[:, None].to(dtype)],
                        dim=-1)
    # leaving walk: lock xy at the current position; walking with a
    # velocity command: keep refreshing the xy target and zero the xy gains
    translating = walking & (torch.linalg.norm(root_lin_vel_d[:, 0:2],
                                               dim=-1) > 0.05)
    root_pos_d = torch.where((entering_stand | translating)[:, None],
                             xy_here, root_pos_d)
    kp = params.kp_linear.expand(ctrl.root_pos.shape[0], 3)
    kp_linear = torch.cat([
        torch.where(translating[:, None], torch.zeros_like(kp[:, 0:2]),
                    kp[:, 0:2]), kp[:, 2:]], dim=-1)

    new_ctrl = ctrl._replace(
        movement_mode=walking.to(torch.int32),
        root_lin_vel_d=root_lin_vel_d, root_ang_vel_d=root_ang_vel_d,
        root_euler_d=root_euler_d, root_pos_d=root_pos_d)
    new_joy = JoyState(body_height=height,
                       ctrl_state=new_state.to(torch.int32),
                       toggle_request=torch.zeros_like(joy.toggle_request),
                       exit_request=axes.exit)
    return new_joy, new_ctrl, params._replace(kp_linear=kp_linear)

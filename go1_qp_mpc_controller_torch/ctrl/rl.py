"""RL policy controller: observation pipeline + policy + PD position targets.

Port of the JAX package's ``ctrl/rl.py`` (the go1_rl_ctrl_cpp stack),
batch first:

- observation assembly and scaling (Go1Observation.hpp:143-170),
- the 48-dim obs = 36 proprio + 12 previous actions feeding the actor
  (Go1RLController.cpp:78-119),
- action -> joint-position targets with scale/clip and fixed PD gains
  (Go1RLController.cpp:102-109, 149-166),
- the servo stand policy's 1000-step interpolation to the crouch pose
  (Go1RLController.cpp:121-146),
- the joystick A-button stand/walk switcher (SwitchController.hpp:11-69).

Every state field and tensor has a leading batch axis B. The functions
never read a value back to the host: :func:`rl_control_step` computes both
the walk and the servo path and selects per scenario, so a batch may mix
modes and a tick can be captured as a CUDA graph.
"""

from typing import NamedTuple

import torch

from go1_qp_mpc_controller_torch.models import policy as policy_lib
from go1_qp_mpc_controller_torch.utils.device import const, resolve_device

# scale factors (Go1Observation.hpp:51-63)
LIN_VEL_SCALE = 2.0
ANG_VEL_SCALE = 0.25
COMMAND_SCALE = (2.0, 2.0, 0.25)
DOF_VEL_SCALE = 0.05
CLIP_OBS = 100.0
# action post-processing (Go1RLController.hpp:84-88, Go1RLController.cpp:36-37)
CLIP_ACTION = 100.0
ACTION_SCALE = 0.25
CLIP_POSE_LOWER = (-0.9425, -0.4817, -2.6285) * 4
CLIP_POSE_UPPER = (0.9425, 2.7855, -0.9320) * 4
# default joint pose (Go1CtrlStates.hpp:74-78)
DEFAULT_JOINT_POS = (0.1, 0.8, -1.5, -0.1, 0.8, -1.5,
                     0.1, 1.0, -1.5, -0.1, 1.0, -1.5)
# PD gains (Go1RLController.cpp:78-86)
WALK_P_GAINS = (20.0, 50.0, 50.0) * 4
WALK_D_GAINS = (1.0, 2.0, 2.0) * 4
# servo stand (Go1RLController.cpp:121-146)
SERVO_TARGET = (0.1, 0.6, -1.3, -0.1, 0.6, -1.3,
                0.1, 0.6, -1.3, -0.1, 0.6, -1.3)
SERVO_P_GAINS = (20.0, 30.0, 60.0, 20.0, 30.0, 60.0,
                 20.0, 80.0, 140.0, 20.0, 80.0, 140.0)
SERVO_D_GAINS = (5.0, 8.0, 12.0) * 4
SERVO_DURATION = 1000.0


class RLControllerState(NamedTuple):
    prev_action: torch.Tensor       # (B, 12) previous clipped actions
    servo_motion_time: torch.Tensor  # (B,) interpolation counter
    servo_start_pose: torch.Tensor  # (B, 12) pose at servo-mode entry
    movement_mode: torch.Tensor     # (B,) int32: 0 stand/servo, 1 walk


class MotorCommand(NamedTuple):
    """Position-mode command (Go1RLController.cpp:149-166), each (B, 12)."""
    q: torch.Tensor       # target positions
    kp: torch.Tensor
    kd: torch.Tensor
    tau: torch.Tensor     # zero in RL mode


def _row(values, like):
    """A (12,) constant row on ``like``'s device and dtype."""
    return const(values, like.dtype, like.device)


def init_rl_state(batch, joint_pos=None, dtype=torch.float32, device=None):
    """Stand/servo start for ``batch`` scenarios. ``joint_pos`` (B, 12)
    seeds ``servo_start_pose`` and sets the dtype and device; without it
    the pose is zero and ``device=None`` is the CUDA card."""
    if joint_pos is not None:
        dtype, device = joint_pos.dtype, joint_pos.device
        start = joint_pos.clone()
    else:
        device = resolve_device(device)
        start = torch.zeros((batch, 12), dtype=dtype, device=device)
    if start.shape != (batch, 12):
        raise ValueError(f"joint_pos has shape {tuple(start.shape)}, "
                         f"not ({batch}, 12)")
    return RLControllerState(
        prev_action=torch.zeros((batch, 12), dtype=dtype, device=device),
        servo_motion_time=torch.zeros((batch,), dtype=dtype, device=device),
        servo_start_pose=start,
        movement_mode=torch.zeros((batch,), dtype=torch.int32,
                                  device=device))


def build_observation(root_rot_mat, root_rot_mat_z, root_lin_vel,
                      imu_ang_vel, command, joint_pos, joint_vel,
                      prev_action):
    """48-dim scaled+clipped observation (Go1Observation.hpp:150-166 +
    Go1RLController.cpp:94-96).

    Args:
      root_rot_mat, root_rot_mat_z: (B, 3, 3).
      root_lin_vel: (B, 3) world-frame velocity (estimator output).
      imu_ang_vel: (B, 3) body-frame gyro.
      command: (B, 3) = (cmd_velx, cmd_vely, cmd_yaw_rate).
      joint_pos, joint_vel, prev_action: (B, 12).

    Returns:
      (B, 48) observation.
    """
    base_vel = torch.einsum('...ba,...b->...a', root_rot_mat_z, root_lin_vel)
    gravity = -root_rot_mat[..., 2, :]    # R^T (-z_hat)
    ob = torch.cat([
        base_vel * LIN_VEL_SCALE,
        imu_ang_vel * ANG_VEL_SCALE,
        gravity,
        command * const(COMMAND_SCALE, command.dtype, command.device),
        joint_pos - _row(DEFAULT_JOINT_POS, joint_pos),
        joint_vel * DOF_VEL_SCALE,
    ], dim=-1)
    ob = torch.clamp(ob, -CLIP_OBS, CLIP_OBS)
    return torch.cat([ob, prev_action], dim=-1)


def _command(q, p_gains, d_gains):
    return MotorCommand(q=q, kp=_row(p_gains, q).expand_as(q),
                        kd=_row(d_gains, q).expand_as(q),
                        tau=torch.zeros_like(q))


def advance(rl_state, actor, obs):
    """Walk-mode policy step -> (new state, MotorCommand)
    (Go1RLController.cpp:78-119)."""
    action = torch.clamp(policy_lib.mlp_apply(actor, obs), -CLIP_ACTION,
                         CLIP_ACTION)
    target = action * ACTION_SCALE + _row(DEFAULT_JOINT_POS, action)
    target = torch.clamp(target, _row(CLIP_POSE_LOWER, target),
                         _row(CLIP_POSE_UPPER, target))
    return (rl_state._replace(prev_action=action),
            _command(target, WALK_P_GAINS, WALK_D_GAINS))


def advance_servo(rl_state, joint_pos):
    """Stand/servo mode: linear interpolation to the crouch pose over 1000
    ticks (Go1RLController.cpp:121-146)."""
    t = rl_state.servo_motion_time + 1.0
    percent = torch.clamp(t / SERVO_DURATION, 0.0, 1.0)[:, None]
    target = (joint_pos * (1.0 - percent)
              + _row(SERVO_TARGET, joint_pos) * percent)
    return (rl_state._replace(servo_motion_time=t),
            _command(target, SERVO_P_GAINS, SERVO_D_GAINS))


def switch_mode(rl_state, toggle_request):
    """Joystick A-button stand<->walk toggle (SwitchController.hpp:11-69);
    ``toggle_request`` is (B,) bool."""
    mode = rl_state.movement_mode
    new_mode = torch.where(toggle_request, 1 - mode, mode)
    # entering servo mode resets the interpolation clock
    reset = toggle_request & (new_mode == 0)
    return rl_state._replace(
        movement_mode=new_mode,
        servo_motion_time=torch.where(
            reset, torch.zeros_like(rl_state.servo_motion_time),
            rl_state.servo_motion_time))


def rl_control_step(rl_state, actor, root_rot_mat, root_rot_mat_z,
                    root_lin_vel, imu_ang_vel, command, joint_pos,
                    joint_vel):
    """Full RL tick: mode dispatch + observation + policy/servo.

    Both paths are computed and selected per scenario by its mode
    (branchless, as in the JAX package), so no value goes to the host.

    Returns:
      (new RLControllerState, MotorCommand, (B, 48) observation).
    """
    obs = build_observation(root_rot_mat, root_rot_mat_z, root_lin_vel,
                            imu_ang_vel, command, joint_pos, joint_vel,
                            rl_state.prev_action)
    walk_state, walk_cmd = advance(rl_state, actor, obs)
    servo_state, servo_cmd = advance_servo(rl_state, joint_pos)
    walking = rl_state.movement_mode == 1
    pick = lambda w, s: torch.where(walking[:, None], w, s)
    cmd = MotorCommand(q=pick(walk_cmd.q, servo_cmd.q),
                       kp=pick(walk_cmd.kp, servo_cmd.kp),
                       kd=pick(walk_cmd.kd, servo_cmd.kd),
                       tau=walk_cmd.tau)
    new_state = RLControllerState(
        prev_action=pick(walk_state.prev_action, rl_state.prev_action),
        servo_motion_time=torch.where(walking, rl_state.servo_motion_time,
                                      servo_state.servo_motion_time),
        servo_start_pose=rl_state.servo_start_pose,
        movement_mode=rl_state.movement_mode)
    return new_state, cmd, obs


class JointHistory(NamedTuple):
    """Rolling joint pos-error / velocity history stacks.

    The reference maintains num_history_stack frames via shift-and-append
    (Go1Observation.hpp:172-181, updateHistory); read oldest-first like
    the reference's head/tail layout.
    """
    pos_err: torch.Tensor   # (B, stack, 12)
    vel: torch.Tensor       # (B, stack, 12)


def init_joint_history(batch, num_stack=3, dtype=torch.float32,
                       device=None):
    device = resolve_device(device)
    zeros = torch.zeros((batch, num_stack, 12), dtype=dtype, device=device)
    return JointHistory(pos_err=zeros, vel=zeros.clone())


def update_joint_history(hist, joint_pos, joint_vel):
    """Shift-append one frame (Go1Observation.hpp:172-181)."""
    err = joint_pos - _row(DEFAULT_JOINT_POS, joint_pos)
    return JointHistory(
        pos_err=torch.cat([hist.pos_err[:, 1:], err[:, None]], dim=1),
        vel=torch.cat([hist.vel[:, 1:], joint_vel[:, None]], dim=1))

"""Closed-loop rollouts: controller + SRB plant, one tick at a time.

Port of the JAX package's ``envs/rollout.py`` (``init_carry``,
``rollout``, ``rollout_batched``). One loop step is one control tick:
read sensors, observe + EKF (kernel K2), plan, swing, the GRF solve,
torques, then one plant step. The JAX ``lax.scan`` becomes a Python loop.
Both rollouts run B robots at once:

- :func:`rollout_batched` routes the GRF solve over the whole batch
  (``controller.control_step_batched``), the batched-sweep program;
- :func:`rollout` gives each robot the per-scenario semantics of the JAX
  ``rollout`` (``controller.control_step``): MPC or balance-QP stance
  control, each scenario routed on its own. At batch 1 it is the
  single-robot 500 Hz loop.

:func:`rl_rollout` is the RL stack's closed loop (``init_rl_carry``):
policy or servo stand -> position commands -> the plant's motor PD loop.
It launches none of the counted kernels, so on the card each of its ticks
is one CUDA graph replay (``utils/graphs.CapturedStep``).
"""

from typing import NamedTuple

import numpy as np
import torch

from go1_qp_mpc_controller_torch.ctrl import controller
from go1_qp_mpc_controller_torch.ctrl import rl as rl_lib
from go1_qp_mpc_controller_torch.envs import srb_sim
from go1_qp_mpc_controller_torch.models import types
from go1_qp_mpc_controller_torch.ops import admm, ekf
from go1_qp_mpc_controller_torch.utils import graphs, rotations
from go1_qp_mpc_controller_torch.utils.device import resolve_device


class RolloutCarry(NamedTuple):
    ctrl: types.CtrlState
    sim: srb_sim.SimState
    stance_forces_z: torch.Tensor  # (B, 4) last applied normal forces


class RolloutTrace(NamedTuple):
    """Per-tick records, each (T, B, ...)."""
    root_pos: torch.Tensor
    root_euler: torch.Tensor
    root_lin_vel: torch.Tensor
    joint_torques: torch.Tensor
    foot_forces_grf: torch.Tensor
    contacts: torch.Tensor
    est_root_pos: torch.Tensor
    terrain_pitch: torch.Tensor
    foot_pos_abs: torch.Tensor


def init_carry(model, params, batch, height=0.3, movement_mode=0,
               dtype=torch.float32, device=None, ground_coef=None,
               horizon=None):
    """Standing start for ``batch`` scenarios: the plant at ``height`` and
    the controller state synced to it.

    ``device=None`` places the carry on the CUDA card and raises when there
    is none; ``model`` must live on the same device. ``horizon`` sizes the
    warm-carry fields (``types.init_ctrl_state``); a value other than 10
    selects the stagewise long-horizon controller path.
    """
    device = resolve_device(device)
    if model.mass.device != device or model.mass.dtype != dtype:
        raise ValueError(f"the model lives on {model.mass.device} / "
                         f"{model.mass.dtype}, the carry on {device} / "
                         f"{dtype}")
    sim = srb_sim.init_sim_state(model, batch, height, ground_coef)
    kw = {} if horizon is None else {"horizon": horizon}
    ctrl = types.init_ctrl_state(model, batch, dtype, device, **kw)
    feet_body = sim.foot_pos_world - sim.root_pos[:, None]
    ekf_x, ekf_p = ekf.init_state(sim.root_rot, feet_body)
    ctrl = ctrl._replace(
        movement_mode=torch.full((batch,), movement_mode, dtype=torch.int32,
                                 device=device),
        root_pos=sim.root_pos.clone(),
        root_pos_d=sim.root_pos.clone(),
        foot_pos_start=feet_body,
        foot_pos_rel_last_time=feet_body,
        foot_pos_target_last_time=feet_body,
        foot_pos_recent_contact=feet_body,
        estimator_x=ekf_x,
        estimator_P=ekf_p)
    weight = model.mass * 9.8 / 4.0
    return RolloutCarry(ctrl=ctrl, sim=sim,
                        stance_forces_z=weight.expand(batch, 4).clone())


def _run(carry, model, params, num_steps, dt, command_fn, estimate,
         ground_coef, control):
    """The closed loop: ``control(ctrl)`` is the controller tick after the
    sensor update. Returns (carry, RolloutTrace), leaves (T, B, ...)."""
    dt = float(dt)
    records = []
    for step_idx in range(num_steps):
        ctrl, sim = carry.ctrl, carry.sim
        if command_fn is not None:
            ctrl = command_fn(step_idx, ctrl)
        sensors = srb_sim.read_sensors(sim, model, ctrl.contacts,
                                       carry.stance_forces_z, dt)
        ctrl = controller.sensor_update(ctrl, model, sensors, dt,
                                        estimate=estimate)
        if not estimate:
            ctrl = ctrl._replace(root_pos=sim.root_pos,
                                 root_lin_vel=sim.root_lin_vel)
        ctrl = control(ctrl)
        sim_new, forces_z = srb_sim.step(
            sim, model, ctrl.joint_torques, ctrl.contacts,
            ctrl.foot_pos_target_last_time, dt, ground_coef=ground_coef)
        records.append(RolloutTrace(
            root_pos=sim_new.root_pos, root_euler=ctrl.root_euler,
            root_lin_vel=sim_new.root_lin_vel,
            joint_torques=ctrl.joint_torques,
            foot_forces_grf=ctrl.foot_forces_grf, contacts=ctrl.contacts,
            est_root_pos=ctrl.root_pos,
            terrain_pitch=ctrl.terrain_pitch_angle,
            foot_pos_abs=ctrl.foot_pos_abs))
        carry = RolloutCarry(ctrl=ctrl, sim=sim_new,
                             stance_forces_z=forces_z)
    if not records:
        raise ValueError("a rollout needs num_steps >= 1")
    trace = RolloutTrace(*[torch.stack(leaves) for leaves in zip(*records)])
    return carry, trace


def rollout(carry, model, params, num_steps, dt,
            solver_type=controller.MPC, settings=admm.ADMMSettings(),
            command_fn=None, estimate=True, use_terrain_adapt=True,
            ground_coef=None, warm_settings=controller.WARM_SETTINGS,
            warm_mode="auto", horizon=None, stats=None):
    """Run ``num_steps`` closed-loop ticks, each robot of the batch with
    the per-scenario controller (``controller.control_step``).

    Args:
      carry: RolloutCarry from :func:`init_carry` (batch 1 for one robot).
      dt: control / plant period (the reference's 2 ms loop), a float.
      solver_type: ``controller.MPC`` or ``controller.QP``.
      settings: the GRF solves' cold settings (the default polished
        settings take the dense solve).
      command_fn: optional (step_idx, ctrl_state) -> ctrl_state applied to
        the batched controller state before each tick.
      estimate: True runs the EKF (kernel K2) in the loop; False feeds the
        plant's ground truth.
      horizon: the MPC horizon; a value other than 10 routes the GRF solve
        to the stagewise O(H) solver (the carry must come from
        ``init_carry(horizon=...)``).
      stats: optional dict counting the scenarios of each GRF route.

    Returns:
      (carry, RolloutTrace) with trace leaves (T, B, ...).
    """
    return _run(carry, model, params, num_steps, dt, command_fn, estimate,
                ground_coef, lambda ctrl: controller.control_step(
                    ctrl, model, params, float(dt), solver_type=solver_type,
                    settings=settings, use_terrain_adapt=use_terrain_adapt,
                    warm_settings=warm_settings, warm_mode=warm_mode,
                    horizon=horizon, stats=stats))


def rollout_batched(carry, model, params, num_steps, dt,
                    settings=admm.ADMMSettings(), command_fn=None,
                    estimate=True, use_terrain_adapt=True,
                    ground_coef=None,
                    warm_settings=controller.WARM_SETTINGS,
                    robust=False, compact_k=128, stats=None):
    """Run ``num_steps`` closed-loop ticks over a batched carry with the
    batch-level GRF routing (``controller.control_step_batched``).

    Args:
      carry: RolloutCarry from :func:`init_carry`.
      dt: control / plant period (the reference's 2 ms loop), a float.
      settings: cold transition-solve settings.
      command_fn: optional (step_idx, ctrl_state) -> ctrl_state applied to
        the batched controller state before each tick.
      estimate: True runs the EKF (kernel K2) in the loop; False feeds the
        plant's ground truth.
      stats: optional dict counting the GRF route of each tick.

    Returns:
      (carry, RolloutTrace) with trace leaves (T, B, ...).
    """
    return _run(carry, model, params, num_steps, dt, command_fn, estimate,
                ground_coef, lambda ctrl: controller.control_step_batched(
                    ctrl, model, params, float(dt), settings=settings,
                    use_terrain_adapt=use_terrain_adapt,
                    warm_settings=warm_settings, robust=robust,
                    compact_k=compact_k, stats=stats))


class RLRolloutCarry(NamedTuple):
    rl: rl_lib.RLControllerState
    sim: srb_sim.SimState
    stance_forces_z: torch.Tensor  # (B, 4)


class RLRolloutTrace(NamedTuple):
    """Per-tick records, each (T, B, ...)."""
    obs: torch.Tensor            # (T, B, 48)
    target_q: torch.Tensor       # (T, B, 12) commanded joint positions
    kp: torch.Tensor             # (T, B, 12) commanded gains (by mode)
    root_pos: torch.Tensor       # (T, B, 3)
    movement_mode: torch.Tensor  # (T, B)


def init_rl_carry(model, batch, height=0.3, dtype=torch.float32,
                  device=None):
    """Standing start for the RL stack (stand/servo mode), ``batch``
    scenarios on ``device`` (None: the CUDA card; ``model`` must live
    there in ``dtype``)."""
    device = resolve_device(device)
    if model.mass.device != device or model.mass.dtype != dtype:
        raise ValueError(f"the model lives on {model.mass.device} / "
                         f"{model.mass.dtype}, the carry on {device} / "
                         f"{dtype}")
    sim = srb_sim.init_sim_state(model, batch, height)
    rl = rl_lib.init_rl_state(batch, sim.prev_joint_pos)
    weight = model.mass * 9.8 / 4.0
    return RLRolloutCarry(rl=rl, sim=sim,
                          stance_forces_z=weight.expand(batch, 4).clone())


def rl_rollout(carry, model, actor, num_steps, dt, command_fn=None,
               toggle_fn=None):
    """Closed-loop RL rollout: policy -> position PD plant.

    The mirror of the reference's RL process
    (go1_rl_ctrl_cpp/src/MainGazebo.cpp:22-144): each tick observes the
    plant, runs SwitchController + Go1RLController::advance /
    advance_servo, and steps the plant through the motor PD loop the
    position commands drive (Go1RLController.cpp:149-166). The plant keeps
    the all-stance schedule (the RL stack plans no gait; physics owns
    contact).

    Args:
      carry: RLRolloutCarry from :func:`init_rl_carry`.
      actor: ``models/policy.ActorMLP`` on the carry's device.
      num_steps: ticks to run.
      dt: RL action period, a float (reference: 4 ms Gazebo / 2.5 ms
        hardware, config/parameters.yaml:9-11).
      command_fn: optional step_idx -> (cmd_vx, cmd_vy, cmd_yaw_rate), a
        (3,) or (B, 3) array-like, evaluated on the host each tick.
      toggle_fn: optional step_idx -> A-button press
        (SwitchController.hpp:11-69), a bool or (B,) bools, evaluated on
        the host each tick.

    Returns:
      (carry, RLRolloutTrace) with trace leaves (T, B, ...).
    """
    if num_steps < 1:
        raise ValueError("a rollout needs num_steps >= 1")
    dt = float(dt)
    sim0 = carry.sim
    batch, dtype, device = (sim0.root_pos.shape[0], sim0.root_pos.dtype,
                            sim0.root_pos.device)
    contacts = torch.ones((batch, 4), dtype=torch.bool, device=device)
    stand_targets = sim0.foot_pos_world - sim0.root_pos[:, None]

    def tick(c, inputs):
        """One tick; ``inputs`` (B, 4) holds the command and the press."""
        sensors = srb_sim.read_sensors(c.sim, model, contacts,
                                       c.stance_forces_z, dt)
        rot = rotations.quat_to_rot_mat(sensors.quat_wxyz)
        euler = rotations.quat_to_euler(sensors.quat_wxyz)
        rl = rl_lib.switch_mode(c.rl, inputs[:, 3] != 0.0)
        # plant ground-truth velocity: the estimation thread's role
        # (Go1Observation.hpp:392-424); runtime/rl_loop.py runs the EKF
        rl, cmd, obs = rl_lib.rl_control_step(
            rl, actor, rot, rotations.rot_z(euler[:, 2]),
            c.sim.root_lin_vel, sensors.imu_ang_vel, inputs[:, :3],
            sensors.joint_pos, sensors.joint_vel)
        sim, fz = srb_sim.step_pd(c.sim, model, cmd.q, cmd.kp, cmd.kd,
                                  cmd.tau, contacts, stand_targets, dt)
        trace = RLRolloutTrace(obs=obs, target_q=cmd.q, kp=cmd.kp,
                               root_pos=sim.root_pos,
                               movement_mode=rl.movement_mode)
        return RLRolloutCarry(rl=rl, sim=sim, stance_forces_z=fz), trace

    def host_inputs(i):
        row = np.zeros((batch, 4))
        if command_fn is not None:
            row[:, :3] = np.asarray(command_fn(i), np.float64)
        if toggle_fn is not None:
            row[:, 3] = np.asarray(toggle_fn(i), bool)
        return torch.as_tensor(row, dtype=dtype).to(device)

    step = graphs.CapturedStep(tick, carry, torch.zeros(
        (batch, 4), dtype=dtype, device=device))
    records = []
    for i in range(num_steps):
        # the outputs are the graph's buffers, which the next replay
        # overwrites: the carry goes back in as the next inputs (copied
        # before the replay), the trace is copied out
        carry, trace = step(carry, host_inputs(i))
        records.append(graphs.clone(trace))
    trace = RLRolloutTrace(*[torch.stack(leaves) for leaves in zip(*records)])
    return graphs.clone(carry), trace

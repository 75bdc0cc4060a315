"""Closed-loop rollouts: controller + SRB plant, one tick at a time.

Port of the JAX package's ``envs/rollout.py`` (``init_carry``,
``rollout``, ``rollout_batched``). One loop step is one control tick:
read sensors, observe + EKF (kernel K2), plan, swing, the GRF solve,
torques, then one plant step. The JAX ``lax.scan`` becomes a Python loop.
Both rollouts run B robots at once:

- :func:`rollout_batched` routes the GRF solve over the whole batch
  (``controller.control_step_batched``), the batched-sweep program: each
  tick is :func:`tick_batched_parts` (fixed-shape parts between the
  routing's two host reads), replayed on the card from captured CUDA
  graphs;
- :func:`rollout` gives each robot the per-scenario semantics of the JAX
  ``rollout`` (``controller.control_step``): MPC or balance-QP stance
  control, each scenario routed on its own. At batch 1 it is the
  single-robot 500 Hz loop, each tick replayed on the card from captured
  CUDA graphs (:func:`tick_parts`: one up to the route code, one per
  route), the counterpart of the JAX ``lax.scan`` body.

:func:`rl_rollout` is the RL stack's closed loop (``init_rl_carry``):
policy or servo stand -> position commands -> the plant's motor PD loop.
It launches none of the counted kernels, so on the card each of its ticks
is one CUDA graph replay (a one-part ``utils/graphs.StagedStep``).
"""

import collections
from typing import NamedTuple

import numpy as np
import torch

from go1_qp_mpc_controller_torch.config import params as P
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


def _sense(carry, model, dt, estimate):
    """The tick's sensor half: read the plant, then the observe + EKF
    stage (K2), or the plant's ground truth without ``estimate``."""
    ctrl, sim = carry.ctrl, carry.sim
    sensors = srb_sim.read_sensors(sim, model, ctrl.contacts,
                                   carry.stance_forces_z, dt)
    ctrl = controller.sensor_update(ctrl, model, sensors, dt,
                                    estimate=estimate)
    if not estimate:
        ctrl = ctrl._replace(root_pos=sim.root_pos,
                             root_lin_vel=sim.root_lin_vel)
    return ctrl


def _plant(carry, ctrl, model, dt, ground_coef):
    """The tick's plant half: one ``srb_sim.step`` on the controller's
    torques. Returns (next RolloutCarry, the tick's RolloutTrace record)."""
    sim_new, forces_z = srb_sim.step(
        carry.sim, model, ctrl.joint_torques, ctrl.contacts,
        ctrl.foot_pos_target_last_time, dt, ground_coef=ground_coef)
    record = RolloutTrace(
        root_pos=sim_new.root_pos, root_euler=ctrl.root_euler,
        root_lin_vel=sim_new.root_lin_vel,
        joint_torques=ctrl.joint_torques,
        foot_forces_grf=ctrl.foot_forces_grf, contacts=ctrl.contacts,
        est_root_pos=ctrl.root_pos,
        terrain_pitch=ctrl.terrain_pitch_angle,
        foot_pos_abs=ctrl.foot_pos_abs)
    return RolloutCarry(ctrl=ctrl, sim=sim_new,
                        stance_forces_z=forces_z), record


def _stacked(records):
    if not records:
        raise ValueError("a rollout needs num_steps >= 1")
    return RolloutTrace(*[torch.stack(leaves) for leaves in zip(*records)])


def _run(carry, model, params, num_steps, dt, command_fn, estimate,
         ground_coef, control):
    """The closed loop: ``control(ctrl)`` is the controller tick after the
    sensor update. Returns (carry, RolloutTrace), leaves (T, B, ...)."""
    dt = float(dt)
    records = []
    for step_idx in range(num_steps):
        if command_fn is not None:
            carry = carry._replace(ctrl=command_fn(step_idx, carry.ctrl))
        ctrl = control(_sense(carry, model, dt, estimate))
        carry, record = _plant(carry, ctrl, model, dt, ground_coef)
        records.append(record)
    return carry, _stacked(records)


def _sensed(dt, estimate):
    """The sensor half (:func:`_sense`) as ``graphs.nest``'s ``enter`` over
    ``(carry, model, params, *ground)``."""
    return lambda args: (_sense(args[0], args[1], dt, estimate),) + args[1:3]


def _planted(dt):
    """The plant step (:func:`_plant`) as ``graphs.nest``'s ``leave`` on a
    controller part's (states, ...): (carry, record, ...)."""
    def leave(args, out):
        ground = args[3] if len(args) > 3 else None
        return (*_plant(args[0], out[0], args[1], dt, ground), *out[1:])
    return leave


def tick_parts(dt, solver_type=controller.MPC,
               settings=admm.ADMMSettings(), estimate=True,
               use_terrain_adapt=True,
               warm_settings=controller.WARM_SETTINGS, warm_mode="auto"):
    """:func:`rollout`'s per-scenario tick (the horizon-10 MPC or the
    balance QP) as ``graphs.Stages`` over ``(carry, model, params,
    *ground)`` (``ground``: the terrain coefficients, when there are any):
    ``controller.tick_parts`` between the sensor half (:func:`_sense`) and
    the plant step; either composition returns (carry, record).
    :func:`rollout` captures them at batch 1 on the card. ``dt`` is a
    float."""
    dt = float(dt)
    return graphs.nest(
        controller.tick_parts(dt, solver_type, settings, use_terrain_adapt,
                              warm_settings, warm_mode),
        _sensed(dt, estimate), _planted(dt))


def tick_batched_parts(dt, settings=admm.ADMMSettings(), estimate=True,
                       use_terrain_adapt=True,
                       warm_settings=controller.WARM_SETTINGS, robust=False,
                       compact_k=128):
    """:func:`rollout_batched`'s tick as ``graphs.Stages`` over ``(carry,
    model, params, *ground)``: ``controller.tick_batched_parts`` between
    the sensor half (:func:`_sense`) and the plant step; its composition
    returns (carry, record). :func:`rollout_batched` captures them on the
    card. ``dt`` is a float."""
    dt = float(dt)
    return graphs.nest(
        controller.tick_batched_parts(dt, settings, use_terrain_adapt,
                                      warm_settings, robust, compact_k),
        _sensed(dt, estimate), _planted(dt))


# captured ticks by static configuration (most recently used last), so
# that many short rollouts of one configuration capture once; _CAPTURES
# holds each key's (captures, card memory its last capture reserved),
# which chip_smoke.py prints. chip_smoke.py's phases use 6 one-robot
# configurations, none captured twice, each reserving up to ~170 MiB on
# an H100: _KEEP leaves room for two more. A batched tick's capture holds
# the batch's carry several times over (GiBs at 4096 robots): at most
# _KEEP_BATCHED of those are kept, the older evicted before a capture
_CAPTURED = collections.OrderedDict()
_CAPTURES = {}
_KEEP = 8
_KEEP_BATCHED = 1


def _batched(key):
    """Whether a cache key's step is :func:`rollout_batched`'s tick."""
    return key[0][0] == "batched"


def cached_step(config, parts, args):
    """``graphs.StagedStep`` of ``parts``; on the card kept under the static
    ``config`` and the shapes, dtypes and device of ``args``, the
    ``_KEEP`` most recently used one-robot steps and the
    ``_KEEP_BATCHED`` most recently used batched ones. The steps are
    shared: two callers of one configuration, in two threads or one
    inside the other, would overwrite each other's buffers."""
    leaves, _ = graphs.flatten(args)
    if not leaves[0].is_cuda:
        return graphs.StagedStep(parts, *args)
    key = (config, leaves[0].device,
           tuple((t.shape, t.dtype) for t in leaves))
    step = _CAPTURED.pop(key, None)
    if step is None:
        # the steps evicted first, so that their memory is free for this
        # capture
        kind = _batched(key)
        same = [k for k in _CAPTURED if _batched(k) == kind]
        for old in same[:max(0, len(same) + 1
                             - (_KEEP_BATCHED if kind else _KEEP))]:
            del _CAPTURED[old]
        # a capture empties the allocator's cache first (torch.cuda.graph):
        # so does this, so that the difference is the capture's own
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(key[1])
        step = graphs.StagedStep(parts, *args)
        _CAPTURES[key] = (_CAPTURES.get(key, (0, 0))[0] + 1,
                          torch.cuda.memory_reserved(key[1]) - reserved)
    _CAPTURED[key] = step
    return step


def _run_captured(carry, model, params, num_steps, command_fn, ground_coef,
                  stats, parts, config):
    """:func:`_run` through ``parts`` (:func:`tick_parts` for one robot,
    :func:`tick_batched_parts` for a batch): on the card each tick
    replays captured steps (kept under ``config``), on the CPU it is their
    plain composition."""
    extra = () if ground_coef is None else (torch.as_tensor(
        ground_coef, dtype=carry.sim.root_pos.dtype,
        device=carry.sim.root_pos.device),)
    if num_steps < 1:
        raise ValueError("a rollout needs num_steps >= 1")
    step = trace = None
    for step_idx in range(num_steps):
        if command_fn is not None:
            carry = carry._replace(ctrl=command_fn(step_idx, carry.ctrl))
        args = (carry, model, params) + extra
        if step is None:
            step = cached_step(config, parts, args)
        # the outputs are the graphs' buffers, which the next replay
        # overwrites: the carry goes back in as the next inputs (copied
        # before the replay), the record is copied out into the trace
        carry, record = controller.run_tick(step, args, stats)
        if trace is None:
            trace = type(record)(*[t.new_empty((num_steps,) + t.shape)
                                   for t in record])
        graphs.copy_all([t[step_idx] for t in trace], record)
    return graphs.clone(carry), trace


def rollout(carry, model, params, num_steps, dt,
            solver_type=controller.MPC, settings=admm.ADMMSettings(),
            command_fn=None, estimate=True, use_terrain_adapt=True,
            ground_coef=None, warm_settings=controller.WARM_SETTINGS,
            warm_mode="auto", horizon=None, stats=None):
    """Run ``num_steps`` closed-loop ticks, each robot of the batch with
    the per-scenario controller (``controller.control_step``).

    At batch 1 a tick is :func:`tick_parts`' composition: on the card one
    captured ``pre`` step, one read of its route code and one captured
    branch (and in "auto" ``warm_mode``, after a warm or window branch, a
    health read and the re-solve it may call for), the counterpart of the
    JAX package's jitted ``lax.scan`` body; the captures are kept by
    static configuration and shared, so a batch-1 rollout is not
    thread-safe (nor reentrant from ``command_fn``) on the card.
    ``command_fn`` runs on the host before each tick. A larger batch, and
    the stagewise ``horizon``, run the eager loop.

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
    stagewise = (solver_type == controller.MPC
                 and horizon not in (None, P.PLAN_HORIZON))
    if carry.sim.root_pos.shape[0] == 1 and not stagewise:
        config = (float(dt), solver_type, settings, estimate,
                  use_terrain_adapt, warm_settings, warm_mode)
        return _run_captured(carry, model, params, num_steps, command_fn,
                             ground_coef, stats, tick_parts(*config), config)
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

    A tick is the sensor half, ``control_step_batched`` and the plant
    step, as the parts of :func:`tick_batched_parts`: the sensor half up
    to the transition count, its host read, a base program up to the flag
    count, its host read, and one terminal route (two parts when the
    transitions alone overflow the compacted sub-batch). On the card each
    part replays a captured CUDA graph; the captures are kept by static
    configuration and shared, so a rollout on the card is not thread-safe
    (nor reentrant from ``command_fn``). Off the card the parts run
    plainly (``graphs.compose_stages``).

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
    config = ("batched", float(dt), settings, estimate, use_terrain_adapt,
              warm_settings, robust, compact_k)
    return _run_captured(carry, model, params, num_steps, command_fn,
                         ground_coef, stats, tick_batched_parts(*config[1:]),
                         config)


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

    step = graphs.StagedStep(graphs.single(tick), carry, torch.zeros(
        (batch, 4), dtype=dtype, device=device))
    records = []
    for i in range(num_steps):
        # the outputs are the graph's buffers, which the next replay
        # overwrites: the carry goes back in as the next inputs (copied
        # before the replay), the trace is copied out
        carry, trace = step(carry, host_inputs(i))[1]
        records.append(graphs.clone(trace))
    trace = RLRolloutTrace(*[torch.stack(leaves) for leaves in zip(*records)])
    return graphs.clone(carry), trace

"""Closed-loop rollouts: controller + SRB plant, one tick at a time, plain
PyTorch in the input's dtype. One loop step is one control tick: read
sensors, observe + EKF (K2's plain version), plan, swing, the GRF solve,
torques, then one plant step; the JAX ``lax.scan`` becomes a Python loop.
:func:`rollout_batched` routes the GRF solve over the whole batch
(``controller.control_step_batched``); :func:`_run` with
``controller.control_step`` gives each robot the per-scenario routing.
"""

from typing import NamedTuple

import torch

from reference.go1.ctrl import controller
from reference.go1.envs import srb_sim
from reference.go1.models import types
from reference.go1.ops import admm


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


def rollout_batched(carry, model, params, num_steps, dt,
                    settings=admm.ADMMSettings(), command_fn=None,
                    estimate=True, use_terrain_adapt=True,
                    ground_coef=None,
                    warm_settings=controller.WARM_SETTINGS,
                    robust=False, compact_k=128, stats=None):
    """Run ``num_steps`` closed-loop ticks over a batched carry with the
    batch-level GRF routing (``controller.control_step_batched``).

    Args:
      carry: RolloutCarry.
      dt: control / plant period (the reference's 2 ms loop), a float.
      settings: cold transition-solve settings.
      command_fn: optional (step_idx, ctrl_state) -> ctrl_state applied to
        the batched controller state before each tick.
      estimate: True runs the EKF (K2's plain version) in the loop; False feeds the
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

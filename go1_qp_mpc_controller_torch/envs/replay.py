"""Sensor-log replay harness and signal recording.

Port of the JAX package's ``envs/replay.py``, the equivalents of two
reference subsystems:

- the Gazebo adapter as an offline test harness (GazeboA1ROS.cpp:112-239):
  :func:`replay_rollout` feeds a recorded sensor stream through the full
  controller, batch first: controller regression testing against logs
  without a simulator in the loop. At batch 1 with the EKF it runs the
  one-robot path's kernels (K2 for observe + EKF; K1, K3 and K6 in the GRF
  solves);
- the data_collection package's joint-signal logger and sine replay
  (src/data_collection/src/HighLevel.cpp:8-50, signal_sine.cpp):
  :class:`SignalLog` records named channels to .npz,
  :func:`sine_joint_signal` generates the replay excitation pattern, and
  :func:`load_recorded_signal` / :func:`save_recorded_signal` read and
  write the reference's fixed-width text logs (the same files as the JAX
  package's).
"""

from typing import NamedTuple

import numpy as np
import torch

from go1_qp_mpc_controller_torch.ctrl import controller
from go1_qp_mpc_controller_torch.envs import rollout, srb_sim
from go1_qp_mpc_controller_torch.ops import admm
from go1_qp_mpc_controller_torch.utils import graphs
from go1_qp_mpc_controller_torch.utils.device import resolve_device


class SensorLog(NamedTuple):
    """A time-stacked ``controller.SensorData`` stream, (T, B, ...)
    leaves."""
    quat_wxyz: torch.Tensor
    imu_acc: torch.Tensor
    imu_ang_vel: torch.Tensor
    joint_pos: torch.Tensor
    joint_vel: torch.Tensor
    foot_force: torch.Tensor


def sensor_log_from_arrays(dtype=torch.float32, device=None, **kw):
    """A :class:`SensorLog` from (T, B, ...) arrays, one keyword a field,
    on ``device`` (None: the CUDA card) in ``dtype``."""
    device = resolve_device(device)
    return SensorLog(**{k: torch.as_tensor(np.asarray(v)).to(
        device=device, dtype=dtype) for k, v in kw.items()})


def replay_parts(dt, solver_type=controller.MPC,
                 settings=admm.ADMMSettings(), use_terrain_adapt=True,
                 estimate=True):
    """:func:`replay_rollout`'s tick as ``graphs.Stages`` over ``(state,
    model, params, sensors)``: ``controller.tick_parts`` after the sensor
    update; either composition returns (state,). ``dt`` is a float."""
    return graphs.nest(
        controller.tick_parts(dt, solver_type, settings, use_terrain_adapt),
        lambda args: (controller.sensor_update(args[0], args[1], args[3], dt,
                                               estimate=estimate),
                      args[1], args[2]),
        lambda args, out: out)


def replay_rollout(ctrl_state, model, params, log, dt,
                   solver_type=controller.MPC,
                   settings=admm.ADMMSettings(), use_terrain_adapt=True,
                   estimate=True):
    """Run the controller over a recorded sensor stream.

    At batch 1 each tick is :func:`replay_parts`' composition, captured on
    the card as ``rollout.rollout``'s tick is (the same controller parts,
    kept by static configuration and shared: not thread-safe); a larger
    batch runs the eager tick.

    Args:
      ctrl_state: initial batched CtrlState (batch B).
      model, params: RobotModel / CtrlParams.
      log: SensorLog with (T, B, ...) leaves.
      dt: control period matching the log cadence, a float.

    Returns:
      (final CtrlState, dict of (T, B, ...) traces: joint_torques,
      foot_forces_grf, contacts, root_pos_est).
    """
    dt = float(dt)
    state = ctrl_state
    config = ("replay", dt, solver_type, settings, use_terrain_adapt,
              estimate)
    step = None
    records = []
    for t in range(log.quat_wxyz.shape[0]):
        sensors = controller.SensorData(*[leaf[t] for leaf in log])
        if state.root_pos.shape[0] != 1:
            state = controller.sensor_update(state, model, sensors, dt,
                                             estimate=estimate)
            state = controller.control_step(
                state, model, params, dt, solver_type=solver_type,
                settings=settings, use_terrain_adapt=use_terrain_adapt)
        else:
            args = (state, model, params, sensors)
            if step is None:
                step = rollout.cached_step(config, replay_parts(*config[1:]),
                                           args)
            # the graphs' buffers: the state goes back in as the next
            # inputs, the records are copied out
            state, = controller.run_tick(step, args)
        records.append(graphs.clone((state.joint_torques,
                                     state.foot_forces_grf, state.contacts,
                                     state.root_pos)))
    if not records:
        raise ValueError("the sensor log holds no tick")
    names = ("joint_torques", "foot_forces_grf", "contacts", "root_pos_est")
    return graphs.clone(state), {name: torch.stack(leaves)
                                 for name, leaves in zip(names, zip(*records))}


class SignalLog:
    """Named-channel signal recorder -> .npz (the data_collection logger).

    Collects per-tick values host-side; intended for low-rate debugging
    and hardware experiments, not the hot path.
    """

    def __init__(self):
        self._channels = {}

    def append(self, name, value):
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        self._channels.setdefault(name, []).append(np.asarray(value))

    def stacked(self, name):
        return np.stack(self._channels[name])

    def save(self, path):
        np.savez_compressed(
            path, **{k: np.stack(v) for k, v in self._channels.items()})

    @staticmethod
    def load(path):
        with np.load(path) as data:
            log = SignalLog()
            for k in data.files:
                log._channels[k] = list(data[k])
        return log


def sine_joint_signal(num_steps, dt, amplitude=0.3, freq_hz=0.5,
                      base_pose=None):
    """Sinusoidal 12-joint excitation like data_collection's replayed
    qSineSignal.txt (src/data_collection/data): per-joint phase-offset
    sines around a base pose.

    Returns:
      (num_steps, 12) float64 joint position targets.
    """
    base = (np.array([0.0, 0.9, -1.8] * 4) if base_pose is None
            else np.asarray(base_pose))
    t = np.arange(num_steps)[:, None] * dt
    phase = np.arange(12)[None, :] * (np.pi / 6)
    return base[None, :] + amplitude * np.sin(
        2 * np.pi * freq_hz * t + phase)


def load_recorded_signal(path, num_joints=12):
    """Load a recorded joint-signal log in the data_collection format
    (src/data_collection/data/qSineSignal.txt, written by
    signal_sine.cpp's saveSignalAsFile as whitespace-separated fixed-width
    columns).

    Returns:
      (T, num_joints) float64 array of joint positions.
    """
    q = np.loadtxt(path, dtype=np.float64)
    if q.ndim == 1:
        q = q.reshape(-1, num_joints)
    if q.shape[1] != num_joints:
        raise ValueError(
            f"expected {num_joints} columns, got {q.shape[1]} in {path}")
    return q


def save_recorded_signal(path, q_signal):
    """Write a joint-signal log in the data_collection fixed-width format
    (``%11.6f``; round-trips through :func:`load_recorded_signal`, the JAX
    package's loader and the reference's own reader)."""
    np.savetxt(path, np.asarray(q_signal), fmt="%11.6f", delimiter=" ")


def replay_joint_signal(q_signal, model, dt, kp=180.0, kd=8.0, height=0.3):
    """Replay a recorded joint-position log onto the PD plant.

    The equivalent of the data_collection Lowlevel replay (signal_sine.cpp
    semantics: position-mode commands through the motor PD loop at fixed
    gains). Each tick is one ``srb_sim.step_pd``, one CUDA graph replay on
    the card (no counted kernel).

    Args:
      q_signal: (T, 12) joint position targets (e.g. from
        :func:`load_recorded_signal`), one robot, or (T, B, 12).
      model: RobotModel; its device and dtype are the plant's.
      dt: replay period, a float.

    Returns:
      dict with the realized (T, B, 12) joint positions and (T, B, 3) root
      path.
    """
    dt = float(dt)
    dtype, device = model.mass.dtype, model.mass.device
    q_signal = torch.as_tensor(np.asarray(q_signal)).to(device=device,
                                                         dtype=dtype)
    if q_signal.ndim == 2:
        q_signal = q_signal[:, None]
    batch = q_signal.shape[1]
    sim = srb_sim.init_sim_state(model, batch, height)
    contacts = torch.ones((batch, 4), dtype=torch.bool, device=device)
    stand_targets = sim.foot_pos_world - sim.root_pos[:, None]
    kp_v = torch.full((batch, 12), kp, dtype=dtype, device=device)
    kd_v = torch.full((batch, 12), kd, dtype=dtype, device=device)
    zero_tau = torch.zeros((batch, 12), dtype=dtype, device=device)

    def tick(sm, q_t):
        sm, _ = srb_sim.step_pd(sm, model, q_t, kp_v, kd_v, zero_tau,
                                contacts, stand_targets, dt)
        return sm, sm.prev_joint_pos, sm.root_pos

    step = graphs.StagedStep(graphs.single(tick), sim, q_signal[0])
    joints, roots = [], []
    for q_t in q_signal:
        sim, q, root = step(sim, q_t)[1]
        joints.append(q.clone())
        roots.append(root.clone())
    return {"joint_pos": torch.stack(joints), "root_pos": torch.stack(roots)}


def motion_scheme(vel_magnitudes=(0.2,), directions=8, leg_seconds=3.0,
                  dt=0.002, body_heights=(0.0,), foot_heights=(0.2,)):
    """Scripted velocity "motion schemes" for data-collection sweeps.

    Mirrors HighLevel::initMotionScheme (data_collection/src/
    HighLevel.cpp:113-140): a grid of (body height, foot raise height,
    velocity magnitude) with 8 heading directions, every odd leg being the
    return trip (heading + pi).

    Returns:
      list of dicts with keys body_height, foot_height, and cmd, a (T, 3)
      array of (vx, vy, yaw_rate) commands for each leg.
    """
    steps = int(round(leg_seconds / dt))
    schemes = []
    for bh in body_heights:
        for fh in foot_heights:
            for mag in vel_magnitudes:
                heading = 0.0
                for k in range(directions):
                    if k % 2 != 0:
                        heading += np.pi     # return trip
                    else:
                        heading = k / directions * 2 * np.pi
                    cmd = np.zeros((steps, 3))
                    cmd[:, 0] = mag * np.cos(heading)
                    cmd[:, 1] = mag * np.sin(heading)
                    schemes.append({"body_height": bh, "foot_height": fh,
                                    "cmd": cmd})
    return schemes

"""Sensor-cadence (1 kHz) state estimation thread.

Port of the JAX package's ``runtime/estimator.py``. The reference's
hardware adapter runs the EKF and FK on every 1 kHz sensor frame, inside
the UDP receive thread (HardwareA1ROS.cpp:343-378); the RL stack gives
estimation its own thread (go1_rl_ctrl_cpp/src/observation/
Go1Observation.hpp:392-424). Without it, frames that arrive between
control ticks never reach the estimator: at a 2 ms control cadence against
a 1 kHz feed, half the measurements are dropped.

Here that thread runs the EKF step on the card (the state's device), on a
CUDA stream of its own: every frame is one CUDA graph replay
(``utils/graphs.py``) of FK, the predict step, kernel K4 for the
innovation inverse (``ekf.innovation_inverse(..., "auto")``) and the gain
and covariance update, and the control loop merges the latest estimate
(``ControlLoop(estimate_in_feed=True)``).
"""

import threading
import time

import numpy as np
import torch

from go1_qp_mpc_controller_torch.models import kinematics
from go1_qp_mpc_controller_torch.ops import ekf
from go1_qp_mpc_controller_torch.runtime import bridge as bridge_lib
from go1_qp_mpc_controller_torch.utils import graphs, rotations
from go1_qp_mpc_controller_torch.utils.device import (new_stream, on_stream,
                                                       synchronize)

# a frame's sensor values (quat, acc, gyro, joint_pos, joint_vel,
# foot_force); the frame tensor holds its step length dt after them
SENSOR_WIDTH = 38


def make_estimator_predict(model, contact_force_norm=100.0):
    """The first half of a frame's estimate, batch first: quat -> rot, FK
    and Jacobian for the relative foot positions and velocities, then the
    KF predict step up to the innovation matrix (``ekf.predict``).

    Returns:
      predict(x (B, 18), P (B, 18, 18), quat (B, 4), acc (B, 3), gyro
              (B, 3), joint_pos (B, 12), joint_vel (B, 12), foot_force
              (B, 4), movement_mode (B,) int, dt float) -> ekf.Predicted.
    """
    geom = model.leg_geometry

    def predict(x, P, quat, acc, gyro, joint_pos, joint_vel, foot_force,
                movement_mode, dt):
        batch = x.shape[0]
        rot = rotations.quat_to_rot_mat(quat)
        q_legs = joint_pos.reshape(batch, 4, 3)
        foot_pos_rel = kinematics.fk(q_legs, geom.rho_opt, geom.rho_fix)
        j_foot = kinematics.jac(q_legs, geom.rho_opt, geom.rho_fix)
        foot_vel_rel = torch.einsum('blij,blj->bli', j_foot,
                                    joint_vel.reshape(batch, 4, 3))
        return ekf.predict(x, P, dt, rot, acc, gyro, foot_pos_rel,
                           foot_vel_rel, foot_force, movement_mode,
                           contact_force_norm=contact_force_norm)

    return predict


def make_estimator_step(model, contact_force_norm=100.0, sinv="auto"):
    """Per-frame estimator, batch first: raw sensor samples -> EKF update.

    The per-frame work mirrors the reference's receive thread
    (HardwareA1ROS.cpp:343-378): quat -> rot, FK and Jacobian, then the
    18/28 KF update with the innovation inverse on K4 (``sinv="auto"`` on
    float32 CUDA) or its plain version (``ekf.innovation_inverse``).

    Returns:
      step(x (B, 18), P (B, 18, 18), quat (B, 4), acc (B, 3), gyro (B, 3),
           joint_pos (B, 12), joint_vel (B, 12), foot_force (B, 4),
           movement_mode (B,) int, dt float) -> (x, P, est_contacts (B, 4)
           in [0, 1]).
    """
    predict = make_estimator_predict(model, contact_force_norm)

    def step(*args):
        pred = predict(*args)
        return ekf.correct(pred, ekf.innovation_inverse(pred.s_mat, sinv))

    return step


class EstimatorThread:
    """Consumes every bridge sensor frame at its native cadence.

    Publishes the latest (x, P, contacts) under a lock; the control loop's
    fast step runs with ``estimate=False`` and merges this snapshot
    instead of running its own, frame-dropping EKF. The thread's first
    frame (the kernels' first launches) runs in the constructor, before any
    rate keeper starts.

    Args:
      bridge: RtBridge to poll.
      model: RobotModel (on the device of ``init_x``).
      init_x, init_P: (1, 18) / (1, 18, 18) estimator initialization (the
        CtrlState's estimator fields); their device is the thread's.
      sensor_period_s: the feed cadence (reference: 1 ms, A1Params.h:12).
      time_scale: wall-clock slowdown factor (match the loop and feeder).
      contact_force_norm: KF full-contact force scale (100 A1 / 1000 Go1
        hardware units, Go1BasicEKF.cpp:83).
      metrics: optional MetricsLogger; each frame's wall time is logged as
        ``est_frame_ms`` (sensor read to published estimate).
    """

    def __init__(self, bridge, model, init_x, init_P,
                 sensor_period_s=0.001, time_scale=1.0,
                 contact_force_norm=100.0, metrics=None):
        self.bridge = bridge
        self.period = sensor_period_s
        self.time_scale = time_scale
        self.metrics = metrics
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.frames = 0
        self.movement_mode = 0
        self.error = None
        self.device = init_x.device
        self._dtype = init_x.dtype
        self._stream = new_stream(self.device)
        # the frame's first half alone (eager; checks read its innovation
        # matrix), and the whole frame, captured below
        self.predict = make_estimator_predict(model, contact_force_norm)
        step = make_estimator_step(model, contact_force_norm)
        self._modes = {}
        with on_stream(self._stream):
            self._x = init_x.clone()
            self._P = init_P.clone()
            self._contacts = torch.zeros((1, 4), dtype=torch.bool,
                                         device=self.device)
            # the first launches, and on the card the frame's graph, before
            # the RT loop (results discarded)
            frame = self._frame(np.concatenate([[1.0, 0, 0, 0],
                                                np.zeros(34)]),
                                sensor_period_s)
            self._step = graphs.StagedStep(
                graphs.single(lambda x, p, f, mode: step(
                    x, p, *self._split(f), mode, f[0, SENSOR_WIDTH])),
                self._x, self._P, frame, self._mode(0))
            synchronize(self.device)

    def _frame(self, sensors, dt):
        """A (38,) host sensor frame and its step length ``dt`` (seconds)
        as one (1, 39) tensor: one copy to the device. The frame's graph
        reads dt from it, so a frame after dropped ones replays the same
        graph."""
        buf = np.append(np.asarray(sensors, np.float64), dt)[None]
        return torch.as_tensor(buf, dtype=self._dtype).to(self.device)

    @staticmethod
    def _split(t):
        """The six (1, k) sensor tensors of a (1, 39) frame."""
        return (t[:, 0:4], t[:, 4:7], t[:, 7:10], t[:, 10:22], t[:, 22:34],
                t[:, 34:38])

    def _update(self, frame, mode):
        """(x, P, contact weights) after one frame: the captured frame,
        K4 inside."""
        # the graph's buffers: the next frame overwrites them
        return graphs.clone(self._step(self._x, self._P, frame, mode)[1])

    def _mode(self, mode):
        if mode not in self._modes:
            self._modes[mode] = torch.full((1,), mode, dtype=torch.int32,
                                           device=self.device)
        return self._modes[mode]

    def snapshot(self):
        """Latest estimate: (x (1, 18), P (1, 18, 18), contacts (1, 4)
        bool), computed and complete."""
        with self._lock:
            return self._x, self._P, self._contacts

    def set_movement_mode(self, mode):
        self.movement_mode = int(mode)

    def run(self, num_frames=None, duration_s=None):
        rate = bridge_lib.RateKeeper(self.period / self.time_scale)
        t_end = time.time() + duration_s if duration_s else None
        last_tick = -1
        try:
            with on_stream(self._stream):
                while not self._stop.is_set():
                    if num_frames is not None and self.frames >= num_frames:
                        break
                    if t_end is not None and time.time() >= t_end:
                        break
                    t0 = time.perf_counter()
                    tick, s = self.bridge.read_sensors()
                    if tick > 0 and tick != last_tick:
                        # frame gaps advance the filter by the true elapsed
                        # sensor time (the reference's compensated receive
                        # loop has the same property, HardwareA1ROS.cpp:379)
                        gap = 1 if last_tick < 0 else tick - last_tick
                        last_tick = tick
                        frame = self._frame(np.concatenate([
                            s["quat"], s["acc"], s["gyro"], s["joint_pos"],
                            s["joint_vel"], s["foot_force"]]),
                            gap * self.period)
                        x, P, est_c = self._update(
                            frame, self._mode(self.movement_mode))
                        contacts = est_c >= 0.5
                        # publish only what is computed: consumers read it
                        # on streams of their own
                        synchronize(self.device)
                        with self._lock:
                            self._x, self._P = x, P
                            self._contacts = contacts
                        self.frames += 1
                        if self.metrics is not None:
                            self.metrics.log(
                                "est_frame_ms",
                                (time.perf_counter() - t0) * 1e3)
                    rate.wait()
        except BaseException as exc:
            self.error = exc         # the control loop re-raises it
            raise
        finally:
            rate.close()
        return self.frames

    def start(self, **kwargs):
        self._thread = threading.Thread(target=self.run, kwargs=kwargs,
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if hasattr(self, "_thread"):
            self._thread.join(timeout=5.0)

"""RL host loop: the hardware-mirror RL control process over the bridge.

Port of the JAX package's ``runtime/rl_loop.py`` (Go1RLHardwareController
+ Go1HardwareObservation, go1_rl_ctrl_cpp/src/Go1RLHardwareController.*,
Go1HardwareObservation.hpp): a real-time loop that reads raw sensor frames
from the RtBridge (the UDP receive path's role, with the hardware 5-sample
foot-force filter and the PowerProtect clamps on the way out), runs the
estimation + observation + policy/servo step at the action cadence, and
pushes position-mode motor commands (q + kp/kd, tau = 0,
Go1RLController.cpp:149-166). The bridge's command slot plays the
reference's send thread: the consumer reads the latest command at its own
rate.

One action tick, at batch 1 on the loop's device and CUDA stream: the
estimator's predict step (``runtime/estimator.make_estimator_predict``:
FK, Jacobian, KF predict up to the innovation matrix), the innovation
inverse, then the KF correction with ``switch_mode`` and
``rl_control_step``. On the card the two halves are CUDA graph replays
(one-part ``utils/graphs.StagedStep``s) and the inverse between them
launches kernel K4 (``ekf.innovation_inverse(..., "auto")`` on float32
CUDA input, ``ops/schulz_lanes.py``) once a tick; the wrapper counts it,
so it stays outside the graphs. The JAX package's unbatched loop takes its
plain XLA Schulz loop there instead, because its ``custom_vmap`` rule
reaches the Pallas kernel only under ``vmap``; the port keeps its rule of
K4 for every float32 CUDA input.
"""

import threading
import time

import numpy as np
import torch

from go1_qp_mpc_controller_torch.ctrl import rl as rl_lib
from go1_qp_mpc_controller_torch.models import kinematics
from go1_qp_mpc_controller_torch.ops import ekf
from go1_qp_mpc_controller_torch.runtime import bridge as bridge_lib
from go1_qp_mpc_controller_torch.runtime import estimator as estimator_lib
from go1_qp_mpc_controller_torch.utils import graphs, rotations
from go1_qp_mpc_controller_torch.utils import metrics as metrics_lib
from go1_qp_mpc_controller_torch.utils.device import (new_stream, on_stream,
                                                       synchronize)

# the bridge's sensor order, the 38 values of a frame
_SENSOR_KEYS = ("quat", "acc", "gyro", "joint_pos", "joint_vel",
                "foot_force")


def _split(frame):
    """The six (1, k) sensor tensors, the (1, 3) command and the (1,)
    A-button press of a (1, 42) tick frame."""
    return ((frame[:, 0:4], frame[:, 4:7], frame[:, 7:10], frame[:, 10:22],
             frame[:, 22:34], frame[:, 34:38]), frame[:, 38:41],
            frame[:, 41] != 0.0)


class RLControlLoop:
    """Drives the RL controller against the RT bridge, at batch 1.

    Args:
      model: RobotModel (leg geometry for FK and the estimator); its
        device and dtype are the loop's (the JAX loop runs float32).
      actor: ``models/policy.ActorMLP`` on the model's device and dtype.
      action_period_s: policy cadence (reference: 4 ms Gazebo / 2.5 ms
        hardware, config/parameters.yaml:9-11).
      power_level: the bridge's PowerProtect budget when ``hardware``.
      hardware: True enables the hardware receive-path foot filter (5
        samples) and PowerProtect at ``power_level`` on the bridge.
      time_scale: real-time factor (see runtime/loop.py).
      servo_only: the standalone GazeboServo / HardwareServo stand
        processes (servo_stand_policy/): the mode switch is disabled and
        the loop interpolates to the crouch pose forever.
      contact_force_norm: KF full-contact force scale. The Go1 RL stack
        normalizes by 1000 (Go1 hardware force units, Go1BasicEKF.cpp:83)
        where the A1 MPC stack uses 100 (A1BasicEKF.cpp:83).

    ``command`` ((3,) cmd_vx, cmd_vy, cmd_yaw_rate) and ``toggle`` (a
    one-shot A-button press) are read by the loop on every tick;
    ``metrics`` logs each action tick's wall time (sensor read to pushed
    command) as ``step_ms``.
    """

    def __init__(self, model, actor, action_period_s=0.004, power_level=5,
                 hardware=True, time_scale=1.0, servo_only=False,
                 contact_force_norm=1000.0):
        self.model = model
        self.device = model.mass.device
        self.period = action_period_s
        self.time_scale = time_scale
        self.bridge = bridge_lib.RtBridge(
            power_level=power_level if hardware else 10,
            foot_filter_window=5 if hardware else 0)
        self.metrics = metrics_lib.MetricsLogger()
        self._stop = threading.Event()
        self.ticks = 0
        self.overruns = 0
        self.error = None
        self.command = np.zeros(3)      # (cmd_vx, cmd_vy, cmd_yaw_rate)
        self.toggle = False             # A-button press (one-shot)
        self.servo_only = servo_only
        self._dtype = model.mass.dtype
        self._stream = new_stream(self.device)
        self.rl_state = rl_lib.init_rl_state(1, dtype=self._dtype,
                                             device=self.device)
        self._est = None                # (x, P) after the first frame
        self._pre = self._post = None   # the captured halves (warmup)
        predict = estimator_lib.make_estimator_predict(model,
                                                       contact_force_norm)

        def pre(x, p, frame, rl_state):
            sensors, _, _ = _split(frame)
            return predict(x, p, *sensors, rl_state.movement_mode,
                           action_period_s)

        def post(pred, s_inv, rl_state, frame):
            (quat, _, gyro, q, dq, _), command, toggle = _split(frame)
            x, p, _ = ekf.correct(pred, s_inv)
            euler = rotations.quat_to_euler(quat)
            rl_state = rl_lib.switch_mode(rl_state, toggle)
            rl_state, cmd, _ = rl_lib.rl_control_step(
                rl_state, actor, rotations.quat_to_rot_mat(quat),
                rotations.rot_z(euler[:, 2]), x[:, 3:6], gyro, command, q,
                dq)
            # one (1, 48) block for one copy to the host
            return x, p, rl_state, torch.cat([cmd.tau, cmd.q, cmd.kp,
                                              cmd.kd], dim=-1)

        self._pre_fn, self._post_fn = pre, post

    def _frame(self, sensors, command, toggle):
        """A tick's (1, 42) input on the device: the 38 sensor values in
        the bridge's order, the command and the press (one copy)."""
        buf = np.concatenate([np.asarray(sensors[k], np.float64)
                              for k in _SENSOR_KEYS]
                             + [np.asarray(command, np.float64),
                                [float(toggle)]])[None]
        return torch.as_tensor(buf, dtype=self._dtype).to(self.device)

    def _step(self, x, p, frame):
        """(x, P, rl_state, (1, 48) command block) after one action tick:
        the two captured halves around the K4 launch."""
        pred = self._pre(x, p, frame, self.rl_state)[1]
        s_inv = ekf.innovation_inverse(pred.s_mat, "auto")
        return self._post(pred, s_inv, self.rl_state, frame)[1]

    def warmup(self):
        """Capture the tick's two halves (on the card) and make every first
        launch before the loop runs; results are discarded."""
        sensors = {"quat": [1.0, 0.0, 0.0, 0.0], "acc": [0.0, 0.0, 9.8],
                   "gyro": np.zeros(3), "joint_pos": np.zeros(12),
                   "joint_vel": np.zeros(12), "foot_force": np.full(4, 50.0)}
        with on_stream(self._stream):
            frame = self._frame(sensors, np.zeros(3), False)
            x0, p0 = ekf.init_state(
                torch.eye(3, dtype=self._dtype, device=self.device)[None],
                torch.zeros((1, 4, 3), dtype=self._dtype,
                            device=self.device))
            self._pre = graphs.StagedStep(graphs.single(self._pre_fn), x0,
                                          p0, frame, self.rl_state)
            pred = self._pre(x0, p0, frame, self.rl_state)[1]
            s_inv = ekf.innovation_inverse(pred.s_mat, "auto")
            self._post = graphs.StagedStep(graphs.single(self._post_fn),
                                           pred, s_inv, self.rl_state, frame)
            self._step(x0, p0, frame)
            synchronize(self.device)

    def _init_estimate(self, sensors):
        """(x, P) initialized from the first real frame's orientation and
        FK (A1BasicEKF.cpp:55-68)."""
        t = lambda k: torch.as_tensor(np.asarray(sensors[k])[None],
                                      dtype=self._dtype).to(self.device)
        geom = self.model.leg_geometry
        feet = kinematics.fk(t("joint_pos").reshape(1, 4, 3), geom.rho_opt,
                             geom.rho_fix)
        return ekf.init_state(rotations.quat_to_rot_mat(t("quat")), feet)

    def run(self, num_ticks=None, duration_s=None):
        """Blocking action loop on the compensated C++ rate keeper."""
        if self._pre is None:
            raise RuntimeError("RLControlLoop.run: call warmup() first")
        rate = bridge_lib.RateKeeper(self.period / self.time_scale)
        t_end = time.time() + duration_s if duration_s else None
        last_tick = -1
        try:
            with on_stream(self._stream):
                while not self._stop.is_set():
                    if num_ticks is not None and self.ticks >= num_ticks:
                        break
                    if t_end is not None and time.time() >= t_end:
                        break
                    t0 = time.perf_counter()
                    tick, s = self.bridge.read_sensors()
                    if tick > 0 and tick != last_tick:
                        last_tick = tick
                        if self._est is None:
                            self._est = self._init_estimate(s)
                        toggle = (not self.servo_only) and self.toggle
                        self.toggle = False
                        x, p, rl_state, out = self._step(
                            *self._est, self._frame(s, self.command, toggle))
                        # the graphs' buffers: x and P go back in as the
                        # next inputs (copied before the replay); the
                        # state others read is copied out first
                        rl_state = graphs.clone(rl_state)
                        host = out[0].to("cpu", torch.float64).numpy()
                        self._est, self.rl_state = (x, p), rl_state
                        self.bridge.push_command(host[0:12], host[12:24],
                                                 host[24:36], host[36:48])
                        self.ticks += 1
                        self.metrics.log("step_ms", (time.perf_counter()
                                                     - t0) * 1e3)
                    rate.wait()
            self.overruns = rate.overruns
        except BaseException as exc:
            self.error = exc         # for the caller to check and raise
            raise
        finally:
            rate.close()
        return self.ticks

    def start(self, **kwargs):
        self._thread = threading.Thread(target=self.run, kwargs=kwargs,
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if hasattr(self, "_thread"):
            self._thread.join(timeout=5.0)

    def close(self):
        self.stop()
        self.bridge.close()

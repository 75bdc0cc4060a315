"""Host runtime: the dual-cadence real-time control loop.

Port of the JAX package's ``runtime/loop.py`` (the reference's process
entry points, MainGazebo.cpp:47-121 and MainHardware.cpp:85-129): a GRF /
MPC loop and a main plan + torque loop, plus a sensor feed, all paced by
the C++ compensated-sleep rate keepers and exchanging state through the
lock-free bridge blackboard. The MPC solution is reused across fast ticks
as in the reference's thread decoupling ("the MPC thread solves while the
torque thread consumes the last GRF").

Every step runs the port's batch-first controller at batch 1. On the card,
each thread (the fast loop, the GRF loop, the estimator and the feeder)
issues its work on a CUDA stream of its own, so the fast loop's torques do
not wait behind a whole GRF solve on one queue. The threads share one
Python GIL, and a step is hundreds of small host dispatches: every step
is therefore replayed as CUDA graphs with its kernels inside
(``utils/graphs.py``), the counterparts of the JAX loop's jitted steps.
The feeder's tick, the estimator's frame (K4) and the fast step (K2 when
the estimator thread is off) are one graph each. The GRF solve and the
single-cadence step route as the JAX package's ``lax.switch`` does: one
graph up to the route code, one read of it, the route's graph, and after
a warm or window route one read of its health flag (and the cold
re-solve's graph when it is set). :meth:`ControlLoop.warmup` captures
every route before any thread starts. A thread publishes tensors
to another only after waiting for its own stream; tensors that cross into
the fast loop's stream are recorded on it (``record_stream``) so the
caching allocator cannot hand their memory out while that stream may
still read it. An error in any thread stops the loop and is raised.
"""

import threading
import time

import numpy as np
import torch

from go1_qp_mpc_controller_torch.config import params as P
from go1_qp_mpc_controller_torch.ctrl import command as command_lib
from go1_qp_mpc_controller_torch.ctrl import controller, gait, swing, torque
from go1_qp_mpc_controller_torch.envs import replay
from go1_qp_mpc_controller_torch.ops import admm
from go1_qp_mpc_controller_torch.runtime import bridge as bridge_lib
from go1_qp_mpc_controller_torch.runtime import estimator as estimator_lib
from go1_qp_mpc_controller_torch.utils import graphs
from go1_qp_mpc_controller_torch.utils import metrics as metrics_lib
from go1_qp_mpc_controller_torch.utils.device import (new_stream, on_stream,
                                                       synchronize)


def _tensors(tree):
    """The tensors of a nested NamedTuple (or a tensor)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for leaf in tree for t in _tensors(leaf)]


def _record(tree, stream):
    """Mark the tensors of ``tree`` as in use on ``stream``."""
    if stream is not None:
        for t in _tensors(tree):
            t.record_stream(stream)


class ControlLoop:
    """Drives the controller against the RT bridge, at batch 1.

    Args:
      model, params: RobotModel / CtrlParams (on the state's device).
      static: presets.StaticConfig (solver branch etc.).
      ctrl_state: initial batch-1 CtrlState; its device is the loop's.
      main_period_s: plan + torque cadence (reference: 0.5-2 ms).
      grf_period_s: MPC / GRF cadence.
      power_level: safety budget for the bridge clamps (hardware only).
      stop_on_terminal: stop when a joint reaches its limit.
      time_scale: real-time factor: wall period = sim period / time_scale
        while the math's dts stay in sim time (the reference's
        use_sim_time Gazebo runs the same way when the simulator's RTF is
        below 1, MainGazebo.cpp:31-37). Use < 1 when a solve outlasts the
        real-time budget.
      command_source: optional joystick source with ``poll() ->
        list[(raw_axes (8,), raw_buttons (>=5,))]`` (runtime/joystick.py).
        :meth:`run_dual` then maps every sample through axes_from_raw ->
        clamp_axes -> latch_buttons -> apply_commands in the fast step (the
        reference's joy -> desired state -> mode toggle path,
        GazeboA1ROS.cpp:117-188, 381-415); the LB button stops the loop
        (joy_cmd_exit, :412-415).
      estimate_in_feed: run the EKF in an EstimatorThread on every bridge
        frame (the reference's receive-thread estimation,
        HardwareA1ROS.cpp:343-378) instead of in the fast step, which sees
        only the latest frame per tick.
      sensor_period_s: the feed's cadence (the estimator's dt unit).
    """

    # fields the GRF solve owns; merged into the live state whenever a
    # solve lands (the reference's GRF thread writes the same fields into
    # the shared A1CtrlStates without locks, A1RobotControl.cpp:321-564)
    _GRF_FIELDS = ("foot_forces_grf", "qp_warm_x", "qp_warm_y",
                   "qp_warm_rho", "qp_warm_minv", "qp_warm_contacts",
                   "qp_warm_grad", "terrain_angle_filter",
                   "terrain_pitch_angle", "root_euler_d")

    def __init__(self, model, params, static, ctrl_state,
                 main_period_s=0.002, grf_period_s=0.002,
                 settings=admm.ADMMSettings(), power_level=5,
                 stop_on_terminal=False, time_scale=1.0,
                 command_source=None, estimate_in_feed=False,
                 sensor_period_s=0.001):
        self.model = model
        self.params = params
        self.static = static
        self.state = ctrl_state
        self.settings = settings
        self.device = ctrl_state.root_pos.device
        self.main_period = main_period_s
        self.grf_period = grf_period_s
        self.time_scale = time_scale
        # the hardware receive path filters foot forces through a 5-sample
        # ring (HardwareA1ROS.cpp:300-312); Gazebo / Isaac feed raw values.
        # PowerProtect budgets exist only on hardware
        # (HardwareA1ROS.cpp:200-202): sim envs get the full ceiling.
        hardware = static.environment == "hardware"
        self.bridge = bridge_lib.RtBridge(
            power_level=power_level if hardware else 10,
            foot_filter_window=5 if hardware else 0)
        self.metrics = metrics_lib.MetricsLogger()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # joint-limit terminal-state watchdog (GazeboA1ROS.cpp:233,418-425;
        # the reference prints it per send_cmd with the shutdown commented
        # out: stop_on_terminal=True enables the shutdown)
        self.stop_on_terminal = stop_on_terminal
        self._pos_limits = np.asarray(P.JOINT_POS_LIMITS)
        self.solver = (controller.MPC if static.solver == "mpc"
                       else controller.QP)
        self.command_source = command_source
        self.estimate_in_feed = estimate_in_feed
        self.sensor_period = sensor_period_s
        self.est_thread = None
        self._est_ready = None
        # the captured steps (``warmup``): the fast step, the GRF solve
        # and the single-cadence step
        self._fast = self._grf = self._full = None
        self.fast_ticks = 0
        self.grf_ticks = 0

    # ---- the steps (batch 1; ``params`` is an argument because the
    # joystick path changes kp_linear tick by tick) ----------------------

    def fast_step(self, state, sensors, params):
        """Plan + swing + torques against the last solved GRF. With the
        estimator thread on, the sensor update only refreshes kinematics:
        the merged thread estimate holds root_pos / root_lin_vel."""
        dt = self.main_period
        state = controller.sensor_update(state, self.model, sensors, dt,
                                         estimate=not self.estimate_in_feed)
        state = gait.update_plan(state, params, self.model)
        state = swing.generate_swing_legs_ctrl(state, params, dt)
        return torque.compute_joint_torques(state, params)

    def fast_step_joy(self, state, joy, params, ax_raw, btn, sensors):
        """The operator chain, then :meth:`fast_step`: returns (state, joy,
        params). ``ax_raw`` (1, 8) and ``btn`` (1, 5) are tensors."""
        axes = command_lib.clamp_axes(command_lib.axes_from_raw(ax_raw, btn))
        joy = command_lib.latch_buttons(joy, axes)
        joy, state, params = command_lib.apply_commands(
            joy, axes, state, params, self.main_period)
        return self.fast_step(state, sensors, params), joy, params

    # ---- host side -------------------------------------------------------

    def _sensor_data(self, s):
        """Batch-1 SensorData from a bridge frame: one copy to the
        device."""
        buf = np.concatenate([s["quat"], s["acc"], s["gyro"],
                              s["joint_pos"], s["joint_vel"],
                              s["foot_force"]])[None]
        t = torch.as_tensor(buf, dtype=self.state.root_pos.dtype).to(
            self.device)
        return controller.SensorData(
            quat_wxyz=t[:, 0:4], imu_acc=t[:, 4:7], imu_ang_vel=t[:, 7:10],
            joint_pos=t[:, 10:22], joint_vel=t[:, 22:34],
            foot_force=t[:, 34:38])

    def _terminal(self, s):
        q = np.asarray(s["joint_pos"]).reshape(4, 3)
        return bool(np.any((q <= self._pos_limits[:, 0])
                           | (q >= self._pos_limits[:, 1])))

    def _joy_inputs(self, axes, buttons):
        dtype = self.state.root_pos.dtype
        return (torch.as_tensor(axes[None], dtype=dtype).to(self.device),
                torch.as_tensor(buttons[None], dtype=torch.int32).to(
                    self.device))

    def _grf_parts(self):
        """The GRF solve on a state snapshot (MPC or the balance QP) as
        ``graphs.Stages`` over ``(state, params)``
        (``controller.grf_parts``); either composition returns the
        ``_GRF_FIELDS`` values in a 1-tuple."""
        return graphs.nest(
            controller.grf_parts(self.solver, self.settings,
                                 self.static.use_terrain_adapt),
            lambda args: (args[0], self.model, args[1]),
            lambda args, out: (tuple(getattr(out[0], f)
                                     for f in self._GRF_FIELDS), *out[1:]))

    def warmup(self, dual=True):
        """Capture every step the loops run (on the card: CUDA graphs, each
        route of the GRF solve or the single-cadence step included; on the
        CPU: their plain compositions) before the RT loops start, so that no
        step captures or loads a kernel inside a running loop; results
        are discarded. With ``estimate_in_feed`` this also builds the
        EstimatorThread (its first frame runs in its constructor)."""
        sensors = self._sensor_data({
            "quat": [1.0, 0.0, 0.0, 0.0], "acc": [0.0, 0.0, 9.8],
            "gyro": np.zeros(3),
            "joint_pos": self.state.joint_pos[0].cpu().double().numpy(),
            "joint_vel": np.zeros(12), "foot_force": np.full(4, 50.0)})
        if dual:
            if self.command_source is not None:
                # the operator chain keeps one kp_linear row per scenario
                self.params = self.params._replace(
                    kp_linear=self.params.kp_linear.expand(1, 3).clone())
                joy = command_lib.init_joy_state(
                    1, 0.3, self.state.root_pos.dtype, self.device)
                ax, btn = self._joy_inputs(np.zeros(8), np.zeros(5))
                self._fast = graphs.StagedStep(
                    graphs.single(self.fast_step_joy), self.state, joy,
                    self.params, ax, btn, sensors)
                st = self._fast(self.state, joy, self.params, ax, btn,
                                sensors)[1][0]
            else:
                self._fast = graphs.StagedStep(graphs.single(self.fast_step),
                                               self.state, sensors,
                                               self.params)
                st = self._fast(self.state, sensors, self.params)[1]
            self._grf = graphs.StagedStep(self._grf_parts(), st,
                                          self.params)
        else:
            self._full = graphs.StagedStep(
                replay.replay_parts(self.main_period, self.solver,
                                    self.settings,
                                    self.static.use_terrain_adapt),
                self.state, self.model, self.params, sensors)
        synchronize(self.device)
        if dual and self.estimate_in_feed:
            self._est_ready = self._make_estimator()

    def _make_estimator(self):
        return estimator_lib.EstimatorThread(
            self.bridge, self.model, self.state.estimator_x,
            self.state.estimator_P, sensor_period_s=self.sensor_period,
            time_scale=self.time_scale, metrics=self.metrics)

    def run(self, num_ticks=None, duration_s=None):
        """Blocking main loop, single cadence: plan + solve + send each
        tick (the fusion of the reference's two threads),
        ``replay.replay_parts`` as captured by ``warmup(dual=False)``."""
        if self._full is None:
            raise RuntimeError("ControlLoop.run: call warmup(dual=False) "
                               "first")
        rate = bridge_lib.RateKeeper(self.main_period / self.time_scale)
        n = 0
        t_end = time.time() + duration_s if duration_s else None
        last_sensor_tick = -1
        try:
            while not self._stop.is_set():
                if num_ticks is not None and n >= num_ticks:
                    break
                if t_end is not None and time.time() >= t_end:
                    break
                tick, s = self.bridge.read_sensors()
                if tick > 0 and tick != last_sensor_tick:
                    last_sensor_tick = tick
                    terminal = self._terminal(s)
                    self.metrics.log("terminal_state", float(terminal))
                    if terminal and self.stop_on_terminal:
                        self._stop.set()
                        break
                    t0 = time.perf_counter()
                    with self._lock:
                        self.state = graphs.clone(controller.run_tick(
                            self._full, (self.state, self.model, self.params,
                                         self._sensor_data(s)))[0])
                    tau = self.state.joint_torques[0].to(
                        "cpu", torch.float64).numpy()
                    self.bridge.push_command(tau)
                    self.metrics.log("cycle_ms",
                                     (time.perf_counter() - t0) * 1e3)
                rate.wait()
                n += 1
        finally:
            self.metrics.log("overruns", rate.overruns)
            rate.close()
        return n

    def run_dual(self, num_ticks=None, duration_s=None):
        """Dual-cadence variant of :meth:`run`: a GRF solver loop at
        ``grf_period_s`` and a fast plan + torque loop at
        ``main_period_s`` consuming the last solution (the reference's two
        free-running threads, MainGazebo.cpp:47-121,
        MainHardware.cpp:85-129), each on its own compensated rate keeper
        and CUDA stream.

        Returns the number of fast-loop iterations; ``self.fast_ticks``
        counts ticks on a new frame and ``self.grf_ticks`` landed solves.
        The steps are those ``warmup(dual=True)`` captured.
        """
        if self._fast is None or self._grf is None:
            raise RuntimeError("ControlLoop.run_dual: call warmup() first")
        grf_done = threading.Event()
        fast_stream = new_stream(self.device)
        grf_stream = new_stream(self.device)
        errors = []

        def grf_loop():
            rate = bridge_lib.RateKeeper(self.grf_period / self.time_scale)
            try:
                with on_stream(grf_stream):
                    while not self._stop.is_set():
                        with self._lock:
                            snap = self.state
                            params_now = self.params
                        t0 = time.perf_counter()
                        # one route read, one branch, one health read;
                        # the graph's buffers are copied before they leave
                        solved = graphs.clone(controller.run_tick(
                            self._grf, (snap, params_now))[0])
                        synchronize(self.device)
                        self.metrics.log(
                            "grf_ms", (time.perf_counter() - t0) * 1e3)
                        merged = dict(zip(self._GRF_FIELDS, solved))
                        _record(tuple(merged.values()), fast_stream)
                        with self._lock:
                            self.state = self.state._replace(**merged)
                        self.grf_ticks += 1
                        rate.wait()
                self.metrics.log("grf_overruns", rate.overruns)
            except BaseException as exc:
                errors.append(exc)
                self._stop.set()
            finally:
                rate.close()
                grf_done.set()

        grf_thread = threading.Thread(target=grf_loop, daemon=True)
        rate = bridge_lib.RateKeeper(self.main_period / self.time_scale)
        dtype = self.state.root_pos.dtype
        n = 0
        last_sensor_tick = -1
        # joystick bookkeeping: the last axes keep applying between samples
        # (the reference's main_update consumes the last joy_cmd_* every
        # tick); button presses OR-accumulate, so a press between two fast
        # ticks is never lost
        joy = None
        if self.command_source is not None:
            h0 = float(self.state.root_pos_d[0, 2])
            joy = command_lib.init_joy_state(1, h0 if h0 > 0.05 else 0.3,
                                             dtype, self.device)
            last_axes = np.zeros(8, np.float32)
            btn_accum = np.zeros(5, np.int32)
        est = None
        if self.estimate_in_feed:
            est = self._est_ready or self._make_estimator()
            self._est_ready = None
            self.est_thread = est
            est.start()
        grf_thread.start()
        # the duration clock starts after the estimator's construction
        t_end = time.time() + duration_s if duration_s else None
        try:
            with on_stream(fast_stream):
                while not self._stop.is_set():
                    if num_ticks is not None and n >= num_ticks:
                        break
                    if t_end is not None and time.time() >= t_end:
                        break
                    if est is not None and est.error is not None:
                        raise RuntimeError("the estimator thread failed") \
                            from est.error
                    tick, s = self.bridge.read_sensors()
                    if tick > 0 and tick != last_sensor_tick:
                        last_sensor_tick = tick
                        terminal = self._terminal(s)
                        self.metrics.log("terminal_state", float(terminal))
                        if terminal and self.stop_on_terminal:
                            break
                        t0 = time.perf_counter()
                        with self._lock:
                            state = self.state
                            params = self.params
                        if est is not None and est.frames > 0:
                            # frames == 0 guard: the pre-update init state
                            # carries the reference's crouched z = 0.09
                            # (A1BasicEKF.cpp:55-68)
                            ex, ep, econ = est.snapshot()
                            _record((ex, ep, econ), fast_stream)
                            state = state._replace(
                                estimator_x=ex, estimator_P=ep,
                                estimated_contacts=econ,
                                root_pos=ex[:, 0:3], root_lin_vel=ex[:, 3:6])
                        sensors = self._sensor_data(s)
                        if joy is not None:
                            for ax, bt in self.command_source.poll():
                                last_axes = np.asarray(ax, np.float32)
                                btn_accum = np.maximum(
                                    btn_accum, np.asarray(bt[:5], np.int32))
                            ax_t, bt_t = self._joy_inputs(last_axes,
                                                          btn_accum)
                            state, joy, params = graphs.clone(self._fast(
                                state, joy, params, ax_t, bt_t, sensors)[1])
                            btn_accum = np.zeros(5, np.int32)
                            flags = joy.exit_request.to(dtype)
                        else:
                            state = graphs.clone(self._fast(state, sensors,
                                                            params)[1])
                            flags = torch.zeros_like(
                                state.movement_mode, dtype=dtype)
                        # torques, movement mode and the exit request in one
                        # copy to the host (it waits for the fast stream)
                        host = torch.cat([
                            state.joint_torques[0],
                            state.movement_mode.to(dtype),
                            flags]).to("cpu", torch.float64).numpy()
                        with self._lock:
                            # keep any GRF-solve fields that landed while
                            # the fast step ran
                            merged = {f: getattr(self.state, f)
                                      for f in self._GRF_FIELDS}
                            self.state = state._replace(**merged)
                            self.params = params
                        self.bridge.push_command(host[:12])
                        if host[13] != 0.0:
                            self._stop.set()
                        if est is not None:
                            est.set_movement_mode(int(host[12]))
                        self.metrics.log("movement_mode", float(host[12]))
                        self.metrics.log("cycle_ms",
                                         (time.perf_counter() - t0) * 1e3)
                        self.fast_ticks += 1
                    rate.wait()
                    n += 1
        finally:
            self._stop.set()
            if est is not None:
                est.stop()
            grf_done.wait(timeout=30.0)
            self.metrics.log("overruns", rate.overruns)
            rate.close()
            self._stop.clear()
        if errors:
            raise RuntimeError("the GRF loop failed") from errors[0]
        if est is not None and est.error is not None:
            raise RuntimeError("the estimator thread failed") from est.error
        return n

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

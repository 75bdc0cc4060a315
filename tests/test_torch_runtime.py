"""PyTorch port, the real-time host runtime: the estimator step, the
control loop's steps and the threaded loops, held against the JAX
package's runtime.

- ``estimator.make_estimator_step`` against the JAX one over the 300-frame
  velocity-step sequence of tests/test_estimator_cadence.py:24-49, float64,
  within 1e-9 on x and P; and that test's cadence property on the port.
- ``ControlLoop``'s full, fast + GRF and joystick steps (the full and
  the GRF step as the loops replay them: their ``graphs.Stages`` composed
  plainly) against the JAX loop's jitted steps, 20 closed-loop ticks on
  ``hardware_qp`` and ``gazebo_mpc`` (the plant stepped by the JAX
  torques), float64, within 1e-8 x max(1, max|JAX|) on every compared
  field.
- The threads (feeder, estimator, GRF loop, fast loop) at batch 1 on the
  CPU: the invariants of tests/test_estimator_cadence.py and
  tests/test_dual_loop.py hold at every rung of a time-scale ladder; the
  test skips only when no rung kept its cadence (the host was too
  loaded). Parity is held by the deterministic step tests above.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch.compat import convert
from go1_qp_mpc_controller_torch.config import presets as t_presets
from go1_qp_mpc_controller_torch.ctrl import controller as t_ctrl
from go1_qp_mpc_controller_torch.envs import replay as t_replay
from go1_qp_mpc_controller_torch.envs import srb_sim as t_sim
from go1_qp_mpc_controller_torch.models import types as t_types
from go1_qp_mpc_controller_torch.ops import ekf as t_ekf
from go1_qp_mpc_controller_torch.runtime import bridge as t_bridge
from go1_qp_mpc_controller_torch.runtime import estimator as t_est
from go1_qp_mpc_controller_torch.runtime import feeder as t_feeder
from go1_qp_mpc_controller_torch.runtime import loop as t_loop
from go1_qp_mpc_controller_torch.utils import graphs
from go1_qp_mpc_controller_tpu.config import presets as j_presets
from go1_qp_mpc_controller_tpu.envs import rollout as j_rollout
from go1_qp_mpc_controller_tpu.envs import srb_sim as j_sim
from go1_qp_mpc_controller_tpu.models import types as j_types
from go1_qp_mpc_controller_tpu.runtime import estimator as j_est
from go1_qp_mpc_controller_tpu.runtime import loop as j_loop

torch.set_num_threads(1)
F64 = torch.float64


def _batch1(tree):
    """A JAX NamedTuple (unbatched) as numpy with a batch axis of 1."""
    return jax.tree.map(lambda a: np.asarray(a)[None], tree)


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * scale, err_msg=what)


# ---- the estimator step ----------------------------------------------------

def _sensor_sequence(n_frames=300, step_at=50, vel=0.30, dt=0.001):
    """tests/test_estimator_cadence.py's kinematic stand with an unmodeled
    velocity step at ``step_at`` (the IMU misses the push), from the JAX
    plant's sensor model. Returns (frames, truth velocities)."""
    model = j_types.default_robot_model(jnp.float64)
    sim = j_sim.init_sim_state(model, 0.3, jnp.float64)
    contacts = jnp.ones(4, bool)
    fz = jnp.full((4,), model.mass * 9.8 / 4.0, jnp.float64)
    frames, truth = [], []
    root = np.asarray(sim.root_pos, np.float64).copy()
    prev_q = None
    for k in range(n_frames):
        v = np.array([vel, 0.0, 0.0]) if k >= step_at else np.zeros(3)
        root = root + v * dt
        s = sim._replace(root_pos=jnp.asarray(root))
        if prev_q is not None:
            s = s._replace(prev_joint_pos=prev_q)
        sensors = j_sim.read_sensors(s, model, contacts, fz,
                                     jnp.asarray(dt))
        prev_q = sensors.joint_pos
        frames.append(sensors)
        truth.append(v)
    return frames, np.asarray(truth)


def _port_sensors(s):
    return [torch.tensor(np.asarray(a))[None] for a in s]


def _init_estimate():
    sim = t_sim.init_sim_state(t_types.default_robot_model(F64, "cpu"), 1,
                               0.3)
    return t_ekf.init_state(sim.root_rot,
                            sim.foot_pos_world - sim.root_pos[:, None])


def test_estimator_step_matches_jax_f64():
    frames, _ = _sensor_sequence()
    jm = j_types.default_robot_model(jnp.float64)
    j_step = j_est.make_estimator_step(jm)
    t_step = t_est.make_estimator_step(t_types.default_robot_model(F64,
                                                                   "cpu"))
    jsim = j_sim.init_sim_state(jm, 0.3, jnp.float64)
    jx, jp = j_est.ekf.init_state(jsim.root_rot,
                                  jsim.foot_pos_world - jsim.root_pos)
    tx, tp = _init_estimate()
    mode = jnp.zeros((), jnp.int32)
    for k, s in enumerate(frames):
        # walk from frame 150 on: the contact weights then follow the forces
        walk = int(k >= 150)
        res = j_step(jx, jp, *s, mode + walk, jnp.asarray(0.001))
        jx, jp = res.x, res.P
        tx, tp, tc = t_step(tx, tp, *_port_sensors(s),
                            torch.tensor([walk], dtype=torch.int32), 0.001)
        _close(tx[0], jx, 1e-9, f"x at frame {k}")
        _close(tp[0], jp, 1e-9, f"P at frame {k}")
        _close(tc[0], res.estimated_contacts, 1e-12)


def test_full_cadence_tracks_transient_tighter():
    """tests/test_estimator_cadence.py on the port: consuming every frame
    tracks the velocity step measurably tighter than every second frame."""
    frames, truth = _sensor_sequence()
    step = t_est.make_estimator_step(t_types.default_robot_model(F64, "cpu"))
    mode = torch.zeros(1, dtype=torch.int32)

    def run(stride):
        x, p = _init_estimate()
        errs, est_v = np.zeros(len(frames)), np.zeros(3)
        for k, s in enumerate(frames):
            if k % stride == 0:
                x, p, _ = step(x, p, *_port_sensors(s), mode, stride * 0.001)
                est_v = x[0, 3:6].numpy()
            errs[k] = np.linalg.norm(est_v - truth[k])
        return errs

    err_1k, err_2ms = run(1), run(2)
    e1, e2 = err_1k[50:120].mean(), err_2ms[50:120].mean()
    assert np.isfinite(e1) and np.isfinite(e2)
    assert err_1k[250:].mean() < 0.05
    assert e1 < e2 - 0.005, (e1, e2)


# ---- the control loop's steps ---------------------------------------------

def _loops(preset):
    """(JAX ControlLoop, port ControlLoop) in float64 from the same
    standing start, and the JAX plant carry."""
    jm, jp, js = j_presets.load_preset(preset, jnp.float64)
    tm, tp, ts = t_presets.load_preset(preset, F64, device="cpu")
    carry = j_rollout.init_carry(jm, jp, height=0.3, dtype=jnp.float64)
    jcl = j_loop.ControlLoop(jm, jp, js, carry.ctrl)
    tcl = t_loop.ControlLoop(tm, tp, ts, convert.from_numpy(
        t_types.CtrlState, _batch1(carry.ctrl), "cpu", F64))
    return jcl, tcl, carry


def _full_step(cl, state, sensors, params):
    """The single-cadence tick as ``ControlLoop.run`` replays it
    (``replay.replay_parts``), composed plainly."""
    return graphs.compose_stages(
        t_replay.replay_parts(cl.main_period, cl.solver, cl.settings,
                              cl.static.use_terrain_adapt),
        state, cl.model, params, sensors)[1][0]


def _grf_step(cl, state, params):
    """``state`` with the GRF solve's ``_GRF_FIELDS`` values as the GRF
    loop replays it (``ControlLoop._grf_parts``), composed plainly."""
    (solved,) = graphs.compose_stages(cl._grf_parts(), state, params)[1]
    return state._replace(**dict(zip(cl._GRF_FIELDS, solved)))


FIELDS = ("joint_torques", "foot_forces_grf", "root_pos", "root_lin_vel",
          "estimator_x", "estimator_P", "foot_pos_target_last_time",
          "qp_warm_x", "movement_mode", "contacts")


@pytest.mark.parametrize("preset", ["hardware_qp", "gazebo_mpc"])
@pytest.mark.parametrize("mode", ["full", "dual"])
def test_loop_steps_match_jax_f64(preset, mode):
    jcl, tcl, carry = _loops(preset)
    try:
        dt = jnp.asarray(jcl.main_period)
        sim, fz = carry.sim, carry.stance_forces_z
        contacts = jnp.ones(4, bool)
        targets = carry.sim.foot_pos_world - carry.sim.root_pos
        jstate, tstate = jcl.state, tcl.state
        for tick in range(20):
            s = j_sim.read_sensors(sim, jcl.model, contacts, fz, dt)
            ts = t_ctrl.SensorData(*_port_sensors(s))
            if mode == "full":
                jstate = jcl._step(jstate, s, dt, jcl.params)
                tstate = _full_step(tcl, tstate, ts, tcl.params)
            else:
                jstate = jcl._fast_step(jstate, s, dt, jcl.params)
                tstate = tcl.fast_step(tstate, ts, tcl.params)
                jsol = jcl._grf_step(jstate, jcl.params)
                jstate = jstate._replace(**{f: getattr(jsol, f)
                                            for f in jcl._GRF_FIELDS})
                tstate = _grf_step(tcl, tstate, tcl.params)
            for field in FIELDS:
                _close(getattr(tstate, field)[0].double(),
                       getattr(jstate, field), 1e-8, f"{field}, tick {tick}")
            sim, fz = j_sim.step(sim, jcl.model, jstate.joint_torques,
                                 contacts, targets, dt)
    finally:
        jcl.close()
        tcl.close()


def test_joystick_fast_step_matches_jax_f64():
    """The operator chain inside the fast step (axes -> clamp -> latch ->
    apply_commands -> fast step) against the JAX loop's jitted
    ``_fast_step_joy``, over a stand -> walk -> stand session with the GRF
    merged each tick: hardware_qp, float64, 1e-8 x scale."""
    from go1_qp_mpc_controller_torch.ctrl import command as t_cmd
    from go1_qp_mpc_controller_tpu.ctrl import command as j_cmd

    jcl, tcl, carry = _loops("hardware_qp")
    try:
        dt = jnp.asarray(jcl.main_period)
        sim, fz = carry.sim, carry.stance_forces_z
        contacts = jnp.ones(4, bool)
        targets = carry.sim.foot_pos_world - carry.sim.root_pos
        jstate, tstate = jcl.state, tcl.state
        jparams, tparams = jcl.params, tcl.params
        jjoy = j_cmd.init_joy_state(0.3, jnp.float64)
        tjoy = t_cmd.init_joy_state(1, 0.3, F64, "cpu")
        for tick in range(20):
            ax, bt = np.zeros(8), np.zeros(5, np.int32)
            if 3 <= tick < 12:
                ax[4], ax[0] = 0.5, 0.2          # forward and yaw stick
            bt[0] = int(tick in (3, 12))         # A: walk, then stand
            s = j_sim.read_sensors(sim, jcl.model, contacts, fz, dt)
            jstate, jjoy, jparams = jcl._fast_step_joy(
                jstate, jjoy, jparams, jnp.asarray(ax), jnp.asarray(bt), s,
                dt)
            tstate, tjoy, tparams = tcl.fast_step_joy(
                tstate, tjoy, tparams, torch.tensor(ax[None]),
                torch.tensor(bt[None]), t_ctrl.SensorData(*_port_sensors(s)))
            jsol = jcl._grf_step(jstate, jparams)
            jstate = jstate._replace(**{f: getattr(jsol, f)
                                        for f in jcl._GRF_FIELDS})
            tstate = _grf_step(tcl, tstate, tparams)
            for field in FIELDS + ("root_lin_vel_d", "root_euler_d",
                                   "root_pos_d"):
                _close(getattr(tstate, field)[0].double(),
                       getattr(jstate, field), 1e-8, f"{field}, tick {tick}")
            for field in tjoy._fields:
                _close(getattr(tjoy, field)[0].double(),
                       getattr(jjoy, field), 1e-12, f"joy {field}")
            _close(tparams.kp_linear[0], jparams.kp_linear, 1e-12)
            sim, fz = j_sim.step(sim, jcl.model, jstate.joint_torques,
                                 contacts, targets, dt)
        modes = int(tstate.movement_mode[0])
        assert modes == 0 and bool(tjoy.ctrl_state[0] == 0)
    finally:
        jcl.close()
        tcl.close()


# ---- the threads -----------------------------------------------------------

def _threaded(time_scale, duration, **loop_kw):
    """A port ControlLoop on hardware_qp against a SimFeeder on the CPU
    (float32, batch 1), run_dual for ``duration`` wall seconds in a thread
    with its own join timeout. Returns (loop, feeder, the last command)."""
    model, params, static = t_presets.load_preset("hardware_qp",
                                                  torch.float32,
                                                  device="cpu")
    cl = t_loop.ControlLoop(model, params, static,
                            t_types.init_ctrl_state(model, 1, device="cpu"),
                            main_period_s=0.002, grf_period_s=0.002,
                            time_scale=time_scale, sensor_period_s=0.001,
                            **loop_kw)
    feeder = t_feeder.SimFeeder(cl.bridge, model, params, height=0.3,
                                period_s=0.001, time_scale=time_scale,
                                device="cpu")
    cl.state = feeder.initial_ctrl_state()
    cl.warmup(dual=True)
    try:
        feeder.start(duration_s=60.0)
        t = threading.Thread(target=cl.run_dual,
                             kwargs={"duration_s": duration}, daemon=True)
        t.start()
        t.join(timeout=40.0)
        assert not t.is_alive()
        feeder.stop()
        assert feeder.error is None
        _, cmd = cl.bridge.read_command()
    finally:
        feeder.stop()
        cl.close()
    return cl, feeder, cmd


def test_estimator_thread_in_dual_loop():
    """``ControlLoop(estimate_in_feed=True)`` on the CPU: the estimator
    thread consumes bridge frames at the sensor cadence while the dual loop
    holds a stand. The invariants of tests/test_estimator_cadence.py hold
    at every rung; the cadence bound applies to the first rung that kept
    up."""
    duration, cadence_checked = 5.0, False
    for time_scale in (0.05, 0.025, 0.0125):
        cl, feeder, cmd = _threaded(time_scale, duration,
                                    estimate_in_feed=True)
        # ---- logical invariants: every rung --------------------------------
        assert cl.fast_ticks > 10
        assert cl.grf_ticks > 0
        est = cl.est_thread
        assert est is not None and est.error is None
        assert est.frames >= 0.5 * cl.fast_ticks, (est.frames, cl.fast_ticks)
        root = feeder.sim_root_pos
        assert np.isfinite(root).all()
        assert abs(root[2] - 0.3) < 0.06, (time_scale, root)
        est_pos = cl.state.root_pos[0].numpy()
        assert np.linalg.norm(est_pos - root) < 0.05, (est_pos, root)
        assert np.abs(cmd["tau"]).max() <= 0.8 * 35.55 + 1e-9
        assert np.abs(cmd["tau"]).max() > 0.5
        summary = cl.metrics.summary("est_frame_ms")
        assert summary["count"] == est.frames
        # ---- cadence health: enough throughput at this rung -------------
        if cl.fast_ticks > 0.4 * duration / (0.002 / time_scale):
            cadence_checked = True
            break
    if not cadence_checked:
        pytest.skip("host too loaded for any time_scale rung; logical "
                    "invariants passed at every rung")


def test_single_cadence_loop_holds_the_stand():
    """``ControlLoop.run`` (plan + solve + send each tick) against the
    feeder for 30 ticks: every tick finite, the stand held."""
    model, params, static = t_presets.load_preset("hardware_qp",
                                                  torch.float32,
                                                  device="cpu")
    cl = t_loop.ControlLoop(model, params, static,
                            t_types.init_ctrl_state(model, 1, device="cpu"),
                            main_period_s=0.002, time_scale=0.05)
    feeder = t_feeder.SimFeeder(cl.bridge, model, params, height=0.3,
                                time_scale=0.05, device="cpu")
    cl.state = feeder.initial_ctrl_state()
    cl.warmup(dual=False)
    try:
        feeder.start(duration_s=60.0)
        n = cl.run(num_ticks=30)
        feeder.stop()
    finally:
        feeder.stop()
        cl.close()
    assert n == 30
    assert cl.metrics.summary("cycle_ms")["count"] > 10
    assert torch.isfinite(cl.state.joint_torques).all()
    assert abs(feeder.sim_root_pos[2] - 0.3) < 0.02


def test_feeder_frozen_until_engaged():
    """The plant holds its pose through the controller's warm-up and its
    zero-torque ticks (A1RobotControl.cpp:292-295): it moves on the first
    nonzero torque command (tests/test_dual_loop.py)."""
    model, params, _ = t_presets.load_preset("gazebo_qp", device="cpu")
    b = t_bridge.RtBridge()
    try:
        feeder = t_feeder.SimFeeder(b, model, params, height=0.3,
                                    period_s=0.001, device="cpu")
        feeder.start(duration_s=20.0)
        time.sleep(0.15)
        assert feeder.sim_root_pos[2] == pytest.approx(0.3)
        b.push_command(np.zeros(12))
        time.sleep(0.15)
        assert feeder.sim_root_pos[2] == pytest.approx(0.3)
        ticks = feeder.ticks
        b.push_command(np.full(12, 0.5))
        deadline = time.time() + 10.0
        while feeder.ticks < ticks + 50 and time.time() < deadline:
            time.sleep(0.05)
        feeder.stop()
        assert feeder.error is None
        assert feeder.sim_root_pos[2] != pytest.approx(0.3, abs=1e-6)
        assert feeder.ticks > 50
    finally:
        b.close()

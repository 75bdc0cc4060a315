"""PyTorch port, the runtime's host side: the presets, the joystick command
chain, the joystick sources, the real-time bridge, the plant's position
mode, the metrics helpers and the ``main.py`` CLI, held against the JAX
package where it has the same function.

Float64 where a function computes (tolerance 1e-12: the same formulas);
the presets, the command chain's integer and boolean state and the bridge
exactly. The bridge tests are the cases of tests/test_runtime_bridge.py,
run on the port's own build of its copy of ``rt_bridge.cpp``.
"""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from go1_qp_mpc_controller_torch import main as t_main
from go1_qp_mpc_controller_torch.config import presets as t_presets
from go1_qp_mpc_controller_torch.ctrl import command as t_cmd
from go1_qp_mpc_controller_torch.envs import rollout as t_rollout
from go1_qp_mpc_controller_torch.envs import srb_sim as t_sim
from go1_qp_mpc_controller_torch.models import kinematics as t_kin
from go1_qp_mpc_controller_torch.models import types as t_types
from go1_qp_mpc_controller_torch.runtime import bridge
from go1_qp_mpc_controller_torch.runtime import joystick as t_joy
from go1_qp_mpc_controller_torch.utils import metrics as t_metrics
from go1_qp_mpc_controller_tpu.config import params as j_P
from go1_qp_mpc_controller_tpu.config import presets as j_presets
from go1_qp_mpc_controller_tpu.ctrl import command as j_cmd
from go1_qp_mpc_controller_tpu.envs import rollout as j_rollout
from go1_qp_mpc_controller_tpu.envs import srb_sim as j_sim
from go1_qp_mpc_controller_tpu.models import kinematics as j_kin
from go1_qp_mpc_controller_tpu.models import types as j_types
from go1_qp_mpc_controller_tpu.runtime import joystick as j_joy
from go1_qp_mpc_controller_tpu.utils import metrics as j_metrics

torch.set_num_threads(1)
F64 = torch.float64
JAX_PRESETS = sorted(p[:-5] for p in os.listdir(j_presets.PRESET_DIR)
                     if p.endswith(".yaml"))


def _close(got, want, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0)


# ---- presets ---------------------------------------------------------------

@pytest.mark.parametrize("name", JAX_PRESETS)
def test_preset_copy_equals_the_jax_yaml(name):
    with open(os.path.join(j_presets.PRESET_DIR, name + ".yaml")) as f:
        want = yaml.safe_load(f)
    with open(os.path.join(t_presets.PRESET_DIR, name + ".json")) as f:
        assert json.load(f) == want


def test_preset_names_and_rl_presets_match_jax():
    for stack in (None, "mpc", "rl"):
        assert (t_presets.available_presets(stack)
                == j_presets.available_presets(stack))
    for name in j_presets.available_presets("rl"):
        assert (t_presets.load_rl_preset(name).__dict__
                == j_presets.load_rl_preset(name).__dict__)
    with pytest.raises(ValueError):
        t_presets.load_rl_preset("gazebo_mpc")


@pytest.mark.parametrize("name", sorted(
    n for n in JAX_PRESETS if not n.startswith("rl_")))
def test_load_preset_matches_jax(name):
    jm, jp, js = j_presets.load_preset(name, jnp.float64)
    tm, tp, ts = t_presets.load_preset(name, F64, device="cpu")
    assert ts.__dict__ == js.__dict__
    for got, want in ((tm.mass, jm.mass), (tm.trunk_inertia, jm.trunk_inertia),
                      (tm.default_foot_pos, jm.default_foot_pos),
                      (tm.leg_geometry.rho_fix, jm.leg_geometry.rho_fix),
                      (tm.leg_geometry.rho_opt, jm.leg_geometry.rho_opt)):
        _close(got, want, 0)
    for field in tp._fields:
        _close(getattr(tp, field), getattr(jp, field), 0)


def test_isaac_leg_geometry_matches_jax():
    got = t_kin.isaac_leg_geometry(F64, "cpu")
    want = j_kin.isaac_leg_geometry(jnp.float64)
    _close(got.rho_fix, want.rho_fix, 0)
    _close(got.rho_opt, want.rho_opt, 0)


# ---- the joystick command chain ------------------------------------------

def _axes_pair(**kw):
    """The same JoyAxes sample for JAX (unbatched) and the port (batch 1)."""
    base = dict(velx=0.0, vely=0.0, velz=0.0, yaw_rate=0.0, pitch_rate=0.0,
                roll_rate=0.0, toggle=False, exit=False)
    base.update(kw)
    j = j_cmd.JoyAxes(**{k: jnp.asarray(v) for k, v in base.items()})
    t = t_cmd.JoyAxes(**{k: torch.tensor([v], dtype=torch.bool
                                         if isinstance(v, bool) else F64)
                         for k, v in base.items()})
    return j, t


def _setup():
    jm = j_types.default_robot_model(jnp.float64)
    tm = t_types.default_robot_model(F64, "cpu")
    j = (j_cmd.init_joy_state(0.3, jnp.float64),
         j_types.init_ctrl_state(jm, jnp.float64),
         j_types.default_ctrl_params(jnp.float64))
    t = (t_cmd.init_joy_state(1, 0.3, F64, "cpu"),
         t_types.init_ctrl_state(tm, 1, F64, "cpu"),
         t_types.default_ctrl_params(F64, "cpu"))
    return j, t


def _assert_command_state(t, j):
    """Port (joy, ctrl, params) at batch 1 equal to JAX's."""
    (tj, tc, tp), (jj, jc, jp) = t, j
    for field in tj._fields:
        _close(getattr(tj, field)[0], getattr(jj, field))
    for field in ("movement_mode", "root_lin_vel_d", "root_ang_vel_d",
                  "root_euler_d", "root_pos_d"):
        _close(getattr(tc, field)[0], getattr(jc, field))
    _close(tp.kp_linear.reshape(-1, 3)[0], jp.kp_linear)


def test_clamp_axes_matches_jax():
    j, t = _axes_pair(velx=5.0, vely=-5.0, velz=1.0, yaw_rate=10.0,
                      pitch_rate=-3.0, roll_rate=2.0)
    want, got = j_cmd.clamp_axes(j), t_cmd.clamp_axes(t)
    for field in got._fields:
        _close(getattr(got, field)[0], getattr(want, field), 0)


@pytest.mark.parametrize("buttons", [[1, 0, 0, 0, 0], [0, 0, 0, 0, 1]])
def test_axes_from_raw_matches_jax(buttons):
    raw = np.zeros(8)
    raw[4], raw[3], raw[1] = 0.5, -1.0, 0.25
    raw[0], raw[7], raw[6] = -0.5, 1.0, -1.0
    want = j_cmd.axes_from_raw(jnp.asarray(raw), jnp.asarray(buttons))
    got = t_cmd.axes_from_raw(torch.tensor(raw[None]),
                              torch.tensor([buttons]))
    for field in got._fields:
        _close(getattr(got, field)[0], getattr(want, field), 0)


def test_latch_then_apply_matches_jax():
    (jj, jc, jp), (tj, tc, tp) = _setup()
    for sample in (dict(toggle=True), dict()):
        ja, ta = _axes_pair(**sample)
        jj, tj = j_cmd.latch_buttons(jj, ja), t_cmd.latch_buttons(tj, ta)
    ja, ta = _axes_pair()
    j = j_cmd.apply_commands(jj, ja, jc, jp, jnp.asarray(0.01))
    t = t_cmd.apply_commands(tj, ta, tc, tp, 0.01)
    _assert_command_state(t, j)
    assert int(t[0].ctrl_state[0]) == 1 and not bool(t[0].toggle_request[0])


@pytest.mark.parametrize("case", ["height", "euler", "toggle_lock",
                                  "walk_gains", "stand_gains"])
def test_apply_commands_sequences_match_jax(case):
    """The tests/test_command.py cases, each a sequence of samples through
    both packages, compared after every call."""
    (jj, jc, jp), (tj, tc, tp) = _setup()
    if case == "height":
        steps = [(0.01, dict(velz=j_P.JOY_CMD_BODY_HEIGHT_VEL))] * 300
    elif case == "euler":
        steps = [(0.01, dict(yaw_rate=0.5, roll_rate=-0.2))] * 100
    elif case == "toggle_lock":
        jj = jj._replace(toggle_request=jnp.asarray(True))
        tj = tj._replace(toggle_request=torch.tensor([True]))
        steps = [(0.002, dict())]
    else:
        jj = jj._replace(ctrl_state=jnp.asarray(1, jnp.int32))
        tj = tj._replace(ctrl_state=torch.tensor([1], dtype=torch.int32))
        steps = [(0.002, dict(velx=0.3 if case == "walk_gains" else 0.0))]
    for dt, sample in steps:
        ja, ta = _axes_pair(**sample)
        jj, jc, jp = j_cmd.apply_commands(jj, ja, jc, jp, jnp.asarray(dt))
        tj, tc, tp = t_cmd.apply_commands(tj, ta, tc, tp, dt)
        _assert_command_state((tj, tc, tp), (jj, jc, jp))
    if case == "toggle_lock":
        # leave walking: the xy target locks at the current position
        jc = jc._replace(root_pos=jnp.asarray([1.5, -0.4, 0.29]))
        tc = tc._replace(root_pos=torch.tensor([[1.5, -0.4, 0.29]],
                                               dtype=F64))
        jj = jj._replace(toggle_request=jnp.asarray(True))
        tj = tj._replace(toggle_request=torch.tensor([True]))
        ja, ta = _axes_pair()
        j = j_cmd.apply_commands(jj, ja, jc, jp, jnp.asarray(0.002))
        t = t_cmd.apply_commands(tj, ta, tc, tp, 0.002)
        _assert_command_state(t, j)
        _close(t[1].root_pos_d[0, 0:2], [1.5, -0.4])


def test_terminal_state_matches_jax():
    q = np.array([0.0, 0.67, -1.3] * 4)
    cases = [q, q.copy(), q.copy(), q.copy()]
    cases[1][0] = 1.2
    cases[2][11] = -0.5
    cases[3][4] = j_P.JOINT_POS_LIMITS[1][1]
    got = t_cmd.is_terminal_state(torch.tensor(np.stack(cases)))
    want = [bool(j_cmd.is_terminal_state(jnp.asarray(c))) for c in cases]
    assert got.tolist() == want == [False, True, True, True]


def test_joystick_sources_match_jax():
    events = [(3, np.ones(8), np.ones(5)), (0, np.zeros(8), np.zeros(5)),
              (3, -np.ones(8), np.zeros(5))]
    t_src, j_src = t_joy.ScriptedJoySource(events), j_joy.ScriptedJoySource(
        events)
    for _ in range(6):
        got, want = t_src.poll(), j_src.poll()
        assert len(got) == len(want)
        for (ga, gb), (wa, wb) in zip(got, want):
            _close(ga, wa, 0)
            _close(gb, wb, 0)
    q = t_joy.QueueJoySource()
    q.push(np.ones(8), np.zeros(5))
    q.push(np.zeros(8), np.ones(5))
    assert len(q.poll()) == 2 and q.poll() == []


# ---- the real-time bridge (tests/test_runtime_bridge.py's cases) ---------

@pytest.fixture(scope="module")
def rtb():
    b = bridge.RtBridge(power_level=5)
    yield b
    b.close()


def test_bridge_is_the_ports_own_build():
    bridge.build()
    path = bridge.library_path()
    assert path.exists() and path.parent.name == "rt_bridge"
    assert "go1_qp_mpc_controller_tpu" not in str(path)
    assert bridge.SOURCE.parent.parent.name == "runtime"
    assert bridge.SOURCE.parents[2].name == "go1_qp_mpc_controller_torch"


def test_sensor_roundtrip(rtb):
    quat = np.array([1.0, 0.0, 0.0, 0.0])
    acc = np.array([0.1, 0.2, 9.8])
    gyro = np.array([0.01, -0.02, 0.03])
    q = np.linspace(-1, 1, 12)
    dq = np.linspace(0, 2, 12)
    ff = np.array([10.0, 20.0, 30.0, 40.0])
    rtb.push_sensors(quat, acc, gyro, q, dq, ff)
    tick, s = rtb.read_sensors()
    assert tick >= 1
    np.testing.assert_allclose(s["quat"], quat)
    np.testing.assert_allclose(s["joint_pos"], q)
    np.testing.assert_allclose(s["foot_force"], ff)
    rtb.push_sensors(quat, acc, gyro, q, dq, ff)
    tick2, _ = rtb.read_sensors()
    assert tick2 == tick + 1


def test_command_safety_clamps(rtb):
    tau = np.full(12, 100.0)
    tau[3] = np.nan
    q = np.full(12, 10.0)
    rtb.push_command(tau, q, np.ones(12), np.ones(12))
    _, c = rtb.read_command()
    np.testing.assert_allclose(c["tau"][0], 23.7 * 0.5)
    np.testing.assert_allclose(c["tau"][2], 35.55 * 0.5)
    assert c["tau"][3] == 0.0
    np.testing.assert_allclose(c["q"][0], 0.9425)
    np.testing.assert_allclose(c["q"][1], 2.7855)
    rtb.push_command(-tau, -q, np.ones(12), np.ones(12))
    _, c = rtb.read_command()
    np.testing.assert_allclose(c["tau"][0], -23.7 * 0.5)
    np.testing.assert_allclose(c["q"][2], -2.6285)


def test_rate_keeper_timing():
    worst = bridge.timing_self_test(period_s=0.002, iters=200)
    assert worst < 0.05, f"worst period error {worst * 1e3:.2f} ms"


def test_rate_keeper_object():
    rk = bridge.RateKeeper(0.001)
    t0 = time.perf_counter()
    for _ in range(50):
        rk.wait()
    elapsed = time.perf_counter() - t0
    assert 0.04 < elapsed < 0.5
    assert rk.overruns < 50
    rk.close()


def test_foot_force_ring_filter():
    b = bridge.RtBridge(power_level=5, foot_filter_window=5)
    try:
        quat = np.array([1.0, 0.0, 0.0, 0.0])
        z3, q12 = np.zeros(3), np.zeros(12)
        ff = np.array([10.0, 20.0, 30.0, 40.0])
        b.push_sensors(quat, z3, z3, q12, q12, ff)
        _, s = b.read_sensors()
        np.testing.assert_allclose(s["foot_force"], ff / 5.0)
        for _ in range(4):
            b.push_sensors(quat, z3, z3, q12, q12, ff)
        _, s = b.read_sensors()
        np.testing.assert_allclose(s["foot_force"], ff)
        b.push_sensors(quat, z3, z3, q12, q12, ff + 50.0)
        _, s = b.read_sensors()
        np.testing.assert_allclose(s["foot_force"], ff + 10.0)
    finally:
        b.close()


def test_sdk_leg_order_remap():
    swap_j = [3, 4, 5, 0, 1, 2, 9, 10, 11, 6, 7, 8]
    swap_f = [1, 0, 3, 2]
    b = bridge.RtBridge(power_level=10, sdk_leg_order=True)
    try:
        quat = np.array([1.0, 0.0, 0.0, 0.0])
        z3 = np.zeros(3)
        jp_ctrl = 0.01 * np.arange(12.0)
        jv_ctrl = np.arange(12.0) + 100.0
        ff_ctrl = np.array([11.0, 22.0, 33.0, 44.0])
        b.push_sensors(quat, z3, z3, jp_ctrl[swap_j], jv_ctrl[swap_j],
                       ff_ctrl[swap_f])
        _, s = b.read_sensors()
        np.testing.assert_allclose(s["joint_pos"], jp_ctrl)
        np.testing.assert_allclose(s["joint_vel"], jv_ctrl)
        np.testing.assert_allclose(s["foot_force"], ff_ctrl)
        tau_ctrl = 0.1 * np.arange(12.0)
        b.push_command(tau_ctrl)
        _, c = b.read_command()
        np.testing.assert_allclose(c["tau"], tau_ctrl[swap_j])
    finally:
        b.close()


def test_sim_feeder_order_untouched():
    b = bridge.RtBridge(power_level=10)
    try:
        quat = np.array([1.0, 0.0, 0.0, 0.0])
        z3 = np.zeros(3)
        jp = 0.01 * np.arange(12.0)
        b.push_sensors(quat, z3, z3, jp, jp, np.arange(4.0))
        _, s = b.read_sensors()
        np.testing.assert_allclose(s["joint_pos"], jp)
        np.testing.assert_allclose(s["foot_force"], np.arange(4.0))
    finally:
        b.close()


# ---- the plant's position mode, metrics, the CLI -------------------------

def test_step_pd_matches_jax():
    """Ten position-mode plant steps (the RL stack's motor loop, four
    substeps each) from the standing start, with seeded joint targets and
    gains: float64, within 1e-10 (forces reach 11 N)."""
    rng = np.random.default_rng(3)
    jm = j_types.default_robot_model(jnp.float64)
    tm = t_types.default_robot_model(F64, "cpu")
    jsim = j_sim.init_sim_state(jm, 0.3, jnp.float64)
    tsim = t_sim.init_sim_state(tm, 1, 0.3)
    targets = np.asarray(jsim.foot_pos_world - jsim.root_pos)
    contacts = np.ones(4, bool)
    q0 = np.asarray(jsim.prev_joint_pos)
    for _ in range(10):
        cmd_q = q0 + 0.05 * rng.normal(size=12)
        kp, kd = np.full(12, 18.0), np.full(12, 0.5)
        ff = 0.1 * rng.normal(size=12)
        jsim, jfz = j_sim.step_pd(jsim, jm, *map(jnp.asarray, (
            cmd_q, kp, kd, ff, contacts, targets)), jnp.asarray(0.004))
        tsim, tfz = t_sim.step_pd(tsim, tm, *[torch.tensor(a[None]) for a in (
            cmd_q, kp, kd, ff, contacts, targets)], 0.004)
        _close(tfz[0], jfz, 1e-10)
        for field in tsim._fields:
            _close(getattr(tsim, field)[0], getattr(jsim, field), 1e-10)


def test_metrics_match_jax():
    t_log, j_log = t_metrics.MetricsLogger(), j_metrics.MetricsLogger()
    for v in (3.0, 1.0, 2.0, 10.0):
        t_log.log("x", torch.tensor(v))
        j_log.log("x", jnp.asarray(v))
    assert t_log.summary("x") == j_log.summary("x")
    assert t_log.summary("none") == {}
    with t_metrics.timed(t_log, "span", sync=torch.zeros(3)):
        pass
    assert t_log.records("span")[0]["unit"] == "ms"
    start = np.array([[0.1, 0.1, -0.3]] * 4)
    target = start + 0.05
    _close(t_metrics.swing_path_points(start, target),
           j_metrics.swing_path_points(start, target))
    jm = j_types.default_robot_model(jnp.float64)
    tm = t_types.default_robot_model(F64, "cpu")
    got = t_metrics.controller_telemetry(t_types.init_ctrl_state(tm, 1, F64,
                                                                 "cpu"))
    want = j_metrics.controller_telemetry(j_types.init_ctrl_state(
        jm, jnp.float64))
    assert got == want


def test_runtime_imports_no_jax_and_no_yaml():
    """In a fresh interpreter, the port's runtime (presets, loop, feeder,
    estimator, CLI) runs a few CPU ticks and loads neither JAX, the JAX
    package, its bridge library nor a YAML parser."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, torch\n"
        "from go1_qp_mpc_controller_torch import main\n"
        "from go1_qp_mpc_controller_torch.config import presets\n"
        "from go1_qp_mpc_controller_torch.runtime import feeder, loop\n"
        "m, p, s = presets.load_preset('hardware_qp', device='cpu')\n"
        "from go1_qp_mpc_controller_torch.models import types\n"
        "cl = loop.ControlLoop(m, p, s, types.init_ctrl_state(m, 1, "
        "device='cpu'), estimate_in_feed=True, time_scale=0.05)\n"
        "fd = feeder.SimFeeder(cl.bridge, m, p, device='cpu')\n"
        "cl.state = fd.initial_ctrl_state(); cl.warmup()\n"
        "fd.start(duration_s=30.0); cl.run_dual(num_ticks=5); fd.stop()\n"
        "cl.close()\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'yaml',"
        " 'go1_qp_mpc_controller_tpu')]\n"
        "assert not bad, bad\n"
        "libs = open('/proc/self/maps').read()\n"
        "assert 'librt_bridge-' in libs\n"
        "assert 'go1_qp_mpc_controller_tpu' not in libs\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_captured_step_runs_eagerly_on_the_cpu():
    """A one-part ``StagedStep`` (``graphs.single``) records a graph only
    on the card; on the CPU a call is the function itself, on the same
    nested arguments, with no routes."""
    from go1_qp_mpc_controller_torch.utils import graphs

    def fn(pair, scale):
        return pair[0] * scale + pair[1], pair[1].clone()

    args = ((torch.ones(3), torch.arange(3.0)), torch.tensor(2.0))
    step = graphs.StagedStep(graphs.single(fn), *args)
    assert step._graphs is None
    routes, got = step((torch.full((3,), 4.0), torch.zeros(3)),
                       torch.tensor(0.5))
    assert routes == ()
    assert torch.equal(got[0], torch.full((3,), 2.0))
    copies = graphs.clone(got)
    assert torch.equal(copies[1], got[1]) and copies[1] is not got[1]


def test_trace_writes_a_chrome_trace(tmp_path):
    with t_metrics.trace(str(tmp_path)):
        torch.ones(4) @ torch.ones(4)
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_main_rollout_runs_and_refuses_what_is_not_ported(capsys,
                                                         tmp_path):
    """``rollout`` prints the JAX CLI's keys, and ``--trace`` / ``--plot``
    (ported) write their files; what stays refused is what the JAX CLI
    refuses: an mpc axis that does not divide the world (one process)."""
    t_main.main(["--device", "cpu", "--preset", "gazebo_qp", "rollout",
                 "--steps", "120", "--no-ekf"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"final_pos", "mean_vx", "height_range",
                        "max_tilt_rad"}
    assert np.isfinite(out["final_pos"]).all()
    npz, png = tmp_path / "x.npz", tmp_path / "x.png"
    t_main.main(["--device", "cpu", "rollout", "--steps", "2", "--trace",
                 str(npz), "--plot", str(png)])
    assert npz.stat().st_size > 0 and png.stat().st_size > 0
    with pytest.raises(ValueError, match="not divisible by mpc=2"):
        t_main.main(["--device", "cpu", "sweep", "--batch", "2",
                     "--mpc-parallel", "2"])


def test_feeder_carry_matches_rollout_init():
    """The feeder's initial controller state is ``init_carry``'s, and that
    equals the JAX package's (what the JAX feeder hands its loop)."""
    from go1_qp_mpc_controller_torch.runtime import feeder as t_feeder

    jm, jp, _ = j_presets.load_preset("hardware_qp", jnp.float32)
    tm, tp, _ = t_presets.load_preset("hardware_qp", torch.float32,
                                      device="cpu")
    b = bridge.RtBridge()
    try:
        feeder = t_feeder.SimFeeder(b, tm, tp, height=0.3, device="cpu")
        got = feeder.initial_ctrl_state()
    finally:
        b.close()
    want = j_rollout.init_carry(jm, jp, height=0.3, dtype=jnp.float32).ctrl
    ref = t_rollout.init_carry(tm, tp, 1, dtype=torch.float32, device="cpu")
    for field in ("root_pos", "root_pos_d", "estimator_x", "estimator_P",
                  "foot_pos_start"):
        _close(getattr(got, field)[0], getattr(want, field), 1e-6)
        _close(getattr(got, field), getattr(ref.ctrl, field), 0)
    _close(feeder.sim_root_pos, [0.0, 0.0, 0.3], 1e-7)

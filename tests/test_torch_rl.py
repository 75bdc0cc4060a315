"""PyTorch port, the RL stack: ``ctrl/rl.py``, ``models/policy.py`` and
``envs/rollout.rl_rollout`` against the JAX package's on numpy-seeded
inputs, with the JAX actor's weights carried across
(``compat/convert.actor_from_numpy``).

Tolerances: float64 1e-12 on the observation, the servo / switch
arithmetic and the MLP (one product chain, summation order only), 1e-8 on
the 300-tick closed loop (the PD plant's finite-difference velocities
amplify the order-of-summation differences: 3e-11 measured); float32
1e-5 relative on the observation and the MLP, and over the servo phase
plus 20 walk ticks of the closed loop 2e-3 on the observation, 5e-4 on
the targets and 1e-5 m on the root (the float32 loop itself sits 3.2e-4 /
8.1e-5 / 6.7e-7 from float64 there), the rest held by tests/test_rl.py's
criteria.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch.compat import convert
from go1_qp_mpc_controller_torch.ctrl import rl as t_rl
from go1_qp_mpc_controller_torch.envs import rollout as t_rollout
from go1_qp_mpc_controller_torch.models import policy as t_policy
from go1_qp_mpc_controller_torch.models import types as t_types
from go1_qp_mpc_controller_torch.utils import rotations as t_rot
from go1_qp_mpc_controller_tpu.ctrl import rl as j_rl
from go1_qp_mpc_controller_tpu.envs import rollout as j_rollout
from go1_qp_mpc_controller_tpu.models import policy as j_policy
from go1_qp_mpc_controller_tpu.models import types as j_types

torch.set_num_threads(1)
DTYPES = {"float64": (torch.float64, jnp.float64, 1e-12),
          "float32": (torch.float32, jnp.float32, 1e-5)}
BATCH = 5


def _actors(dtype_name, seed=0):
    """(JAX MLPParams, the port's ActorMLP with the same weights)."""
    t_dtype, j_dtype, _ = DTYPES[dtype_name]
    params = j_policy.init_mlp(jax.random.PRNGKey(seed), dtype=j_dtype)
    return params, convert.actor_from_numpy(
        jax.tree.map(np.asarray, params), "cpu", t_dtype)


def _close(got, want, tol, what=""):
    """Within ``tol`` x max(1, max|want|)."""
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _obs_inputs(rng):
    """A batch of the observation's inputs: random attitudes and yaws,
    velocities, commands, joints around the default pose, actions."""
    euler = rng.uniform(-0.3, 0.3, (BATCH, 3))
    euler[:, 2] = rng.uniform(-np.pi, np.pi, BATCH)
    return dict(euler=euler, vel=rng.normal(size=(BATCH, 3)),
                gyro=rng.normal(size=(BATCH, 3)),
                cmd=rng.uniform(-1, 1, (BATCH, 3)),
                q=np.asarray(j_rl.DEFAULT_JOINT_POS)
                + 0.3 * rng.normal(size=(BATCH, 12)),
                dq=5.0 * rng.normal(size=(BATCH, 12)),
                prev=30.0 * rng.normal(size=(BATCH, 12)))


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_observation_matches_jax(dtype_name):
    """Layout, scaling, clipping and the yawed frame of the 48-dim
    observation, per scenario against the JAX function."""
    t_dtype, j_dtype, tol = DTYPES[dtype_name]
    from go1_qp_mpc_controller_tpu.utils import rotations as j_rot
    x = _obs_inputs(np.random.default_rng(0))
    x["vel"][0] = [60.0, -70.0, 0.0]     # beyond the clip after scaling
    j = {k: jnp.asarray(v, j_dtype) for k, v in x.items()}
    rot = jax.vmap(j_rot.euler_to_rot_mat)(j["euler"])
    rot_z = jax.vmap(j_rot.rot_z)(j["euler"][:, 2])
    want = jax.vmap(j_rl.build_observation)(
        rot, rot_z, j["vel"], j["gyro"], j["cmd"], j["q"], j["dq"],
        j["prev"])
    t = {k: torch.tensor(v, dtype=t_dtype) for k, v in x.items()}
    got = t_rl.build_observation(
        t_rot.euler_to_rot_mat(t["euler"]), t_rot.rot_z(t["euler"][:, 2]),
        t["vel"], t["gyro"], t["cmd"], t["q"], t["dq"], t["prev"])
    assert got.shape == (BATCH, 48)
    _close(got, want, tol)
    assert float(got[0, :3].abs().max()) == t_rl.CLIP_OBS
    # the yawed frame: a world-x velocity at yaw psi reads (2 cos, -2 sin)
    yaw = float(x["euler"][1, 2])
    flat = t_rot.euler_to_rot_mat(torch.tensor([[0.0, 0.0, yaw]],
                                               dtype=t_dtype))
    obs = t_rl.build_observation(
        flat, t_rot.rot_z(torch.tensor([yaw], dtype=t_dtype)),
        torch.tensor([[1.0, 0.0, 0.0]], dtype=t_dtype),
        torch.zeros((1, 3), dtype=t_dtype), torch.zeros((1, 3),
                                                        dtype=t_dtype),
        torch.tensor([t_rl.DEFAULT_JOINT_POS], dtype=t_dtype),
        torch.zeros((1, 12), dtype=t_dtype),
        torch.zeros((1, 12), dtype=t_dtype))
    _close(obs[0, :3], [2 * np.cos(yaw), -2 * np.sin(yaw), 0.0], tol)
    _close(obs[0, 6:9], [0.0, 0.0, -1.0], tol)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_mlp_apply_matches_jax(dtype_name):
    """The actor on carried-across weights, batched and one at a time."""
    t_dtype, j_dtype, tol = DTYPES[dtype_name]
    params, actor = _actors(dtype_name)
    assert [tuple(layer.weight.shape) for layer in actor.layers] == [
        (512, 48), (256, 512), (128, 256), (12, 128)]
    obs = np.random.default_rng(1).normal(size=(7, 48))
    want = j_policy.mlp_apply(params, jnp.asarray(obs, j_dtype))
    got = t_policy.mlp_apply(actor, torch.tensor(obs, dtype=t_dtype))
    _close(got, want, tol)
    one = t_policy.mlp_apply(actor, torch.tensor(obs[3], dtype=t_dtype))
    _close(one, want[3], tol)


def test_init_mlp_scaled_normal():
    """``init_mlp``: rsl_rl's scaled-normal weights (std sqrt(2 / fan_in))
    and zero biases, the same draws for the same generator seed."""
    a = t_policy.init_mlp(torch.Generator().manual_seed(3), device="cpu")
    b = t_policy.init_mlp(torch.Generator().manual_seed(3), device="cpu")
    for la, lb in zip(a.layers, b.layers):
        assert torch.equal(la.weight, lb.weight)
        assert not la.bias.any()
        fan_in = la.weight.shape[1]
        std = float(la.weight.std())
        assert abs(std / (2.0 / fan_in) ** 0.5 - 1.0) < 0.1, std
        assert la.weight.dtype == torch.float32


def test_torchscript_conversion_matches_torch(tmp_path):
    """A scripted torch MLP (built as tests/test_rl.py:66-87 builds it)
    loaded by both packages: the port's actor gives the module's outputs,
    and the JAX package's loaded params give the same."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(
        torch.nn.Linear(48, 512), torch.nn.ELU(),
        torch.nn.Linear(512, 256), torch.nn.ELU(),
        torch.nn.Linear(256, 128), torch.nn.ELU(),
        torch.nn.Linear(128, 12))
    net.eval()
    path = os.path.join(tmp_path, "actor.pt")
    torch.jit.trace(net, torch.ones(1, 48)).save(path)
    actor = t_policy.load_torchscript_actor(path, device="cpu")
    x = np.random.default_rng(1).normal(size=(5, 48)).astype(np.float32)
    with torch.no_grad():
        ref = net(torch.from_numpy(x))
    got = t_policy.mlp_apply(actor, torch.from_numpy(x))
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    want = j_policy.mlp_apply(j_policy.load_torchscript_actor(path),
                              jnp.asarray(x))
    _close(got, want, 1e-5)
    # a module whose weights and biases do not pair is refused
    bad = torch.nn.Linear(4, 3, bias=False)
    bad_path = os.path.join(tmp_path, "bad.pt")
    torch.jit.trace(bad, torch.ones(1, 4)).save(bad_path)
    with pytest.raises(ValueError, match="unpaired"):
        t_policy.load_torchscript_actor(bad_path, device="cpu")


def _rl_state_inputs(rng, dtype_name):
    """A batch of RL states (mixed modes and servo clocks) as numpy."""
    modes = np.array([0, 1, 1, 0, 1], np.int32)
    return dict(prev_action=rng.normal(size=(BATCH, 12)),
                servo_motion_time=rng.uniform(0, 1200, BATCH),
                servo_start_pose=rng.normal(size=(BATCH, 12)),
                movement_mode=modes)


def _states(x, dtype_name):
    t_dtype, j_dtype, _ = DTYPES[dtype_name]
    j = j_rl.RLControllerState(**{
        k: jnp.asarray(v, jnp.int32 if k == "movement_mode" else j_dtype)
        for k, v in x.items()})
    t = convert.from_numpy(t_rl.RLControllerState, x, "cpu", t_dtype)
    return j, t


def _same_state(got, want, tol):
    for name in got._fields:
        _close(getattr(got, name), getattr(want, name), tol, name)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_advance_and_servo_match_jax(dtype_name):
    """``advance`` (policy, clip, scale, pose clip, walk gains) and
    ``advance_servo`` (the 1000-tick interpolation, clamped past its end)
    per scenario against the JAX functions."""
    t_dtype, j_dtype, tol = DTYPES[dtype_name]
    rng = np.random.default_rng(2)
    params, actor = _actors(dtype_name)
    js, ts = _states(_rl_state_inputs(rng, dtype_name), dtype_name)
    obs = 20.0 * rng.normal(size=(BATCH, 48))   # drives the pose clip
    q = rng.normal(size=(BATCH, 12))
    j_state, j_cmd = jax.vmap(j_rl.advance, in_axes=(0, None, 0))(
        js, params, jnp.asarray(obs, j_dtype))
    t_state, t_cmd = t_rl.advance(ts, actor, torch.tensor(obs, dtype=t_dtype))
    _same_state(t_state, j_state, tol)
    for name in t_cmd._fields:
        _close(getattr(t_cmd, name), getattr(j_cmd, name), tol, name)
    assert (t_cmd.q >= torch.tensor(t_rl.CLIP_POSE_LOWER, dtype=t_dtype)).all()
    j_state, j_cmd = jax.vmap(j_rl.advance_servo)(js, jnp.asarray(q, j_dtype))
    t_state, t_cmd = t_rl.advance_servo(ts, torch.tensor(q, dtype=t_dtype))
    _same_state(t_state, j_state, tol)
    for name in t_cmd._fields:
        _close(getattr(t_cmd, name), getattr(j_cmd, name), tol, name)


def test_servo_interpolation_reaches_target():
    """tests/test_rl.py's servo check at batch 2: midpoint at 500 ticks,
    the crouch pose at 1000."""
    state = t_rl.init_rl_state(2, dtype=torch.float64, device="cpu")
    q = torch.tensor([[0.0, 1.2, -2.0] * 4] * 2, dtype=torch.float64)
    target = torch.tensor(t_rl.SERVO_TARGET, dtype=torch.float64)
    for k in range(1000):
        state, cmd = t_rl.advance_servo(state, q)
        if k == 499:
            torch.testing.assert_close(cmd.q, 0.5 * q + 0.5 * target,
                                       rtol=0, atol=1e-12)
    torch.testing.assert_close(cmd.q, target.expand(2, 12), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_switch_and_mixed_mode_step_match_jax(dtype_name):
    """``switch_mode`` on a batch with presses on some scenarios, then
    ``rl_control_step`` on a batch of mixed modes: each scenario takes its
    own mode's path, as the JAX function does for it alone."""
    t_dtype, j_dtype, tol = DTYPES[dtype_name]
    from go1_qp_mpc_controller_tpu.utils import rotations as j_rot
    rng = np.random.default_rng(3)
    params, actor = _actors(dtype_name)
    js, ts = _states(_rl_state_inputs(rng, dtype_name), dtype_name)
    press = np.array([True, True, False, False, True])
    j_sw = jax.vmap(j_rl.switch_mode)(js, jnp.asarray(press))
    t_sw = t_rl.switch_mode(ts, torch.tensor(press))
    _same_state(t_sw, j_sw, tol)
    assert t_sw.movement_mode.tolist() == [1, 0, 1, 0, 0]
    x = _obs_inputs(rng)
    j = {k: jnp.asarray(v, j_dtype) for k, v in x.items()}
    j_state, j_cmd, j_obs = jax.vmap(
        j_rl.rl_control_step, in_axes=(0, None) + (0,) * 7)(
        j_sw, params, jax.vmap(j_rot.euler_to_rot_mat)(j["euler"]),
        jax.vmap(j_rot.rot_z)(j["euler"][:, 2]), j["vel"], j["gyro"],
        j["cmd"], j["q"], j["dq"])
    t = {k: torch.tensor(v, dtype=t_dtype) for k, v in x.items()}
    t_state, t_cmd, t_obs = t_rl.rl_control_step(
        t_sw, actor, t_rot.euler_to_rot_mat(t["euler"]),
        t_rot.rot_z(t["euler"][:, 2]), t["vel"], t["gyro"], t["cmd"],
        t["q"], t["dq"])
    _close(t_obs, j_obs, tol, "obs")
    _same_state(t_state, j_state, tol)
    for name in t_cmd._fields:
        _close(getattr(t_cmd, name), getattr(j_cmd, name), tol, name)
    walk = torch.tensor(t_rl.WALK_P_GAINS, dtype=t_dtype)
    servo = torch.tensor(t_rl.SERVO_P_GAINS, dtype=t_dtype)
    for b, mode in enumerate(t_sw.movement_mode.tolist()):
        assert torch.equal(t_cmd.kp[b], walk if mode else servo)


def test_joint_history_matches_jax():
    rng = np.random.default_rng(4)
    hist = t_rl.init_joint_history(2, 3, torch.float64, "cpu")
    j_hist = jax.vmap(lambda _: j_rl.init_joint_history(3, jnp.float64))(
        jnp.arange(2))
    for _ in range(4):
        q, dq = rng.normal(size=(2, 12)), rng.normal(size=(2, 12))
        hist = t_rl.update_joint_history(hist, torch.tensor(q),
                                         torch.tensor(dq))
        j_hist = jax.vmap(j_rl.update_joint_history)(
            j_hist, jnp.asarray(q), jnp.asarray(dq))
    _close(hist.pos_err, j_hist.pos_err, 1e-15)
    _close(hist.vel, j_hist.vel, 1e-15)


SWITCH_AT = 150
ROLL_TICKS = 300
ROLL_BATCH = 3
ROLL_TOLS = {"float64": {"obs": 1e-8, "target_q": 1e-8, "root_pos": 1e-10,
                         "kp": 0.0, "movement_mode": 0.0},
             "float32": {"obs": 2e-3, "target_q": 5e-4, "root_pos": 1e-5,
                         "kp": 0.0, "movement_mode": 0.0}}


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_rl_rollout_matches_jax(dtype_name):
    """``rl_rollout`` at batch 3 (start velocities moved by seeded draws),
    300 ticks with the press at 150 and vx 0.3 from it, against the JAX
    ``rl_rollout`` under vmap: tick by tick over the whole run in float64,
    over the servo phase and 20 walk ticks in float32; tests/test_rl.py's
    criteria on the port's whole run."""
    t_dtype, j_dtype, _ = DTYPES[dtype_name]
    tols = ROLL_TOLS[dtype_name]
    params, actor = _actors(dtype_name, seed=3)
    dv = 0.02 * np.random.default_rng(5).normal(size=(ROLL_BATCH, 3))
    jm = j_types.default_robot_model(j_dtype)
    jc = j_rollout.init_rl_carry(jm, dtype=j_dtype)

    def one(dvi):
        c = jc._replace(sim=jc.sim._replace(
            root_lin_vel=jc.sim.root_lin_vel + dvi))
        return j_rollout.rl_rollout(
            c, jm, params, ROLL_TICKS, jnp.asarray(0.004, j_dtype),
            command_fn=lambda i: jnp.where(i >= SWITCH_AT,
                                           jnp.asarray([0.3, 0.0, 0.0]),
                                           jnp.zeros(3)),
            toggle_fn=lambda i: i == SWITCH_AT)[1]

    want = jax.jit(jax.vmap(one))(jnp.asarray(dv, j_dtype))
    tm = t_types.default_robot_model(t_dtype, "cpu")
    tc = t_rollout.init_rl_carry(tm, ROLL_BATCH, dtype=t_dtype, device="cpu")
    tc = tc._replace(sim=tc.sim._replace(
        root_lin_vel=tc.sim.root_lin_vel + torch.tensor(dv, dtype=t_dtype)))
    _, got = t_rollout.rl_rollout(
        tc, tm, actor, ROLL_TICKS, 0.004,
        command_fn=lambda i: [0.3, 0.0, 0.0] if i >= SWITCH_AT else [0.0] * 3,
        toggle_fn=lambda i: i == SWITCH_AT)
    upto = ROLL_TICKS if dtype_name == "float64" else SWITCH_AT + 20
    for name in got._fields:
        g = getattr(got, name)
        w = np.swapaxes(np.asarray(getattr(want, name)), 0, 1)
        assert g.shape == w.shape, name
        _close(g[:upto], w[:upto], tols[name], name)

    q, kp = got.target_q, got.kp
    assert torch.isfinite(got.obs).all() and torch.isfinite(q).all()
    assert float(got.obs[..., :36].abs().max()) <= t_rl.CLIP_OBS
    lo = torch.tensor(t_rl.CLIP_POSE_LOWER, dtype=t_dtype)
    hi = torch.tensor(t_rl.CLIP_POSE_UPPER, dtype=t_dtype)
    assert (q >= lo - 1e-5).all() and (q <= hi + 1e-5).all()
    assert (kp[SWITCH_AT - 1] == torch.tensor(t_rl.SERVO_P_GAINS,
                                              dtype=t_dtype)).all()
    assert (kp[-1] == torch.tensor(t_rl.WALK_P_GAINS, dtype=t_dtype)).all()
    assert (got.movement_mode[SWITCH_AT - 1] == 0).all()
    assert (got.movement_mode[-1] == 1).all()
    assert (got.root_pos[-1, :, 2] > 0.1).all()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_rl_and_replay_modules_import_no_jax():
    """In a fresh interpreter, the RL rollout, the RL loop's warm-up and
    step, a replay and a checkpoint load neither JAX nor the JAX package;
    without a card the RL entry points raise unless asked for the CPU."""
    code = (
        "import sys, tempfile, os, torch\n"
        "from go1_qp_mpc_controller_torch.envs import replay, rollout\n"
        "from go1_qp_mpc_controller_torch.models import policy, types\n"
        "from go1_qp_mpc_controller_torch.runtime import rl_loop\n"
        "from go1_qp_mpc_controller_torch.utils import checkpoint\n"
        "m = types.default_robot_model(device='cpu')\n"
        "a = policy.init_mlp(torch.Generator().manual_seed(0), device='cpu')\n"
        "c = rollout.init_rl_carry(m, 2, device='cpu')\n"
        "c, _ = rollout.rl_rollout(c, m, a, 2, 0.004)\n"
        "replay.replay_joint_signal(replay.sine_joint_signal(2, 0.002), m,"
        " 0.002)\n"
        "loop = rl_loop.RLControlLoop(m, a, hardware=False)\n"
        "loop.warmup()\n"
        "loop.close()\n"
        "path = os.path.join(tempfile.mkdtemp(), 'c')\n"
        "checkpoint.save_pytree(path, c)\n"
        "checkpoint.restore_pytree(path, c)\n"
        "if not torch.cuda.is_available():\n"
        "    for fn in (lambda: policy.init_mlp(torch.Generator()),\n"
        "               lambda: rollout.init_rl_carry(m, 2)):\n"
        "        try:\n"
        "            fn()\n"
        "            raise SystemExit('ran without a card')\n"
        "        except RuntimeError as exc:\n"
        "            assert 'no CUDA device' in str(exc)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k.startswith('go1_qp_mpc_controller_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"

"""PyTorch port, the replay harness, the signal logger and checkpoints
(``envs/replay.py``, ``utils/checkpoint.py``): the four non-slow cases of
tests/test_replay_checkpoint.py on the port, and two held against the JAX
package in float64 on the CPU.

- ``replay_rollout`` over a 30-tick standing sensor log (the JAX test's
  log with seeded per-frame noise, 10-iteration unpolished solves, the
  EKF in the loop): torques and GRFs within 1e-6 (N m, N) and the
  estimated root within 1e-9 m of the JAX ``replay_rollout`` (the
  rollout tests' tolerances), with the JAX test's criteria (zero
  warm-up torques, gravity-supporting torques at the end, all stance).
- ``replay_joint_signal`` over a 200-tick sine signal: the realized joints
  and root within 1e-9 of the JAX function's.
- Signal files written by one package read back by the other, to the
  format's 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch.ctrl import controller as t_ctrl
from go1_qp_mpc_controller_torch.envs import replay as t_replay
from go1_qp_mpc_controller_torch.envs import rollout as t_rollout
from go1_qp_mpc_controller_torch.models import types as t_types
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_torch.utils import checkpoint as t_checkpoint
from go1_qp_mpc_controller_tpu.ctrl import controller as j_ctrl
from go1_qp_mpc_controller_tpu.envs import replay as j_replay
from go1_qp_mpc_controller_tpu.envs import rollout as j_rollout
from go1_qp_mpc_controller_tpu.envs import srb_sim as j_sim
from go1_qp_mpc_controller_tpu.models import types as j_types
from go1_qp_mpc_controller_tpu.ops import admm as j_admm

torch.set_num_threads(1)
F64 = torch.float64
DT = 0.002
LOG_TICKS = 30
SETTINGS = dict(seg_iters=10, segments=1, polish=False)


def test_signal_log_roundtrip(tmp_path):
    log = t_replay.SignalLog()
    for i in range(5):
        log.append("q", np.full(12, float(i)))
        log.append("tau", torch.full((12,), 2.0 * i))
    path = os.path.join(tmp_path, "log.npz")
    log.save(path)
    loaded = t_replay.SignalLog.load(path)
    np.testing.assert_allclose(loaded.stacked("q")[3], 3.0)
    np.testing.assert_allclose(loaded.stacked("tau")[4], 8.0)
    # the JAX package reads the same file
    np.testing.assert_allclose(j_replay.SignalLog.load(path).stacked("q"),
                               loaded.stacked("q"))


def test_sine_joint_signal_shape():
    # 1000 steps x 2 ms = one full 0.5 Hz period
    sig = t_replay.sine_joint_signal(1000, 0.002)
    assert sig.shape == (1000, 12)
    np.testing.assert_allclose(sig[:, 1].mean(), 0.9, atol=0.01)
    assert sig[:, 1].max() <= 0.9 + 0.3 + 1e-9
    np.testing.assert_array_equal(sig, j_replay.sine_joint_signal(1000,
                                                                  0.002))
    legs = t_replay.motion_scheme(vel_magnitudes=(0.2, 0.4))
    want = j_replay.motion_scheme(vel_magnitudes=(0.2, 0.4))
    assert len(legs) == len(want) == 16
    for a, b in zip(legs, want):
        np.testing.assert_array_equal(a["cmd"], b["cmd"])


def test_checkpoint_roundtrip(tmp_path):
    model = t_types.default_robot_model(torch.float32, "cpu")
    state = t_types.init_ctrl_state(model, 2, torch.float32, "cpu")
    state = state._replace(root_pos=torch.tensor([[1.0, 2.0, 3.0],
                                                  [4.0, 5.0, 6.0]]))
    path = os.path.join(tmp_path, "ckpt")
    t_checkpoint.save_pytree(path, state)
    like = t_types.init_ctrl_state(model, 2, torch.float32, "cpu")
    restored = t_checkpoint.restore_pytree(path, like)
    assert type(restored) is type(state)
    for name in state._fields:
        a, b = getattr(state, name), getattr(restored, name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
            assert b.dtype == getattr(like, name).dtype
        else:
            assert all(torch.equal(x, y) for x, y in zip(a, b)), name
    with pytest.raises(FileExistsError):
        t_checkpoint.save_pytree(path, state, force=False)
    small = t_types.init_ctrl_state(model, 1, torch.float32, "cpu")
    with pytest.raises(ValueError, match="expected"):
        t_checkpoint.restore_pytree(path, small)


def test_recorded_signal_roundtrip_and_replay(tmp_path):
    """data_collection's recorded-log format (fixed-width 12 columns):
    written and read by both packages, then replayed onto the PD plant,
    which tracks the replayed signal."""
    q = t_replay.sine_joint_signal(120, 0.002, amplitude=0.1)
    path = tmp_path / "qSignal.txt"
    t_replay.save_recorded_signal(path, q)
    assert len(path.read_text().splitlines()[0].split()) == 12
    q2 = t_replay.load_recorded_signal(path)
    np.testing.assert_allclose(q2, q, atol=1e-6)
    np.testing.assert_array_equal(j_replay.load_recorded_signal(path), q2)
    jpath = tmp_path / "qSignal_jax.txt"
    j_replay.save_recorded_signal(jpath, q)
    assert jpath.read_text() == path.read_text()
    with pytest.raises(ValueError, match="columns"):
        bad = tmp_path / "bad.txt"
        np.savetxt(bad, np.zeros((4, 5)))
        t_replay.load_recorded_signal(bad)

    model = t_types.default_robot_model(torch.float32, "cpu")
    trace = t_replay.replay_joint_signal(q2, model, 0.002)
    realized = trace["joint_pos"][:, 0].numpy()
    assert realized.shape == (120, 12)
    assert np.isfinite(realized).all()
    corr = np.corrcoef(realized[:, 1], q[:, 1])[0, 1]
    assert corr > 0.5, corr


def test_replay_joint_signal_matches_jax():
    q = t_replay.sine_joint_signal(200, 0.002, amplitude=0.1)
    want = j_replay.replay_joint_signal(
        q, j_types.default_robot_model(jnp.float64), jnp.asarray(0.002),
        dtype=jnp.float64)
    got = t_replay.replay_joint_signal(
        np.stack([q, q + 0.01], axis=1),
        t_types.default_robot_model(F64, "cpu"), 0.002)
    assert got["joint_pos"].shape == (200, 2, 12)
    for name in ("joint_pos", "root_pos"):
        np.testing.assert_allclose(got[name][:, 0].numpy(),
                                   np.asarray(want[name]), rtol=0,
                                   atol=1e-9, err_msg=name)
    assert float((got["joint_pos"][:, 1] - got["joint_pos"][:, 0])
                 .abs().max()) > 1e-3


def _standing_log(model):
    """The JAX test's standing sensor stream with seeded noise on every
    frame's joints, gyro and foot forces, (T, ...) float64 numpy."""
    sim = j_sim.init_sim_state(model, 0.3, jnp.float64)
    weight = float(model.mass) * 9.8 / 4.0
    s = j_sim.read_sensors(sim, model, jnp.ones(4, bool),
                           jnp.full((4,), weight), jnp.asarray(DT))
    rng = np.random.default_rng(0)
    log = {name: np.repeat(np.asarray(getattr(s, name))[None], LOG_TICKS, 0)
           for name in j_ctrl.SensorData._fields}
    log["joint_pos"] = log["joint_pos"] + 1e-3 * rng.normal(
        size=(LOG_TICKS, 12))
    log["imu_ang_vel"] = log["imu_ang_vel"] + 1e-2 * rng.normal(
        size=(LOG_TICKS, 3))
    log["foot_force"] = log["foot_force"] * rng.uniform(0.9, 1.1,
                                                        (LOG_TICKS, 4))
    return log


def test_replay_rollout_matches_jax():
    jm = j_types.default_robot_model(jnp.float64)
    jp = j_types.default_ctrl_params(jnp.float64)
    log = _standing_log(jm)
    jc = j_rollout.init_carry(jm, jp, height=0.3, dtype=jnp.float64)
    _, want = jax.jit(lambda c: j_replay.replay_rollout(
        c, jm, jp, j_replay.sensor_log_from_arrays(**log), jnp.asarray(DT),
        settings=j_admm.ADMMSettings(**SETTINGS),
        use_terrain_adapt=False))(jc.ctrl)

    tm = t_types.default_robot_model(F64, "cpu")
    tp = t_types.default_ctrl_params(F64, "cpu")
    tc = t_rollout.init_carry(tm, tp, 1, dtype=F64, device="cpu")
    t_log = t_replay.sensor_log_from_arrays(
        dtype=F64, device="cpu", **{k: v[:, None] for k, v in log.items()})
    final, got = t_replay.replay_rollout(
        tc.ctrl, tm, tp, t_log, DT, solver_type=t_ctrl.MPC,
        settings=t_admm.ADMMSettings(**SETTINGS), use_terrain_adapt=False)
    tols = {"joint_torques": 1e-6, "foot_forces_grf": 1e-6,
            "root_pos_est": 1e-9, "contacts": 0}
    for name, tol in tols.items():
        g = got[name][:, 0].numpy().astype(np.float64)
        w = np.asarray(want[name]).astype(np.float64)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)
    tau = got["joint_torques"][:, 0]
    assert torch.isfinite(tau).all()
    assert not tau[0].any()
    assert float(tau[-1].abs().max()) > 0.5
    assert got["contacts"].all()
    assert int(final.mpc_init_counter[0]) == LOG_TICKS

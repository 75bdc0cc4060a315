"""PyTorch port, the RL host loop (``runtime/rl_loop.py``) against the JAX
package's.

- One loop step (estimation + RL step) against the JAX loop's jitted step
  on the same frames, with no threads: ``STEPS`` frames of a position-PD
  plant driven by the JAX commands, the A-button press at ``PRESS`` and
  a walk command from it, in float64 (the JAX step traces in the dtype of
  its inputs). The port's frames go through its bridge and ``run``; the
  estimate, the RL state and the pushed command are held within 1e-9 x
  max(1, max|JAX|) of the JAX step's (summation order only).
- A short threaded servo -> walk run on the CPU in the shape of
  tests/test_rl_loop.py (feeder at 2 ms, time scale 0.5): servo gains and
  a standing plant before the press, walk gains and targets inside the
  pose clip after it, a finite plant. It waits for ticks with deadlines,
  not fixed sleeps, and takes a few seconds of wall time.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from go1_qp_mpc_controller_torch.compat import convert
from go1_qp_mpc_controller_torch.ctrl import rl as t_rl
from go1_qp_mpc_controller_torch.models import policy as t_policy
from go1_qp_mpc_controller_torch.models import types as t_types
from go1_qp_mpc_controller_torch.runtime import feeder as t_feeder
from go1_qp_mpc_controller_torch.runtime import rl_loop as t_rl_loop
from go1_qp_mpc_controller_tpu.ctrl import rl as j_rl
from go1_qp_mpc_controller_tpu.envs import srb_sim as j_sim
from go1_qp_mpc_controller_tpu.models import kinematics as j_kin
from go1_qp_mpc_controller_tpu.models import policy as j_policy
from go1_qp_mpc_controller_tpu.models import types as j_types
from go1_qp_mpc_controller_tpu.ops import ekf as j_ekf
from go1_qp_mpc_controller_tpu.runtime import rl_loop as j_rl_loop
from go1_qp_mpc_controller_tpu.utils import rotations as j_rot

torch.set_num_threads(1)
PERIOD = 0.004
STEPS = 30
PRESS = 10
TOL = 1e-9


def _close(got, want, what=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


def test_loop_step_matches_jax():
    jm = j_types.default_robot_model(jnp.float64)
    params = j_policy.init_mlp(jax.random.PRNGKey(1), dtype=jnp.float64)
    j_loop = j_rl_loop.RLControlLoop(jm, params, action_period_s=PERIOD,
                                     hardware=False)
    tm = t_types.default_robot_model(torch.float64, "cpu")
    actor = convert.actor_from_numpy(jax.tree.map(np.asarray, params), "cpu",
                                     torch.float64)
    t_loop = t_rl_loop.RLControlLoop(tm, actor, action_period_s=PERIOD,
                                     hardware=False)
    try:
        t_loop.warmup()
        sim = j_sim.init_sim_state(jm, 0.3, jnp.float64)
        contacts = jnp.ones(4, bool)
        stand = sim.foot_pos_world - sim.root_pos
        forces = jnp.full((4,), float(jm.mass) * 9.8 / 4.0)
        dt = jnp.asarray(PERIOD)
        est, rl_state = None, j_rl.init_rl_state(dtype=jnp.float64)
        for k in range(STEPS):
            s = j_sim.read_sensors(sim, jm, contacts, forces, dt)
            frame = {"quat": s.quat_wxyz, "acc": s.imu_acc,
                     "gyro": s.imu_ang_vel, "joint_pos": s.joint_pos,
                     "joint_vel": s.joint_vel, "foot_force": s.foot_force}
            frame = {key: np.asarray(v, np.float64)
                     for key, v in frame.items()}
            command = np.array([0.3, 0.0, 0.0]) if k >= PRESS else np.zeros(3)
            if est is None:     # the JAX loop's first-frame init
                est = j_ekf.init_state(
                    j_rot.quat_to_rot_mat(s.quat_wxyz),
                    j_kin.fk(s.joint_pos.reshape(4, 3), jm.leg_geometry.rho_opt,
                             jm.leg_geometry.rho_fix))
            x, p, rl_state, cmd, _ = j_loop._step(
                est[0], est[1], rl_state,
                tuple(jnp.asarray(frame[key]) for key in
                      ("quat", "acc", "gyro", "joint_pos", "joint_vel",
                       "foot_force")),
                jnp.asarray(command), jnp.asarray(k == PRESS), dt)
            est = (x, p)

            t_loop.bridge.push_sensors(*[frame[key] for key in
                                         ("quat", "acc", "gyro", "joint_pos",
                                          "joint_vel", "foot_force")])
            t_loop.command = command
            t_loop.toggle = k == PRESS
            assert t_loop.run(num_ticks=k + 1) == k + 1
            _close(t_loop._est[0][0], x, f"x {k}")
            _close(t_loop._est[1][0], p, f"P {k}")
            for name in t_loop.rl_state._fields:
                _close(getattr(t_loop.rl_state, name)[0],
                       getattr(rl_state, name), f"{name} {k}")
            _, pushed = t_loop.bridge.read_command()
            for name in ("tau", "q", "kp", "kd"):
                _close(pushed[name], getattr(cmd, name), f"{name} {k}")
            # the plant moves under the JAX command
            sim, forces = j_sim.step_pd(sim, jm, cmd.q, cmd.kp, cmd.kd,
                                        cmd.tau, contacts, stand, dt)
        assert int(rl_state.movement_mode) == 1
        assert int(t_loop.rl_state.movement_mode[0]) == 1
    finally:
        t_loop.close()
        j_loop.close()


def _wait(cond, timeout):
    t_end = time.time() + timeout
    while not cond() and time.time() < t_end:
        time.sleep(0.02)
    return cond()


def test_rl_loop_servo_then_walk():
    model = t_types.default_robot_model(torch.float32, "cpu")
    params = t_types.default_ctrl_params(torch.float32, "cpu")
    actor = t_policy.init_mlp(torch.Generator().manual_seed(0),
                              device="cpu")
    loop = t_rl_loop.RLControlLoop(model, actor, action_period_s=PERIOD,
                                   hardware=True, time_scale=0.5)
    feeder = None
    try:
        loop.warmup()
        feeder = t_feeder.SimFeeder(loop.bridge, model, params, height=0.3,
                                    period_s=0.002, time_scale=0.5,
                                    device="cpu")
        feeder.start(duration_s=30.0)
        loop.start(duration_s=30.0)
        # servo phase: crouch interpolation with servo gains
        assert _wait(lambda: loop.ticks >= 20, 5.0), loop.ticks
        assert int(loop.rl_state.movement_mode[0]) == 0
        _, cmd = loop.bridge.read_command()
        np.testing.assert_array_equal(cmd["kp"], t_rl.SERVO_P_GAINS)
        root = feeder.sim_root_pos
        assert np.all(np.isfinite(root)) and 0.15 < root[2] < 0.35
        # A-button: switch to the walk policy
        pressed_at = loop.ticks
        loop.toggle = True
        assert _wait(lambda: int(loop.rl_state.movement_mode[0]) == 1
                     and loop.ticks >= pressed_at + 10, 5.0)
        _, cmd = loop.bridge.read_command()
        np.testing.assert_array_equal(cmd["kp"], t_rl.WALK_P_GAINS)
        assert np.all(cmd["q"] >= np.asarray(t_rl.CLIP_POSE_LOWER) - 1e-6)
        assert np.all(cmd["q"] <= np.asarray(t_rl.CLIP_POSE_UPPER) + 1e-6)
        loop.stop()
        feeder.stop()
        assert not loop._thread.is_alive() and not feeder._thread.is_alive()
        assert loop.error is None and feeder.error is None
        assert np.all(np.isfinite(feeder.sim_root_pos))
    finally:
        if feeder is not None:
            feeder.stop()
        loop.close()

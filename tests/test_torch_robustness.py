"""PyTorch port, fault injection: the five cases of tests/test_robustness.py
held against the port, in float64 on the CPU, with the JAX tests' own
criteria and the JAX package's outputs on the same inputs.

Tolerances: torques and GRFs within 1e-6 (N m, N) of the JAX package's,
positions within 1e-9 m (tests/test_torch_rollout.py's); the dense solve's
x within 1e-6. Inside the port the JAX test's own tolerances hold (its
two programs within 1e-8, the cold comparator within 1e-10).

The NaN sensor spike runs shortened here (``SPIKE_TICKS`` standing ticks,
the corrupted tick, ``SPIKE_TICKS`` clean ticks); ``chip_smoke.py`` runs
the JAX test's full 100 + 1 + 400 ticks on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from go1_qp_mpc_controller_torch.compat import convert
from go1_qp_mpc_controller_torch.ctrl import controller as t_ctrl
from go1_qp_mpc_controller_torch.ctrl import torque as t_torque
from go1_qp_mpc_controller_torch.envs import rollout as t_rollout
from go1_qp_mpc_controller_torch.envs import srb_sim as t_sim
from go1_qp_mpc_controller_torch.models import srb as t_srb
from go1_qp_mpc_controller_torch.models import types as t_types
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_tpu.compat import oracle
from go1_qp_mpc_controller_tpu.ctrl import controller as j_ctrl
from go1_qp_mpc_controller_tpu.ctrl import torque as j_torque
from go1_qp_mpc_controller_tpu.envs import rollout as j_rollout
from go1_qp_mpc_controller_tpu.envs import srb_sim as j_sim
from go1_qp_mpc_controller_tpu.models import srb as j_srb
from go1_qp_mpc_controller_tpu.models import types as j_types
from go1_qp_mpc_controller_tpu.ops import admm as j_admm

torch.set_num_threads(1)
F64 = torch.float64
DT = 0.002
SETTINGS = dict(seg_iters=25, segments=3)
SPIKE_TICKS = 40
FORCE_TOL = 1e-6
POS_TOL = 1e-9


def _jax_model():
    return (j_types.default_robot_model(jnp.float64),
            j_types.default_ctrl_params(jnp.float64))


def _port_model():
    return (t_types.default_robot_model(F64, "cpu"),
            t_types.default_ctrl_params(F64, "cpu"))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol, err_msg=what)


def test_nan_grf_keeps_previous_torques():
    """A NaN solver output never reaches the motors
    (A1RobotControl.cpp:314-317): the latch keeps each NaN entry's
    previous torque, the JAX function's output entry for entry, here with
    every GRF NaN and with one leg's."""
    jm, jp = _jax_model()
    tm, tp = _port_model()
    for nan_legs in ([0, 1, 2, 3], [2]):
        grf = np.full((4, 3), 20.0)
        grf[nan_legs] = np.nan
        j_state = j_types.init_ctrl_state(jm, jnp.float64)._replace(
            mpc_init_counter=jnp.asarray(100, jnp.int32),
            contacts=jnp.ones(4, bool),
            joint_torques=jnp.full((12,), 3.0),
            j_foot=jnp.tile(jnp.eye(3), (4, 1, 1)),
            foot_forces_grf=jnp.asarray(grf))
        want = j_torque.compute_joint_torques(j_state, jp).joint_torques
        t_state = convert.from_numpy(
            t_types.CtrlState,
            jax.tree.map(lambda a: np.asarray(a)[None], j_state), "cpu",
            F64)
        got = t_torque.compute_joint_torques(t_state, tp).joint_torques
        _close(got[0], want, 1e-12, str(nan_legs))
        rows = np.repeat(np.isin(np.arange(4), nan_legs), 3)
        _close(got[0, rows], np.full(rows.sum(), 3.0), 0.0)


def _jax_rollout(steps):
    jm, jp = _jax_model()
    return jax.jit(lambda c: j_rollout.rollout(
        c, jm, jp, steps, jnp.asarray(DT), solver_type=j_ctrl.MPC,
        settings=j_admm.ADMMSettings(**SETTINGS), estimate=False,
        use_terrain_adapt=False))


def _port_rollout(carry, steps):
    tm, tp = _port_model()
    return t_rollout.rollout(carry, tm, tp, steps, DT,
                             solver_type=t_ctrl.MPC,
                             settings=t_admm.ADMMSettings(**SETTINGS),
                             estimate=False, use_terrain_adapt=False)


def test_ten_tick_zero_torque_warmup():
    """The first 10 controller ticks command zero torque
    (A1RobotControl.cpp:292-295): 12 ticks of both rollouts, the torques
    tick by tick."""
    jm, jp = _jax_model()
    tm, tp = _port_model()
    _, want = _jax_rollout(12)(j_rollout.init_carry(jm, jp, height=0.3,
                                                    dtype=jnp.float64))
    _, got = _port_rollout(t_rollout.init_carry(tm, tp, 1, dtype=F64,
                                                device="cpu"), 12)
    tau = got.joint_torques[:, 0]
    _close(tau, want.joint_torques, FORCE_TOL)
    assert not tau[:8].any()
    assert float(tau[-1].abs().max()) > 0.1


def test_nan_sensor_spike_recovers():
    """One tick of NaN foot forces does not destabilize standing: the
    torques stay finite and the robot stands on, tick for tick as the JAX
    package's (shortened; see the module docstring)."""
    jm, jp = _jax_model()
    tm, tp = _port_model()
    run = _jax_rollout(SPIKE_TICKS)
    jc, _ = run(j_rollout.init_carry(jm, jp, height=0.3, dtype=jnp.float64))
    tc, _ = _port_rollout(t_rollout.init_carry(tm, tp, 1, dtype=F64,
                                               device="cpu"), SPIKE_TICKS)

    def spike(c, sim_mod, ctrl_mod, model, params, settings):
        bad = c._replace(stance_forces_z=c.stance_forces_z * np.nan)
        sensors = sim_mod.read_sensors(bad.sim, model, bad.ctrl.contacts,
                                       bad.stance_forces_z, DT)
        assert np.isnan(np.asarray(sensors.foot_force)).any()
        ctrl = ctrl_mod.sensor_update(bad.ctrl, model, sensors, DT,
                                      estimate=False)
        ctrl = ctrl._replace(root_pos=bad.sim.root_pos,
                             root_lin_vel=bad.sim.root_lin_vel)
        ctrl = ctrl_mod.control_step(ctrl, model, params, DT,
                                     solver_type=ctrl_mod.MPC,
                                     settings=settings,
                                     use_terrain_adapt=False)
        return ctrl, bad.sim

    j_ctrl2, j_sim2 = spike(jc, j_sim, j_ctrl, jm, jp,
                            j_admm.ADMMSettings(**SETTINGS))
    t_ctrl2, t_sim2 = spike(tc, t_sim, t_ctrl, tm, tp,
                            t_admm.ADMMSettings(**SETTINGS))
    assert torch.isfinite(t_ctrl2.joint_torques).all()
    _close(t_ctrl2.joint_torques[0], j_ctrl2.joint_torques, FORCE_TOL)
    _, want = run(j_rollout.RolloutCarry(
        ctrl=j_ctrl2, sim=j_sim2, stance_forces_z=jnp.full((4,), 36.75)))
    _, got = _port_rollout(t_rollout.RolloutCarry(
        ctrl=t_ctrl2, sim=t_sim2,
        stance_forces_z=torch.full((1, 4), 36.75, dtype=F64)), SPIKE_TICKS)
    _close(got.joint_torques[:, 0], want.joint_torques, FORCE_TOL)
    _close(got.root_pos[:, 0], want.root_pos, POS_TOL)
    z = got.root_pos[:, 0, 2]
    assert torch.isfinite(z).all()
    assert abs(float(z[-1]) - 0.3) < 0.05


def test_solver_divergence_latch_in_batch():
    """A poisoned QP in a batch (the oracle fixture with a NaN gradient)
    comes back flagged (primal_res >= 1e6) and finite from the dense
    solve, its neighbours untouched (``ops/admm.py::_finite_latch``); the
    clean solve is the JAX package's."""
    f = oracle.test_mpc_fixture()
    scales = np.array([1.0, np.nan, 1.0])
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=F64)
    rep = lambda a: t(a).expand((3,) + np.shape(a)).clone()
    qps = t_srb.condense(rep(f["a_d"]), rep(f["b_d_list"]), rep(f["x0"]),
                         rep(f["x_ref"].reshape(10, 13)),
                         rep(f["q_weights"]), rep(f["r_weights"]),
                         rep(f["contacts"]))
    qps = qps._replace(gradient=qps.gradient * t(scales)[:, None])
    sols = t_admm.mpc_solve(qps, t_admm.ADMMSettings(**SETTINGS))
    pr = sols.primal_res.numpy()
    assert pr[1] >= 1e6
    assert torch.isfinite(sols.x).all()
    assert pr[0] < 1e-3 and pr[2] < 1e-3
    assert torch.equal(sols.x[0], sols.x[2])
    j = lambda a: jnp.asarray(a, jnp.float64)
    want = j_admm.mpc_solve(j_srb.condense(
        j(f["a_d"]), j(f["b_d_list"]), j(f["x0"]),
        j(f["x_ref"]).reshape(10, 13), j(f["q_weights"]),
        j(f["r_weights"]), j(f["contacts"])), j_admm.ADMMSettings(**SETTINGS))
    _close(sols.x[0], want.x, 1e-6)


def test_health_gate_recovers_garbage_carry():
    """tests/test_robustness.py's health gate on the port: a finite
    garbage primal/dual carry on scenario 0 of an aged batch of 4 is
    caught by the residual health gate (``controller._unhealthy``) and
    re-solved cold by both the batched program and the per-scenario
    "auto" program, which agree; the healthy scenarios stay on the warm
    program. The batched program's GRFs are the JAX package's at every
    tick, the garbage tick included."""
    jm, jp = _jax_model()
    tm, tp = _port_model()
    batch = 4
    settings = t_admm.ADMMSettings(**SETTINGS)
    j_settings = j_admm.ADMMSettings(**SETTINGS)

    def j_step(cc):
        def observe(cs, sm, fz):
            sensors = j_sim.read_sensors(sm, jm, cs.contacts, fz,
                                         jnp.asarray(DT))
            return j_ctrl.sensor_update(cs, jm, sensors, jnp.asarray(DT))
        ctrl = jax.vmap(observe)(cc.ctrl, cc.sim, cc.stance_forces_z)
        ctrl = j_ctrl.control_step_batched(ctrl, jm, jp, jnp.asarray(DT),
                                           settings=j_settings,
                                           use_terrain_adapt=False)
        sim, fz = jax.vmap(lambda sm, tau, con, tgt: j_sim.step(
            sm, jm, tau, con, tgt, jnp.asarray(DT)))(
            cc.sim, ctrl.joint_torques, ctrl.contacts,
            ctrl.foot_pos_target_last_time)
        return j_rollout.RolloutCarry(ctrl=ctrl, sim=sim, stance_forces_z=fz)

    j_tick = jax.jit(j_step)

    def t_tick(cc, step_fn):
        sensors = t_sim.read_sensors(cc.sim, tm, cc.ctrl.contacts,
                                     cc.stance_forces_z, DT)
        ctrl = step_fn(t_ctrl.sensor_update(cc.ctrl, tm, sensors, DT))
        sim, fz = t_sim.step(cc.sim, tm, ctrl.joint_torques, ctrl.contacts,
                             ctrl.foot_pos_target_last_time, DT)
        return t_rollout.RolloutCarry(ctrl=ctrl, sim=sim, stance_forces_z=fz)

    batched = lambda cs: t_ctrl.control_step_batched(
        cs, tm, tp, DT, settings=settings, use_terrain_adapt=False)
    per = lambda mode: lambda cs: t_ctrl.control_step(
        cs, tm, tp, DT, settings=settings, use_terrain_adapt=False,
        warm_mode=mode)

    jc = j_rollout.init_carry(jm, jp, height=0.3, dtype=jnp.float64)
    jc = jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape), jc)
    tc = t_rollout.init_carry(tm, tp, batch, dtype=F64, device="cpu")
    for k in range(13):
        if k == 3:
            # age the carry past the young-tick guard (the JAX test's
            # reason: else every scenario routes cold before the gate)
            jc = jc._replace(ctrl=jc.ctrl._replace(
                mpc_init_counter=jnp.full((batch,), 100, jnp.int32)))
            tc = tc._replace(ctrl=tc.ctrl._replace(
                mpc_init_counter=torch.full((batch,), 100,
                                            dtype=torch.int32)))
        jc, tc = j_tick(jc), t_tick(tc, batched)
        _close(tc.ctrl.foot_forces_grf, jc.ctrl.foot_forces_grf, FORCE_TOL,
               f"tick {k}")

    # precondition: with no injection the routed batched tick is the pure
    # warm program
    _close(t_tick(tc, batched).ctrl.foot_forces_grf,
           t_tick(tc, per("warm")).ctrl.foot_forces_grf.numpy(), 1e-10)

    def garbage(ctrl, x, y, lib):
        if lib is torch:
            wx, wy = ctrl.qp_warm_x.clone(), ctrl.qp_warm_y.clone()
            wx[0], wy[0] = x, y
        else:
            wx = ctrl.qp_warm_x.at[0].set(x)
            wy = ctrl.qp_warm_y.at[0].set(y)
        return ctrl._replace(qp_warm_x=wx, qp_warm_y=wy)

    tg = tc._replace(ctrl=garbage(tc.ctrl, 500.0, -300.0, torch))
    jg = jc._replace(ctrl=garbage(jc.ctrl, 500.0, -300.0, jnp))
    out_b = t_tick(tg, batched)
    out_a = t_tick(tg, per("auto"))
    out_w = t_tick(tg, per("warm"))
    out_c = t_tick(tc._replace(ctrl=garbage(tc.ctrl, 0.0, 0.0, torch)),
                   per("cold"))
    grf = out_b.ctrl.foot_forces_grf
    _close(grf, j_tick(jg).ctrl.foot_forces_grf, FORCE_TOL, "garbage tick")
    _close(grf, out_a.ctrl.foot_forces_grf.numpy(), 1e-8)
    _close(grf[0], out_c.ctrl.foot_forces_grf[0].numpy(), 1e-10)
    garbage_warm = out_w.ctrl.foot_forces_grf
    assert float((grf[0] - garbage_warm[0]).abs().max()) > 1e-4
    _close(grf[1:], garbage_warm[1:].numpy(), 1e-10)
    assert torch.isfinite(grf).all()
    weight = 15.0 * 9.8
    for i in range(batch):
        assert 0.5 * weight < float(grf[i, :, 2].sum()) < 1.3 * weight

"""PyTorch port, the per-scenario controller tick: ``control_step`` with
``compute_grf_mpc`` (each scenario routed warm / window / cold, then the
health-rejected cold re-solve) and ``compute_grf_qp``, held against the
JAX package's ``control_step`` under vmap (whose ``lax.switch`` computes
every branch and selects per scenario).

One full tick (sensors, EKF, plan, swing, GRF solve, torques, plant step)
from the same float64 state, with the polished cold settings of
``main.py rollout`` and tests/test_walking.py, must equal the JAX tick to
round-off (1e-8 x scale). The batch mixes the routes: a contact flip
(cold), a post-flip window, a negated carried inverse (warm, then the
health re-solve) and steady warm scenarios.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch.compat import convert
from go1_qp_mpc_controller_torch.ctrl import controller as t_ctrl
from go1_qp_mpc_controller_torch.envs import rollout as t_rollout
from go1_qp_mpc_controller_torch.envs import srb_sim as t_sim
from go1_qp_mpc_controller_torch.models import types as t_types
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_tpu.ctrl import controller as j_ctrl
from go1_qp_mpc_controller_tpu.envs import rollout as j_rollout
from go1_qp_mpc_controller_tpu.envs import srb_sim as j_sim
from go1_qp_mpc_controller_tpu.models import types as j_types
from go1_qp_mpc_controller_tpu.ops import admm as j_admm

torch.set_num_threads(1)
F64 = torch.float64
DT = 0.002
BATCH = 5
SETTINGS = dict(seg_iters=25, segments=3)


def _jax_tick(solver_type=j_ctrl.MPC, warm_mode="auto",
              warm_settings=j_ctrl.WARM_SETTINGS):
    model = j_types.default_robot_model(jnp.float64)
    params = j_types.default_ctrl_params(jnp.float64)
    dt = jnp.asarray(DT, jnp.float64)
    settings = j_admm.ADMMSettings(**SETTINGS)

    def one(c):
        sensors = j_sim.read_sensors(c.sim, model, c.ctrl.contacts,
                                     c.stance_forces_z, dt)
        ctrl = j_ctrl.sensor_update(c.ctrl, model, sensors, dt)
        ctrl = j_ctrl.control_step(ctrl, model, params, dt,
                                   solver_type=solver_type,
                                   settings=settings,
                                   warm_settings=warm_settings,
                                   warm_mode=warm_mode)
        sim, fz = j_sim.step(c.sim, model, ctrl.joint_torques, ctrl.contacts,
                             ctrl.foot_pos_target_last_time, dt)
        return j_rollout.RolloutCarry(ctrl=ctrl, sim=sim, stance_forces_z=fz)

    return jax.jit(jax.vmap(one))


def _to_port(jc):
    nd = jax.tree.map(np.asarray, jc)
    return t_rollout.RolloutCarry(
        ctrl=convert.from_numpy(t_types.CtrlState, nd.ctrl._asdict(), "cpu",
                                F64),
        sim=convert.from_numpy(t_sim.SimState, nd.sim._asdict(), "cpu", F64),
        stance_forces_z=torch.tensor(nd.stance_forces_z))


@pytest.fixture(scope="module")
def mixed():
    """A standing batch past the young-carry window, then edited so that
    the next tick routes scenario 0 cold (contact flip), 1 warm with a
    negated carried inverse (health re-solve), 2 through the post-flip
    window, 3 and 4 warm."""
    model = j_types.default_robot_model(jnp.float64)
    params = j_types.default_ctrl_params(jnp.float64)
    c = j_rollout.init_carry(model, params, height=0.3, dtype=jnp.float64)
    c = jax.tree.map(lambda a: jnp.broadcast_to(a, (BATCH,) + a.shape), c)
    rng = np.random.default_rng(0)
    c = c._replace(sim=c.sim._replace(
        root_pos=c.sim.root_pos.at[:, 2].add(0.005 * rng.normal(size=BATCH)),
        root_lin_vel=c.sim.root_lin_vel + 0.01 * rng.normal(
            size=(BATCH, 3))))
    tick = _jax_tick()
    for _ in range(50):
        c = tick(c)
    ctrl = c.ctrl
    warm_c = ctrl.qp_warm_contacts
    ctrl = ctrl._replace(
        qp_warm_contacts=warm_c.at[0].set(~warm_c[0]).at[2].set(
            jnp.asarray([True, False, False, True])),
        qp_warm_minv=ctrl.qp_warm_minv.at[1].set(-ctrl.qp_warm_minv[1]),
        movement_mode=ctrl.movement_mode.at[2].set(1),
        gait_counter=ctrl.gait_counter.at[2].set(
            jnp.asarray([10.0, 130.0, 130.0, 10.0])))
    return c._replace(ctrl=ctrl)


def _assert_tick_equal(got, want):
    for name in ("foot_forces_grf", "joint_torques", "qp_warm_x",
                 "qp_warm_y", "qp_warm_rho", "qp_warm_minv",
                 "qp_warm_contacts", "qp_warm_grad", "estimator_x"):
        w = np.asarray(getattr(want.ctrl, name)).astype(np.float64)
        g = getattr(got.ctrl, name).numpy().astype(np.float64)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-8 * max(1.0, np.abs(w).max()),
                                   err_msg=name)
    np.testing.assert_allclose(got.sim.root_pos.numpy(),
                               np.asarray(want.sim.root_pos), atol=1e-12)


def _port_tick(c, **kw):
    model = t_types.default_robot_model(F64, "cpu")
    params = t_types.default_ctrl_params(F64, "cpu")
    stats = {}
    got, _ = t_rollout.rollout(_to_port(c), model, params, 1, DT,
                               settings=t_admm.ADMMSettings(**SETTINGS),
                               stats=stats, **kw)
    return got, stats


def test_routed_per_scenario_tick_matches_jax(mixed):
    want = _jax_tick()(mixed)
    got, stats = _port_tick(mixed)
    health = stats.pop("health", 0)
    assert stats == {"warm": 3, "window": 1, "cold": 1}
    assert health >= 1          # at least the negated inverse
    _assert_tick_equal(got, want)


@pytest.mark.parametrize("mode", ["warm", "cold", "legacy", "qp"])
def test_other_modes_match_jax(mixed, mode):
    """warm_mode "warm" / "cold", ``warm_settings=None`` (cold every tick,
    warm-started with primal / dual only) and the balance-QP stance
    controller."""
    if mode == "legacy":
        j_kw, t_kw = dict(warm_settings=None), dict(warm_settings=None)
    elif mode == "qp":
        j_kw = dict(solver_type=j_ctrl.QP)
        t_kw = dict(solver_type=t_ctrl.QP)
    else:
        j_kw = t_kw = dict(warm_mode=mode)
    want = _jax_tick(**j_kw)(mixed)
    got, stats = _port_tick(mixed, **t_kw)
    if mode != "qp":
        assert stats == {"cold" if mode == "legacy" else mode: BATCH}
    _assert_tick_equal(got, want)


def test_unported_variants_raise(mixed):
    """The variants that raised before the long-horizon port now run
    (their parity is in tests/test_torch_long_horizon.py); what still
    raises is a horizon the carry was not sized for and an unknown
    warm_mode."""
    model = t_types.default_robot_model(F64, "cpu")
    params = t_types.default_ctrl_params(F64, "cpu")
    ctrl = _to_port(mixed).ctrl
    out = t_ctrl.compute_grf_mpc(ctrl, model, params, receding_horizon=True)
    assert torch.isfinite(out.foot_forces_grf).all()
    with pytest.raises(RuntimeError):
        _port_tick(mixed, horizon=40)       # a horizon-10 carry
    with pytest.raises(ValueError, match="warm_mode"):
        t_ctrl.compute_grf_mpc(ctrl, model, params, warm_mode="bogus")

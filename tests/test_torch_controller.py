"""PyTorch port, the batched controller tick and its GRF routing, held
against the JAX package's ``control_step_batched``.

Handmade batches hit each route of ``compute_grf_mpc_batched``: all warm,
a compact tick with 1 and with k flagged scenarios, an a-priori overflow
and an a-posteriori health reject, each with ``compact_k`` in {0, 2} (0
routes every mixed tick whole-batch cold). One full tick (sensors, K2,
plan, swing, routed GRF solve through K1, torques, plant step) from the
same float64 state must equal the JAX tick to round-off (1e-8 x scale),
in the style of tests/test_batched_transition.py.
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
from go1_qp_mpc_controller_torch.ops import admm_iterations, kkt_schulz
from go1_qp_mpc_controller_torch.ops import observe_ekf, schulz_batch
from go1_qp_mpc_controller_tpu.ctrl import controller as j_ctrl
from go1_qp_mpc_controller_tpu.envs import rollout as j_rollout
from go1_qp_mpc_controller_tpu.envs import srb_sim as j_sim
from go1_qp_mpc_controller_tpu.models import types as j_types
from go1_qp_mpc_controller_tpu.ops import admm as j_admm

torch.set_num_threads(1)
F64 = torch.float64
DT = 0.002
BATCH = 4
# the JAX bench's cold transition settings, polish off
COLD = dict(seg_iters=30, segments=2, first_seg_iters=20, polish=False,
            schulz_l0=1e-6, schulz_l0_first=1e-3, schulz_l0_refine=1e-4,
            schulz_hi_tail=1)
J_SETTINGS = j_admm.ADMMSettings(schulz_impl="auto", **COLD)
T_SETTINGS = t_admm.ADMMSettings(schulz_impl="auto", **COLD)


def _jax_tick_fn(compact_k, settings=J_SETTINGS):
    model = j_types.default_robot_model(jnp.float64)
    params = j_types.default_ctrl_params(jnp.float64)
    dt = jnp.asarray(DT, jnp.float64)

    def tick(c):
        def observe(cs, sm, fz):
            sensors = j_sim.read_sensors(sm, model, cs.contacts, fz, dt)
            return j_ctrl.sensor_update(cs, model, sensors, dt)

        ctrl = jax.vmap(observe)(c.ctrl, c.sim, c.stance_forces_z)
        ctrl = j_ctrl.control_step_batched(ctrl, model, params, dt,
                                           settings=settings,
                                           compact_k=compact_k)
        sim, fz = jax.vmap(lambda sm, tau, con, tgt: j_sim.step(
            sm, model, tau, con, tgt, dt))(
            c.sim, ctrl.joint_torques, ctrl.contacts,
            ctrl.foot_pos_target_last_time)
        return j_rollout.RolloutCarry(ctrl=ctrl, sim=sim, stance_forces_z=fz)

    return jax.jit(tick)


def _to_port(jc):
    nd = jax.tree.map(np.asarray, jc)
    return t_rollout.RolloutCarry(
        ctrl=convert.from_numpy(t_types.CtrlState, nd.ctrl._asdict(), "cpu",
                                F64),
        sim=convert.from_numpy(t_sim.SimState, nd.sim._asdict(), "cpu", F64),
        stance_forces_z=torch.tensor(nd.stance_forces_z))


@pytest.fixture(scope="module")
def setup():
    """A standing batch past the young-carry window (steady warm cadence)
    and the jitted JAX ticks."""
    model = j_types.default_robot_model(jnp.float64)
    params = j_types.default_ctrl_params(jnp.float64)
    c = j_rollout.init_carry(model, params, height=0.3, dtype=jnp.float64)
    c = jax.tree.map(lambda a: jnp.broadcast_to(a, (BATCH,) + a.shape), c)
    rng = np.random.default_rng(0)
    c = c._replace(sim=c.sim._replace(
        root_pos=c.sim.root_pos.at[:, 2].add(
            0.005 * rng.normal(size=BATCH)),
        root_lin_vel=c.sim.root_lin_vel + 0.01 * rng.normal(size=(BATCH,
                                                                  3))))
    ticks = {k: _jax_tick_fn(k) for k in (0, 2)}
    for _ in range(60):
        c = ticks[2](c)
    return c, ticks


def _flip(c, scenarios):
    qc = c.ctrl.qp_warm_contacts
    for s in scenarios:
        qc = qc.at[s].set(~qc[s])
    return c._replace(ctrl=c.ctrl._replace(qp_warm_contacts=qc))


def _reject(c):
    """Scenario 1's carried inverse negated: its warm solve fails the
    basin test and produces garbage residuals (a health reject)."""
    minv = c.ctrl.qp_warm_minv
    return c._replace(ctrl=c.ctrl._replace(
        qp_warm_minv=minv.at[1].set(-minv[1])))


CASES = {
    # case: (carry edit, expected route for compact_k = 2, for 0)
    "all_warm": (lambda c: c, "warm", "warm"),
    "compact_1_flag": (lambda c: _flip(c, [0]), "compact", "cold"),
    "compact_k_flags": (lambda c: _flip(c, [0, 2]), "compact", "cold"),
    "overflow": (lambda c: _flip(c, [0, 1, 3]), "cold", "cold"),
    "health_reject": (_reject, "compact", "cold"),
}


@pytest.mark.parametrize("compact_k", [2, 0])
@pytest.mark.parametrize("case", list(CASES))
def test_routed_tick_matches_jax(setup, case, compact_k):
    c0, ticks = setup
    edit, route_k2, route_k0 = CASES[case]
    c = edit(c0)
    want = ticks[compact_k](c)
    model = t_types.default_robot_model(F64, "cpu")
    params = t_types.default_ctrl_params(F64, "cpu")
    stats = {}
    got, _ = t_rollout.rollout_batched(_to_port(c), model, params, 1, DT,
                                       settings=T_SETTINGS,
                                       compact_k=compact_k, stats=stats)
    assert stats == {route_k2 if compact_k else route_k0: 1}
    for name in ("foot_forces_grf", "joint_torques", "qp_warm_x",
                 "qp_warm_y", "qp_warm_rho", "qp_warm_minv",
                 "qp_warm_contacts", "estimator_x", "estimator_P"):
        w = np.asarray(getattr(want.ctrl, name)).astype(np.float64)
        g = getattr(got.ctrl, name).numpy().astype(np.float64)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-8 * max(1.0, np.abs(w).max()),
                                   err_msg=name)
    np.testing.assert_allclose(got.sim.root_pos.numpy(),
                               np.asarray(want.sim.root_pos), atol=1e-12)


def test_cpu_tick_launches_no_kernel(setup):
    """On the CPU every wrapper takes its plain version: a tick leaves all
    launch counters at 0."""
    c0, _ = setup
    counters = (kkt_schulz, observe_ekf, schulz_batch, admm_iterations)
    for module in counters:
        module.reset_launches()
    model = t_types.default_robot_model(F64, "cpu")
    params = t_types.default_ctrl_params(F64, "cpu")
    t_rollout.rollout_batched(_to_port(_flip(c0, [0])), model, params, 1,
                              DT, settings=t_admm.ADMMSettings())
    assert all(module.launches == 0 for module in counters)


def test_polished_cold_tick_matches_jax(setup):
    """With the default ``ADMMSettings()`` (polished) the cold branch takes
    the dense polished solve (K3 on the card). A tick whose flagged
    scenario is solved cold under it, on the compacted sub-batch, equals
    the JAX tick to round-off."""
    c0, _ = setup
    c = _flip(c0, [0])
    want = _jax_tick_fn(2, j_admm.ADMMSettings())(c)
    model = t_types.default_robot_model(F64, "cpu")
    params = t_types.default_ctrl_params(F64, "cpu")
    stats = {}
    got, _ = t_rollout.rollout_batched(_to_port(c), model, params, 1, DT,
                                       settings=t_admm.ADMMSettings(),
                                       compact_k=2, stats=stats)
    assert stats == {"compact": 1}
    for name in ("foot_forces_grf", "joint_torques", "qp_warm_x",
                 "qp_warm_y", "qp_warm_rho", "qp_warm_minv"):
        w = np.asarray(getattr(want.ctrl, name))
        np.testing.assert_allclose(getattr(got.ctrl, name).numpy(), w,
                                   rtol=0,
                                   atol=1e-8 * max(1.0, np.abs(w).max()),
                                   err_msg=name)


def test_robust_tick_matches_jax(setup):
    """The uniform robust warm program (no cold branch)."""
    c0, _ = setup
    model = j_types.default_robot_model(jnp.float64)
    params = j_types.default_ctrl_params(jnp.float64)
    dt = jnp.asarray(DT, jnp.float64)
    c = _flip(c0, [0])
    sensors = jax.vmap(lambda sm, cs, fz: j_sim.read_sensors(
        sm, model, cs.contacts, fz, dt))(c.sim, c.ctrl, c.stance_forces_z)
    j_state = jax.vmap(lambda cs, s: j_ctrl.sensor_update(
        cs, model, s, dt))(c.ctrl, sensors)
    want = jax.jit(lambda cs: j_ctrl.control_step_batched(
        cs, model, params, dt, settings=J_SETTINGS,
        warm_settings=j_ctrl.ROBUST_WARM_SETTINGS._replace(
            schulz_impl="auto"), robust=True))(j_state)
    t_state = convert.from_numpy(t_types.CtrlState,
                                 jax.tree.map(np.asarray, j_state)._asdict(),
                                 "cpu", F64)
    stats = {}
    got = t_ctrl.control_step_batched(
        t_state, t_types.default_robot_model(F64, "cpu"),
        t_types.default_ctrl_params(F64, "cpu"), DT, settings=T_SETTINGS,
        warm_settings=t_ctrl.ROBUST_WARM_SETTINGS, robust=True, stats=stats)
    assert stats == {"robust": 1}
    for name in ("foot_forces_grf", "qp_warm_rho", "qp_warm_minv"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=1e-8 * max(1.0, np.abs(w).max()),
                                   err_msg=name)

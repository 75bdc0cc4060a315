"""PyTorch port, the long-horizon controller paths: ``control_step`` with
``horizon=40`` (``compute_grf_mpc_stagewise``, each scenario routed warm
or cold) and with ``receding_horizon=True`` (the averaged-euler,
receding-foothold condensation), and a short ``rollout(horizon=40)``,
held against the JAX package's on the same float64 states.

The stagewise ticks agree within 1e-6 x max(1, scale) per field (forces
in N; the stagewise solver's float64 parity, tests/test_torch_stagewise.py),
the receding ticks within 1e-8 x max(1, scale) (the dense solver's, as
tests/test_torch_control_step.py). The JAX side runs under vmap, where
``lax.cond`` computes both routes and selects per scenario; the port
routes each scenario on its own.
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
H = 40
BATCH = 3
# the cold / warm stagewise schedules of main.py rollout --horizon, cut
# to keep the file within a minute on one core
COLD = dict(seg_iters=20, segments=2, polish=False)
WARM = dict(seg_iters=10, segments=1, polish=False)
FIELDS = ("foot_forces_grf", "joint_torques", "qp_warm_x", "qp_warm_y",
          "qp_warm_rho", "qp_warm_grad")


def _jax_tick(**kw):
    model = j_types.default_robot_model(jnp.float64)
    params = j_types.default_ctrl_params(jnp.float64)
    dt = jnp.asarray(DT, jnp.float64)

    def one(c):
        sensors = j_sim.read_sensors(c.sim, model, c.ctrl.contacts,
                                     c.stance_forces_z, dt)
        ctrl = j_ctrl.sensor_update(c.ctrl, model, sensors, dt)
        ctrl = j_ctrl.control_step(ctrl, model, params, dt, **kw)
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


def _port_tick(c, **kw):
    model = t_types.default_robot_model(F64, "cpu")
    params = t_types.default_ctrl_params(F64, "cpu")
    stats = {}
    got, _ = t_rollout.rollout(_to_port(c), model, params, 1, DT,
                               stats=stats, **kw)
    return got, stats


def _assert_tick_equal(got, want, rel):
    for name in FIELDS:
        w = np.asarray(getattr(want.ctrl, name)).astype(np.float64)
        g = getattr(got.ctrl, name).numpy().astype(np.float64)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * max(1.0, np.abs(w).max()),
                                   err_msg=name)
    np.testing.assert_allclose(got.sim.root_pos.numpy(),
                               np.asarray(want.sim.root_pos), atol=1e-12)


def _batch(carry):
    rng = np.random.default_rng(0)
    c = jax.tree.map(lambda a: jnp.broadcast_to(a, (BATCH,) + a.shape),
                     carry)
    return c._replace(sim=c.sim._replace(
        root_pos=c.sim.root_pos.at[:, 2].add(0.005 * rng.normal(size=BATCH)),
        root_lin_vel=c.sim.root_lin_vel + 0.01 * rng.normal(
            size=(BATCH, 3))))


@pytest.fixture(scope="module")
def stagewise_mixed():
    """A standing batch at H = 40 after six ticks (the first ones cold
    while the gradient settles), aged past the young-carry window, then
    edited so that the next tick routes scenario 0 cold (a contact flip)
    and 1, 2 warm. Returns (carry, JAX tick)."""
    model = j_types.default_robot_model(jnp.float64)
    params = j_types.default_ctrl_params(jnp.float64)
    c = _batch(j_rollout.init_carry(model, params, height=0.3,
                                    dtype=jnp.float64, horizon=H))
    tick = _jax_tick(settings=j_admm.ADMMSettings(**COLD),
                     warm_settings=j_admm.ADMMSettings(**WARM), horizon=H)
    for _ in range(6):
        c = tick(c)
    ctrl = c.ctrl
    return c._replace(ctrl=ctrl._replace(
        mpc_init_counter=jnp.full_like(ctrl.mpc_init_counter, 100),
        qp_warm_contacts=ctrl.qp_warm_contacts.at[0].set(
            ~ctrl.qp_warm_contacts[0]))), tick


def _stagewise_kw():
    return dict(settings=t_admm.ADMMSettings(**COLD),
                warm_settings=t_admm.ADMMSettings(**WARM), horizon=H)


def test_stagewise_tick_routes_and_matches_jax(stagewise_mixed):
    """``control_step(horizon=40)`` on a mixed batch: scenario 0 cold,
    1 and 2 warm, each as JAX computes it; then a second tick from the
    port's own carry."""
    c, tick = stagewise_mixed
    want = tick(c)
    got, stats = _port_tick(c, **_stagewise_kw())
    assert stats == {"cold": 1, "warm": 2}
    assert got.ctrl.qp_warm_x.shape == (BATCH, 12 * H)
    assert got.ctrl.qp_warm_minv.shape == (BATCH, 1, 1)
    _assert_tick_equal(got, want, 1e-6)
    want2 = tick(want)
    got2, stats2 = _port_tick(want, **_stagewise_kw())
    assert stats2 == {"warm": BATCH}
    _assert_tick_equal(got2, want2, 1e-6)


@pytest.mark.parametrize("mode", ["warm", "cold"])
def test_stagewise_forced_modes_match_jax(stagewise_mixed, mode):
    """warm_mode "warm" / "cold" take one route for the whole batch."""
    c, _ = stagewise_mixed
    want = _jax_tick(settings=j_admm.ADMMSettings(**COLD),
                     warm_settings=j_admm.ADMMSettings(**WARM), horizon=H,
                     warm_mode=mode)(c)
    got, stats = _port_tick(c, warm_mode=mode, **_stagewise_kw())
    assert stats == {mode: BATCH}
    _assert_tick_equal(got, want, 1e-6)


def test_receding_horizon_ticks_match_jax():
    """Five ``control_step(receding_horizon=True)`` ticks from a walking
    diagonal stance (tests/test_srb_condensation.py:280-302), the default
    polished settings: every tick against JAX's, and the swing legs carry
    no force."""
    model = j_types.default_robot_model(jnp.float64)
    params = j_types.default_ctrl_params(jnp.float64)
    state = j_types.init_ctrl_state(model, jnp.float64)
    state = state._replace(
        movement_mode=jnp.asarray(1, jnp.int32),
        root_lin_vel_d=jnp.asarray([0.4, 0.0, 0.0], jnp.float64),
        contacts=jnp.asarray([True, False, False, True]))
    states = jax.tree.map(lambda a: jnp.stack([a, a]), state)
    states = states._replace(root_lin_vel_d=states.root_lin_vel_d.at[1].set(
        jnp.asarray([0.2, 0.1, 0.0])))
    dt = jnp.asarray(DT, jnp.float64)
    step = jax.jit(jax.vmap(lambda s: j_ctrl.control_step(
        s, model, params, dt, receding_horizon=True)))
    t_model = t_types.default_robot_model(F64, "cpu")
    t_params = t_types.default_ctrl_params(F64, "cpu")
    for _ in range(5):
        port = convert.from_numpy(
            t_types.CtrlState, jax.tree.map(np.asarray, states)._asdict(),
            "cpu", F64)
        stats = {}
        got = t_ctrl.control_step(port, t_model, t_params, DT,
                                  receding_horizon=True, stats=stats)
        states = step(states)
        assert stats == {"cold": 2}
        for name in FIELDS:
            w = np.asarray(getattr(states, name)).astype(np.float64)
            np.testing.assert_allclose(
                getattr(got, name).numpy(), w, rtol=0,
                atol=1e-8 * max(1.0, np.abs(w).max()), err_msg=name)
    grf = got.foot_forces_grf.numpy()
    assert (grf[:, 0, 2] > 10.0).all() and (grf[:, 3, 2] > 10.0).all()
    assert np.abs(grf[:, 1:3]).max() < 1e-6


def test_rollout_horizon_40_matches_jax():
    """``rollout(horizon=40)`` with the EKF, commanded to trot from the
    first tick: 44 ticks (the young-carry cold ticks, then warm ticks)
    against JAX's ``rollout`` trace (forces and torques 1e-6 N, positions
    1e-9 m)."""
    steps = 44
    jm = j_types.default_robot_model(jnp.float64)
    jp = j_types.default_ctrl_params(jnp.float64)
    jc = j_rollout.init_carry(jm, jp, height=0.3, dtype=jnp.float64,
                              horizon=H)

    def j_cmd(i, ctrl):
        return ctrl._replace(movement_mode=jnp.asarray(1, jnp.int32),
                             root_lin_vel_d=jnp.asarray([0.3, 0.0, 0.0]))

    _, want = jax.jit(lambda c: j_rollout.rollout(
        c, jm, jp, steps, jnp.asarray(DT), horizon=H, command_fn=j_cmd,
        settings=j_admm.ADMMSettings(**COLD),
        warm_settings=j_admm.ADMMSettings(**WARM)))(jc)

    model = t_types.default_robot_model(F64, "cpu")
    params = t_types.default_ctrl_params(F64, "cpu")
    carry = t_rollout.init_carry(model, params, 1, dtype=F64, device="cpu",
                                 horizon=H)

    def t_cmd(i, ctrl):
        return ctrl._replace(
            movement_mode=torch.ones_like(ctrl.movement_mode),
            root_lin_vel_d=torch.tensor([[0.3, 0.0, 0.0]], dtype=F64))

    stats = {}
    _, got = t_rollout.rollout(carry, model, params, steps, DT, horizon=H,
                               command_fn=t_cmd, stats=stats,
                               **{k: v for k, v in _stagewise_kw().items()
                                  if k != "horizon"})
    assert stats["cold"] >= 40 and stats.get("warm", 0) >= 1
    for name, tol in (("foot_forces_grf", 1e-6), ("joint_torques", 1e-6),
                      ("root_pos", 1e-9), ("est_root_pos", 1e-9)):
        np.testing.assert_allclose(getattr(got, name)[:, 0].numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=tol, rtol=0, err_msg=name)

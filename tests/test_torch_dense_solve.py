"""PyTorch port, the dense solver path: ``admm.solve`` / ``mpc_solve`` (with
polish and the "chol", "inv" and "schulz" KKT solvers), ``refine_f64``,
``solve_warm`` / ``mpc_solve_warm``, the fresh cold program
(``mpc_rho0_analytic`` / ``solve_cold_fused``) and the balance QP
(``ops/qp.py``), each held against the JAX package on the same inputs.

Float64 to round-off (1e-8 x the larger of 1 and the output's scale); the
float32 + ``refine_f64`` case at the 1e-3 N parity budget the JAX
package's own refinement test holds (tests/test_admm.py): float32
ADMM iterates legitimately differ at the 1e-2 N level between two
implementations on the r_weights ~1e-6 flat directions, and the float64
refinement removes that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch.compat import convert
from go1_qp_mpc_controller_torch.models import srb as t_srb
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_torch.ops import qp as t_qp
from go1_qp_mpc_controller_tpu.compat import oracle
from go1_qp_mpc_controller_tpu.models import srb as j_srb
from go1_qp_mpc_controller_tpu.ops import admm as j_admm
from go1_qp_mpc_controller_tpu.ops import qp as j_qp
from go1_qp_mpc_controller_tpu.parallel import sweep

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _fixture_qps(dtype, batch=3, seed=0):
    """The test_mpc.cpp fixture QP at ``batch`` perturbed start states."""
    f = oracle.test_mpc_fixture()
    rng = np.random.default_rng(seed)
    x0s = np.tile(f["x0"], (batch, 1))
    x0s[:, 5] += rng.uniform(-0.02, 0.02, batch)
    x0s[:, 9] += rng.uniform(-0.1, 0.1, batch)

    def one(x0):
        return j_srb.condense(
            jnp.asarray(f["a_d"], dtype), jnp.asarray(f["b_d_list"], dtype),
            x0, jnp.asarray(f["x_ref"], dtype).reshape(10, 13),
            jnp.asarray(f["q_weights"], dtype),
            jnp.asarray(f["r_weights"], dtype),
            jnp.asarray(f["contacts"], dtype))

    qps = jax.vmap(one)(jnp.asarray(x0s, dtype))
    return qps, convert.from_numpy(t_srb.CondensedQP,
                                   jax.tree.map(np.asarray, qps), CPU,
                                   _torch_dtype(dtype))


def _torch_dtype(dtype):
    return torch.float64 if dtype == jnp.float64 else torch.float32


def _assert_tree_close(got, want, tol, what=""):
    for name in got._fields:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=f"{what} {name}")


SOLVE_CASES = {
    "polish_chol": dict(),
    "polish_inv": dict(polish_solver="inv"),
    "schulz_scaled": dict(polish=False, schulz_l0=1e-6,
                          schulz_l0_first=1e-3, schulz_l0_refine=1e-4),
    "chol": dict(polish=False, kkt_solver="chol"),
    "inv": dict(polish=False, kkt_solver="inv", segments=2),
}


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_mpc_solve_matches_jax_f64(case):
    """Dense ``mpc_solve`` with ``return_warm``: the solution and the warm
    carry equal the JAX package's to round-off."""
    kw = SOLVE_CASES[case]
    qps, t_qps = _fixture_qps(jnp.float64)
    j_set = j_admm.ADMMSettings(**kw)
    want_sol, want_warm = jax.vmap(lambda qp: j_admm.mpc_solve(
        qp, j_set, return_warm=True))(qps)
    got_sol, got_warm = t_admm.mpc_solve(t_qps, t_admm.ADMMSettings(**kw),
                                         return_warm=True)
    _assert_tree_close(got_sol, want_sol, 1e-8, case)
    _assert_tree_close(got_warm, want_warm, 1e-8, case)


def test_mpc_solve_warm_started_matches_jax_f64():
    """Warm primal/dual/rho inputs (the controller's transition solve) and
    the plain result without ``return_warm``."""
    qps, t_qps = _fixture_qps(jnp.float64, seed=1)
    rng = np.random.default_rng(4)
    wx = rng.normal(size=(3, 120)) * 5.0
    wy = rng.normal(size=(3, 200)) * 0.1
    wr = np.array([0.05, 0.5, 2.0])
    j_set = j_admm.ADMMSettings(seg_iters=25, segments=3)
    want = jax.vmap(lambda qp, x, y, r: j_admm.mpc_solve(
        qp, j_set, warm_x=x, warm_y=y, warm_rho=r))(qps, wx, wy, wr)
    got = t_admm.mpc_solve(t_qps, t_admm.ADMMSettings(seg_iters=25,
                                                      segments=3),
                           warm_x=torch.tensor(wx), warm_y=torch.tensor(wy),
                           warm_rho=torch.tensor(wr))
    _assert_tree_close(got, want, 1e-8)


def test_refine_f64_on_f32_matches_jax():
    """float32 input + the float64 refinement: port and JAX (x64 on) both
    reach the converged reference GRFs within the 1e-3 N budget."""
    grf_ref, _, _, _ = oracle.solve_test_mpc_fixture()
    f = oracle.test_mpc_fixture()
    # the fixture itself (unperturbed start), as tests/test_admm.py solves
    j_qp32 = j_srb.condense(
        jnp.asarray(f["a_d"], jnp.float32),
        jnp.asarray(f["b_d_list"], jnp.float32),
        jnp.asarray(f["x0"], jnp.float32),
        jnp.asarray(f["x_ref"], jnp.float32).reshape(10, 13),
        jnp.asarray(f["q_weights"], jnp.float32),
        jnp.asarray(f["r_weights"], jnp.float32),
        jnp.asarray(f["contacts"], jnp.float32))
    t_qp32 = convert.from_numpy(
        t_srb.CondensedQP,
        jax.tree.map(lambda a: np.asarray(a)[None], j_qp32), CPU)
    kw = dict(refine_f64=True)
    want = j_admm.mpc_solve(j_qp32, j_admm.ADMMSettings(**kw))
    got = t_admm.mpc_solve(t_qp32, t_admm.ADMMSettings(**kw))
    assert got.x.dtype == torch.float32
    g = got.x[0, :12].numpy().reshape(4, 3)
    w = np.asarray(want.x[:12]).reshape(4, 3)
    assert np.abs(g - grf_ref).max() < 1e-3
    assert np.abs(g - w).max() < 1e-3
    # without the refinement the two float32 solves sit at the noise floor
    plain = t_admm.mpc_solve(t_qp32, t_admm.ADMMSettings())
    assert np.abs(plain.x[0, :12].numpy().reshape(4, 3)
                  - grf_ref).max() < 5e-2


def test_mpc_solve_warm_matches_jax_f64():
    """A warm tick on a drifted QP from the cold solve's carry."""
    qps, t_qps = _fixture_qps(jnp.float64, seed=2)
    cold = j_admm.ADMMSettings(polish=False)
    warm_set = dict(seg_iters=15, segments=1, polish=False, schulz_refine=2)
    _, j_warm = jax.vmap(lambda qp: j_admm.mpc_solve(
        qp, cold, return_warm=True))(qps)
    qps2 = qps._replace(gradient=qps.gradient * 1.01)
    want_sol, want_w = jax.vmap(lambda qp, w: j_admm.mpc_solve_warm(
        qp, w, j_admm.ADMMSettings(**warm_set)))(qps2, j_warm)
    t_warm = convert.from_numpy(t_admm.WarmState,
                                jax.tree.map(np.asarray, j_warm), CPU,
                                torch.float64)
    got_sol, got_w = t_admm.mpc_solve_warm(
        t_qps._replace(gradient=t_qps.gradient * 1.01), t_warm,
        t_admm.ADMMSettings(**warm_set))
    _assert_tree_close(got_sol, want_sol, 1e-8)
    _assert_tree_close(got_w, want_w, 1e-8)
    # warm_state_from_solution seeds the identity
    seeded = t_admm.warm_state_from_solution(got_sol)
    assert torch.equal(seeded.minv[1], torch.eye(120, dtype=torch.float64))


def _sweep_lazies(batch=6, seed=3):
    scn = sweep.random_scenarios(jax.random.PRNGKey(seed), batch,
                                 jnp.float64)

    def lazy_of(s):
        a_c = j_srb.calculate_A_c(s.x0[0:3])
        b_c = j_srb.calculate_B_c(s.mass, s.inertia, s.root_rot, s.foot_pos)
        a_d, b_d = j_srb.discretize(a_c, b_c, 0.0025)
        return j_srb.condense_nilpotent_lazy(a_d, b_d, s.x0, s.x_ref,
                                             s.q_weights, s.r_weights,
                                             s.contacts)

    lazy = jax.vmap(lazy_of)(scn)
    t_lazy = t_srb.LazyCondensedQP(*[torch.tensor(np.asarray(a))
                                     for a in lazy])
    return scn, lazy, t_lazy


def test_cold_fused_program_matches_jax_f64():
    """``mpc_rho0_analytic`` and the single-segment ``mpc_solve_cold`` on
    random sweep scenarios with per-scenario friction."""
    scn, lazy, t_lazy = _sweep_lazies()
    settings = dict(seg_iters=40, segments=1, polish=False, schulz_l0=1e-6,
                    schulz_hi_tail=1)
    rho0 = jax.vmap(j_admm.mpc_rho0_analytic)(scn.contacts, scn.mu,
                                              scn.foot_pos)
    mu = torch.tensor(np.asarray(scn.mu))
    t_rho0 = t_admm.mpc_rho0_analytic(torch.tensor(np.asarray(scn.contacts)),
                                      mu,
                                      torch.tensor(np.asarray(scn.foot_pos)))
    np.testing.assert_allclose(t_rho0.numpy(), np.asarray(rho0), rtol=1e-12)
    want_sol, want_w = jax.vmap(lambda lz, m, c, fp: j_admm.mpc_solve_cold(
        lz, j_admm.ADMMSettings(**settings), mu=m, contacts=c,
        foot_pos=fp))(lazy, scn.mu, scn.contacts, scn.foot_pos)
    got_sol, got_w = t_admm.mpc_solve_cold(
        t_lazy, t_admm.ADMMSettings(**settings), mu=mu,
        contacts=torch.tensor(np.asarray(scn.contacts)),
        foot_pos=torch.tensor(np.asarray(scn.foot_pos)))
    _assert_tree_close(got_sol, want_sol, 1e-8)
    _assert_tree_close(got_w, want_w, 1e-8)
    with pytest.raises(ValueError, match="rho0"):
        t_admm.mpc_solve_cold(t_lazy, t_admm.ADMMSettings(**settings))


def _balance_inputs(batch=4, seed=5):
    rng = np.random.default_rng(seed)
    euler = 0.1 * rng.normal(size=(batch, 3))
    euler_d = 0.1 * rng.normal(size=(batch, 3))
    euler_d[0, 2] = 3.0          # exercises the yaw unwrap
    euler[0, 2] = -3.0
    return dict(
        root_euler=euler, root_euler_d=euler_d,
        root_pos=np.array([0.0, 0.0, 0.3]) + 0.01 * rng.normal(
            size=(batch, 3)),
        root_pos_d=np.tile([0.0, 0.0, 0.3], (batch, 1)),
        root_rot_mat=np.stack([np.asarray(_rot(e)) for e in euler]),
        root_lin_vel=0.1 * rng.normal(size=(batch, 3)),
        root_lin_vel_d=0.1 * rng.normal(size=(batch, 3)),
        root_ang_vel=0.1 * rng.normal(size=(batch, 3)),
        root_ang_vel_d=0.1 * rng.normal(size=(batch, 3)),
        root_rot_mat_z=np.stack([np.asarray(_rot([0, 0, e[2]]))
                                 for e in euler]),
        foot_pos_abs=(np.array([[0.17, 0.15, -0.3], [0.17, -0.15, -0.3],
                                [-0.17, 0.15, -0.3], [-0.17, -0.15, -0.3]])
                      + 0.02 * rng.normal(size=(batch, 4, 3))),
        contacts=np.array([[1, 1, 1, 1], [1, 0, 0, 1], [0, 1, 1, 0],
                           [1, 1, 1, 0]], bool)[np.arange(batch) % 4])


def _rot(euler):
    from go1_qp_mpc_controller_tpu.utils import rotations
    return rotations.euler_to_rot_mat(jnp.asarray(euler, jnp.float64))


def test_balance_qp_matches_jax_f64():
    """``desired_root_acc``, ``build_balance_qp`` and ``solve_balance_qp``
    (K3 at n = 12 on the card; its plain version here)."""
    from types import SimpleNamespace

    from go1_qp_mpc_controller_torch.models import types as t_types
    from go1_qp_mpc_controller_tpu.models import types as j_types

    inp = _balance_inputs()
    jp = j_types.default_ctrl_params(jnp.float64)
    tp = t_types.default_ctrl_params(torch.float64, CPU)
    mass = 15.0
    keys = ("root_euler", "root_euler_d", "root_pos", "root_pos_d",
            "root_rot_mat", "root_lin_vel", "root_lin_vel_d",
            "root_ang_vel", "root_ang_vel_d")

    def j_acc(*vals):
        return j_qp.desired_root_acc(SimpleNamespace(**dict(zip(keys, vals))),
                                     jp, mass)

    want_acc = jax.vmap(j_acc)(*[jnp.asarray(inp[k]) for k in keys])
    t_ctrl = SimpleNamespace(**{k: torch.tensor(inp[k]) for k in keys})
    got_acc = t_qp.desired_root_acc(t_ctrl, tp, torch.tensor(mass,
                                                             dtype=torch.float64))
    np.testing.assert_allclose(got_acc.numpy(), np.asarray(want_acc),
                               rtol=1e-12, atol=1e-9)

    want_qp = jax.vmap(j_qp.build_balance_qp)(
        want_acc, jnp.asarray(inp["root_rot_mat_z"]),
        jnp.asarray(inp["foot_pos_abs"]), jnp.asarray(inp["contacts"]))
    got_qp = t_qp.build_balance_qp(
        got_acc, torch.tensor(inp["root_rot_mat_z"]),
        torch.tensor(inp["foot_pos_abs"]), torch.tensor(inp["contacts"]))
    _assert_tree_close(got_qp, want_qp, 1e-12)
    # the QP carried across by the converter, too
    t_from_j = convert.from_numpy(t_qp.BalanceQP,
                                  jax.tree.map(np.asarray, want_qp), CPU,
                                  torch.float64)
    _assert_tree_close(t_from_j, want_qp, 0.0)

    settings = dict(seg_iters=25, segments=3)
    want_grf, want_sol = jax.vmap(lambda q: j_qp.solve_balance_qp(
        q, j_admm.ADMMSettings(**settings)))(want_qp)
    got_grf, got_sol = t_qp.solve_balance_qp(t_from_j,
                                             t_admm.ADMMSettings(**settings))
    np.testing.assert_allclose(got_grf.numpy(), np.asarray(want_grf),
                               rtol=0, atol=1e-8 * 200.0)
    _assert_tree_close(got_sol, want_sol, 1e-8)


def test_unknown_kkt_solver_is_refused():
    _, t_qps = _fixture_qps(jnp.float64, batch=1)
    with pytest.raises(ValueError, match="kkt solver"):
        t_admm.mpc_solve(t_qps, t_admm.ADMMSettings(kkt_solver="qr"))


def test_failed_cholesky_flags_nan_without_raising():
    """A scenario whose KKT is not positive definite gets a NaN factor
    (JAX's behaviour) instead of an exception; the other scenarios are
    untouched."""
    m = torch.eye(3, dtype=torch.float64).repeat(2, 1, 1)
    m[1, 0, 0] = -1.0
    solve_fn, carry = t_admm._make_kkt_solve(m, t_admm.ADMMSettings(),
                                             solver="chol")
    out = solve_fn(torch.ones((2, 3), dtype=torch.float64))
    assert carry is None
    assert torch.equal(out[0], torch.ones(3, dtype=torch.float64))
    assert torch.isnan(out[1]).all()
    _, minv = t_admm._make_kkt_solve(torch.zeros_like(m),
                                     t_admm.ADMMSettings(), solver="inv")
    assert torch.isnan(minv).all()


def test_condensed_qp_and_state_carry_both_ways():
    """``srb.condense_nilpotent_const`` equals the JAX package's, and the
    converter carries its CondensedQP and a WarmState into the port's
    containers and back unchanged."""
    scn, lazy, t_lazy = _sweep_lazies(batch=2)

    def const_of(s):
        a_c = j_srb.calculate_A_c(s.x0[0:3])
        b_c = j_srb.calculate_B_c(s.mass, s.inertia, s.root_rot, s.foot_pos)
        a_d, b_d = j_srb.discretize(a_c, b_c, 0.0025)
        return j_srb.condense_nilpotent_const(a_d, b_d, s.x0, s.x_ref,
                                              s.q_weights, s.r_weights,
                                              s.contacts), (a_d, b_d)

    want, (a_d, b_d) = jax.vmap(const_of)(scn)
    t = lambda a: torch.tensor(np.asarray(a))
    got = t_srb.condense_nilpotent_const(
        t(a_d), t(b_d), t(scn.x0), t(scn.x_ref), t(scn.q_weights[0]),
        t(scn.r_weights[0]), t(scn.contacts))
    _assert_tree_close(got, want, 1e-12)
    for cls, tree in ((t_srb.CondensedQP, want),
                      (t_admm.WarmState, j_admm.WarmState(
                          x=want.gradient, y=want.lb * 0.0,
                          rho=jnp.asarray([0.1, 0.2]),
                          minv=want.hessian))):
        nd = jax.tree.map(np.asarray, tree)
        back = convert.to_numpy(convert.from_numpy(cls, nd, CPU,
                                                   torch.float64))
        for name in cls._fields:
            np.testing.assert_array_equal(back[name], getattr(nd, name))

"""PyTorch port, the stagewise long-horizon solver (``ops/stagewise.py``):
the H = 10 checks of tests/test_stagewise.py (the oracle fixture, the
condensed dense solver, per-stage B), the H = 40 dense cross-check, and
cold and warm solves held against the JAX package's ``mpc_solve`` /
``mpc_solve_warm`` on the same seeded random batch (float64, u within
1e-6 N of JAX's: the two compute the same iteration, their float64
rounding differs in the order of the affine passes' sums), the parallel
scan against the sequential one, and the batch against each scenario
alone (float32).

On the CPU the per-stage 12 x 12 inverse is K3's plain version; the
card-only tests hold K3 at n = 12 on Riccati matrices
(tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch.models import srb as t_srb
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_torch.ops import stagewise as t_sw
from go1_qp_mpc_controller_tpu.compat import oracle
from go1_qp_mpc_controller_tpu.ops import admm as j_admm
from go1_qp_mpc_controller_tpu.ops import stagewise as j_sw

torch.set_num_threads(1)
F64 = torch.float64
U_TOL = 1e-6      # N, port against JAX in float64


def _fixture(batch=1, dtype=F64):
    f = oracle.test_mpc_fixture()
    t = lambda a, *shape: torch.as_tensor(np.asarray(a), dtype=dtype).expand(
        batch, *shape).clone()
    return {"a_d": t(f["a_d"], 13, 13), "b_d": t(f["b_d_list"][0], 13, 12),
            "x0": t(f["x0"], 13),
            "x_ref": t(f["x_ref"].reshape(10, 13), 10, 13),
            "q": torch.as_tensor(f["q_weights"], dtype=dtype),
            "r": torch.as_tensor(f["r_weights"], dtype=dtype),
            "contacts": torch.as_tensor(f["contacts"]).expand(batch, 4)}


def _solve(f, x_ref=None, **kw):
    return t_sw.mpc_solve(f["a_d"], f["b_d"], f["x0"],
                          f["x_ref"] if x_ref is None else x_ref,
                          f["q"], f["r"], f["contacts"], **kw)


def test_stagewise_matches_oracle_h10():
    """The oracle fixture (tests/test_stagewise.py:30-44): the applied
    GRF within 2e-3 of the KKT-certified oracle, the trajectory within
    5e-3 of the condensed solution."""
    grf_ref, x_sol, _, _ = oracle.solve_test_mpc_fixture()
    sol = _solve(_fixture(), settings=t_admm.ADMMSettings(polish=False))
    u = sol.u[0].numpy()
    np.testing.assert_allclose(u[0].reshape(4, 3), grf_ref, atol=2e-3)
    np.testing.assert_allclose(u.reshape(-1), x_sol, atol=5e-3)


def test_per_stage_b_matches_condensed_h10():
    """Distinct per-stage B (receding footholds) through the Riccati path
    against the port's condensed dense solver (tests/test_stagewise.py:
    47-72: rtol 1e-3, atol 2e-2)."""
    fraw = oracle.test_mpc_fixture()
    b_list = torch.as_tensor(oracle.receding_b_d_list(
        fraw["mass"], fraw["inertia"], fraw["rot"], fraw["foot_pos"],
        np.array([0.4, 0.1, 0.0]), fraw["dt"]))[None]
    assert float((b_list[:, 1:] - b_list[:, :-1]).abs().max()) > 1e-5
    f = _fixture()
    st = t_admm.ADMMSettings(seg_iters=60, segments=3, polish=False)
    qp = t_srb.condense_nilpotent(f["a_d"], b_list, f["x0"], f["x_ref"],
                                  f["q"], f["r"], f["contacts"])
    dense = t_admm.mpc_solve(qp, st)
    stage = t_sw.mpc_solve(f["a_d"], b_list, f["x0"], f["x_ref"], f["q"],
                           f["r"], f["contacts"], settings=st)
    np.testing.assert_allclose(stage.u.reshape(-1).numpy(),
                               dense.x[0].numpy(), rtol=1e-3, atol=2e-2)


def _dense_reference(f, h, settings):
    """The horizon-h condensed QP built in numpy and solved by the port's
    dense ``admm.solve`` (tests/test_stagewise.py:75-112)."""
    a_d, b_d = f["a_d"][0].numpy(), f["b_d"][0].numpy()
    x0 = f["x0"][0].numpy()
    ref = np.tile(f["x_ref"][0, -1].numpy(), (h, 1))
    a_pows = [a_d]
    for _ in range(h - 1):
        a_pows.append(a_pows[-1] @ a_d)
    b_qp = np.zeros((h * 13, h * 12))
    for i in range(h):
        for j in range(i + 1):
            b_qp[13 * i:13 * (i + 1), 12 * j:12 * (j + 1)] = (
                b_d if j == i else a_pows[i - j - 1] @ b_d)
    qw = np.tile(2.0 * f["q"].numpy(), h)
    hess = b_qp.T @ (b_qp * qw[:, None]) + np.diag(
        np.tile(2.0 * f["r"].numpy(), h))
    resid = np.concatenate([a_pows[i] @ x0 for i in range(h)]) \
        - ref.reshape(-1)
    grad = (b_qp * qw[:, None]).T @ resid
    lb1, ub1 = t_srb._pyramid_bounds(f["contacts"], 0.0, 180.0, F64)
    lb, ub = lb1[:, :20].repeat(1, h), ub1[:, :20].repeat(1, h)
    mv = lambda u: t_sw._stage_matvec(u.reshape(-1, h, 12), 0.3).reshape(
        u.shape[0], -1)
    rmv = lambda y: t_sw._stage_rmatvec(y.reshape(-1, h, 20), 0.3).reshape(
        y.shape[0], -1)
    c = mv(torch.eye(h * 12, dtype=F64)).T                   # (20h, 12h)
    rmv_dense = lambda w: c.T @ (w[..., None] * c)
    sol = t_admm.solve(torch.as_tensor(hess)[None],
                       torch.as_tensor(grad)[None], lb, ub, mv, rmv,
                       rmv_dense, settings)
    return sol.x[0].reshape(h, 12)


def test_stagewise_matches_dense_h40():
    """H = 40 against the dense condensed QP at the same schedule
    (tests/test_stagewise.py:115-136: rtol 1e-3, atol 1e-2), feasible
    per stage and zero on the swing legs (5e-3)."""
    f = _fixture()
    h = 40
    x_ref = f["x_ref"][:, -1:].expand(1, h, 13)
    st = t_admm.ADMMSettings(seg_iters=80, segments=4, polish=False)
    u = _solve(f, x_ref, settings=st).u[0]
    assert torch.isfinite(u).all()
    np.testing.assert_allclose(u.numpy(), _dense_reference(f, h, st).numpy(),
                               rtol=1e-3, atol=1e-2)
    cu = t_sw._stage_matvec(u, 0.3)
    lb1, ub1 = t_srb._pyramid_bounds(f["contacts"], 0.0, 180.0, F64)
    assert bool((cu - ub1[0, :20] < 5e-3).all())
    assert bool((lb1[0, :20] - cu < 5e-3).all())
    np.testing.assert_allclose(u[:, 3:6].numpy(), 0.0, atol=5e-3)
    np.testing.assert_allclose(u[:, 9:12].numpy(), 0.0, atol=5e-3)


def _random_batch(seed, batch, h):
    """Seeded random stagewise problems around the fixture: per-scenario
    x0, reference, weights, friction, contact pattern and, for half the
    batch, per-stage B."""
    rng = np.random.default_rng(seed)
    fraw = oracle.test_mpc_fixture()
    pats = np.array([[1, 1, 1, 1], [1, 0, 0, 1], [0, 1, 1, 0], [1, 1, 1, 0]],
                    bool)
    out = {k: [] for k in ("a_d", "b_d", "x0", "x_ref", "q", "r", "contacts",
                           "mu")}
    for i in range(batch):
        vel = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.3, 0.3), 0.0])
        feet = fraw["foot_pos"] + 0.02 * rng.normal(size=(4, 3))
        b10 = oracle.receding_b_d_list(fraw["mass"], fraw["inertia"],
                                       fraw["rot"], feet, vel, fraw["dt"])
        b = np.concatenate([b10] * (h // 10)) if i % 2 else np.broadcast_to(
            b10[0], (h, 13, 12))
        out["a_d"].append(oracle.discretize(oracle.calculate_A_c(
            0.1 * rng.normal(size=3)), np.zeros((13, 12)), fraw["dt"])[0])
        out["b_d"].append(b)
        x0 = fraw["x0"] + 0.02 * rng.normal(size=13)
        out["x0"].append(x0)
        ref = np.tile(x0, (h, 1))
        ref[:, 3:5] += vel[:2] * fraw["dt"] * np.arange(1, h + 1)[:, None]
        ref[:, 9:12] = vel
        ref[:, 5] = 0.3
        out["x_ref"].append(ref)
        out["q"].append(np.array([80.0, 80.0, 1.0, 0.0, 0.0, 270.0, 1.0,
                                  1.0, 20.0, 20.0, 20.0, 20.0, 0.0])
                        * rng.uniform(0.5, 1.5, 13))
        out["r"].append(np.array([1e-5, 1e-5, 1e-6] * 4))
        out["contacts"].append(pats[i % 4])
        out["mu"].append(rng.uniform(0.3, 0.7))
    return {k: np.stack(v) for k, v in out.items()}


def _jax_batch(fn, p, **kw):
    """JAX's ``fn`` over the batch (vmapped, one compile)."""
    args = [jnp.asarray(p[k]) for k in ("a_d", "b_d", "x0", "x_ref", "q",
                                        "r", "contacts", "mu")]
    return jax.jit(jax.vmap(lambda *a: fn(*a[:7], mu=a[7], **kw)))(*args)


def _torch_args(p, dtype=F64):
    t = lambda k: torch.as_tensor(np.ascontiguousarray(p[k]), dtype=dtype)
    return ([t(k) for k in ("a_d", "b_d", "x0", "x_ref", "q", "r")]
            + [torch.as_tensor(p["contacts"])]), t("mu")


def test_cold_and_warm_match_jax_h40():
    """H = 40 cold solves (bench.py's stagewise settings: 60 x 3) then
    two warm ticks (25 iterations) with drift, against JAX's mpc_solve /
    mpc_solve_warm per scenario: u within 1e-6 N, y within 1e-6 x
    (1 + max|y|), rho equal to 1e-9 relative."""
    h, batch = 40, 4
    p = _random_batch(11, batch, h)
    cold = j_admm.ADMMSettings(seg_iters=60, segments=3, polish=False)
    warm = j_admm.ADMMSettings(seg_iters=25, segments=1, polish=False)
    args, mu = _torch_args(p)
    sol, w = t_sw.mpc_solve(*args, mu=mu, settings=t_admm.ADMMSettings(
        **cold._asdict()), return_warm=True)
    js, jw = _jax_batch(lambda *a, mu: j_sw.mpc_solve(
        *a, mu=mu, settings=cold, return_warm=True), p)
    np.testing.assert_allclose(sol.u.numpy(), np.asarray(js.u), atol=U_TOL,
                               rtol=0)
    ys = 1.0 + np.abs(np.asarray(js.y)).max((1, 2))
    assert (np.abs(sol.y.numpy() - np.asarray(js.y)).max((1, 2))
            < 1e-6 * ys).all()
    np.testing.assert_allclose(sol.rho.numpy(), np.asarray(js.rho),
                               rtol=1e-9)
    drift = np.zeros(13)
    drift[9], drift[5] = 0.002, -0.0005
    warm_fn = jax.jit(jax.vmap(lambda *a: j_sw.mpc_solve_warm(
        *a[:7], a[8], mu=a[7], settings=warm)))
    for _ in range(2):
        p["x0"] = p["x0"] + drift
        args, mu = _torch_args(p)
        sol, w = t_sw.mpc_solve_warm(*args, w, mu=mu,
                                     settings=t_admm.ADMMSettings(
                                         **warm._asdict()))
        js, jw = warm_fn(*[jnp.asarray(p[k]) for k in (
            "a_d", "b_d", "x0", "x_ref", "q", "r", "contacts", "mu")], jw)
        np.testing.assert_allclose(sol.u.numpy(), np.asarray(js.u),
                                   atol=U_TOL, rtol=0)
        np.testing.assert_allclose(w.q_lin.numpy(), np.asarray(jw.q_lin),
                                   atol=1e-9, rtol=1e-9)


def test_linear_term_matches_jax():
    """``linear_term`` (the controller's drift trigger) against JAX's,
    per-stage and shared B (1e-9 relative to its scale)."""
    h, batch = 20, 2
    p = _random_batch(12, batch, h)
    args, _ = _torch_args(p)
    got = t_sw.linear_term(*args[:6])
    for i in range(batch):
        want = np.asarray(j_sw.linear_term(*[jnp.asarray(p[k][i]) for k in (
            "a_d", "b_d", "x0", "x_ref", "q", "r")]))
        np.testing.assert_allclose(got[i].numpy(), want,
                                   atol=1e-9 * np.abs(want).max(), rtol=0)


def test_parallel_scan_matches_sequential():
    """The log-depth affine scans equal the sequential passes at H = 24
    (tests/test_stagewise.py:139-153, 1e-8), and JAX's parallel form."""
    f = _fixture()
    h = 24
    x_ref = f["x_ref"][:, -1:].expand(1, h, 13)
    st = t_admm.ADMMSettings(seg_iters=30, segments=2, polish=False)
    u_seq = _solve(f, x_ref, settings=st).u
    u_par = _solve(f, x_ref, settings=st, parallel_scan=True).u
    np.testing.assert_allclose(u_par.numpy(), u_seq.numpy(), atol=1e-8,
                               rtol=0)
    j_par = j_sw.mpc_solve(*[jnp.asarray(v[0].numpy()) for v in (
        f["a_d"], f["b_d"], f["x0"], x_ref)], jnp.asarray(f["q"].numpy()),
        jnp.asarray(f["r"].numpy()), jnp.asarray(f["contacts"][0].numpy()),
        settings=j_admm.ADMMSettings(**st._asdict()), parallel_scan=True).u
    np.testing.assert_allclose(u_par[0].numpy(), np.asarray(j_par),
                               atol=U_TOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_affine_scan_matches_recurrence(reverse):
    """``_affine_scan`` against the plain recurrence on random maps at a
    horizon that is not a power of two (1e-12)."""
    rng = np.random.default_rng(13)
    h = 13
    e = torch.as_tensor(np.eye(5) + 0.1 * rng.normal(size=(2, h, 5, 5)))
    f = torch.as_tensor(rng.normal(size=(2, h, 5)))
    v = torch.zeros((2, 5), dtype=F64)
    want = [None] * h
    for i in (reversed(range(h)) if reverse else range(h)):
        v = (e[:, i] @ v[..., None])[..., 0] + f[:, i]
        want[i] = v
    np.testing.assert_allclose(t_sw._affine_scan(e, f, reverse).numpy(),
                               torch.stack(want, 1).numpy(), atol=1e-12,
                               rtol=0)


def test_stagewise_batched_consistency_f32():
    """The batch equals each scenario solved alone (float32,
    tests/test_stagewise.py:156-173: 5e-4)."""
    batch = 4
    f = _fixture(batch, torch.float32)
    rng = np.random.default_rng(5)
    f["x0"] = f["x0"] + torch.as_tensor(0.01 * rng.normal(size=(batch, 13)),
                                        dtype=torch.float32)
    st = t_admm.ADMMSettings(seg_iters=40, segments=2, polish=False)
    batched = _solve(f, settings=st).u
    for i in range(batch):
        one = {k: (v[i:i + 1] if v.dim() and v.shape[0] == batch
                   and k not in ("q", "r") else v) for k, v in f.items()}
        np.testing.assert_allclose(batched[i].numpy(),
                                   _solve(one, settings=st).u[0].numpy(),
                                   atol=5e-4)


def test_warm_tick_tracks_cold_h40():
    """Warm ticks track a full cold solve across drifting ticks at H = 40
    (tests/test_stagewise.py:176-200: applied GRF within 1 N)."""
    f = _fixture()
    h = 40
    x_ref = f["x_ref"][:, -1:].expand(1, h, 13)
    cold = t_admm.ADMMSettings(seg_iters=60, segments=3, polish=False)
    warm_st = t_admm.ADMMSettings(seg_iters=25, segments=1, polish=False)
    _, warm = _solve(f, x_ref, settings=cold, return_warm=True)
    drift = torch.zeros(13, dtype=F64)
    drift[9], drift[5] = 0.002, -0.0005
    for k in range(6):
        f["x0"] = f["x0"] + drift
        sol_w, warm = t_sw.mpc_solve_warm(
            f["a_d"], f["b_d"], f["x0"], x_ref, f["q"], f["r"],
            f["contacts"], warm, settings=warm_st)
        sol_c = _solve(f, x_ref, settings=cold)
        d = float((sol_w.u[0, 0] - sol_c.u[0, 0]).abs().max())
        assert d < 1.0, (k, d)

"""PyTorch port, kernels K3 (dense Schulz inverse) and K6 (the ADMM loop
on the resident inverse): their plain versions against the Pallas kernels
they replace, run in interpret mode, and against the JAX XLA routes.

K3 (``schulz_batch.schulz_inverse_batch``, on the CPU its plain version)
against ``pallas_admm.schulz_inverse_batch(interpret=True)`` at n = 120
and n = 12, cold, warm and warm-reject, float32, at the tolerances of
tests/test_pallas_admm.py (1e-3 x max|ref|, residual ||M X - I|| < 1e-4:
the Pallas middle steps are 3-pass bf16 products); in float64 against the
XLA schedule to round-off, the empty schedule included. K6
(``admm_iterations.admm_iterations``) and the port's
``mpc_solve_warm_batch`` against ``pallas_admm.mpc_solve_warm_batch
(interpret=True)``, batch 8, at that file's tolerances (1e-3 on x, 0.1 x
(1 + max|y|) on y).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch.compat import convert
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_torch.ops import admm_iterations, schulz_batch
from go1_qp_mpc_controller_torch.models import srb as t_srb
from go1_qp_mpc_controller_tpu.compat import oracle
from go1_qp_mpc_controller_tpu.models import srb as j_srb
from go1_qp_mpc_controller_tpu.ops import admm as j_admm
from go1_qp_mpc_controller_tpu.ops import pallas_admm

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _spd(b, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n))
    m = a @ a.transpose(0, 2, 1) / n + 3.0 * np.eye(n)
    # rows of very different scale, as the rho_eq-boosted KKTs have
    s = np.exp(rng.uniform(-2.0, 2.0, size=(b, n)))
    return (m * s[:, :, None] * s[:, None, :]).astype(dtype)


def _check_f32(got, want, m):
    got = got.numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-3 * scale
    resid = np.abs(np.einsum('bij,bjk->bik', m.astype(np.float64), got)
                   - np.eye(m.shape[-1])).max()
    assert resid < 1e-4, resid


@pytest.mark.parametrize("n", [120, 12])
def test_k3_plain_matches_pallas_f32(n):
    m = _spd(4, n, seed=n)
    coeffs = j_admm._scaled_schulz_coeffs(1e-6)
    tm = torch.tensor(m)
    cold = pallas_admm.schulz_inverse_batch(jnp.asarray(m), 0, coeffs=coeffs,
                                            interpret=True)
    got = schulz_batch.schulz_inverse_batch(tm, coeffs=coeffs)
    _check_f32(got, cold, m)
    # warm accepted everywhere, then garbage in half the batch (rejected,
    # the scaled cold schedule runs there)
    x0 = np.asarray(cold) * (1.0 + 1e-3)
    x0_mix = x0.copy()
    x0_mix[::2] = 5.0
    for start in (x0, x0_mix):
        want = pallas_admm.schulz_inverse_batch(
            jnp.asarray(m), 0, x0=jnp.asarray(start), coeffs=coeffs,
            interpret=True)
        got = schulz_batch.schulz_inverse_batch(tm, torch.tensor(start),
                                                coeffs)
        _check_f32(got, want, m)
    # the dense solver's default: 20 plain steps, cold
    want = pallas_admm.schulz_inverse_batch(jnp.asarray(m), 20,
                                            interpret=True)
    got = schulz_batch.schulz_inverse_batch(tm, coeffs=(1.0,) * 20)
    _check_f32(got, want, m)


@pytest.mark.parametrize("iters", [0, 3])
def test_k3_plain_matches_xla_f64(iters):
    """Float64: the XLA ``admm._schulz_inverse`` to round-off, with a warm
    start accepted in some scenarios and rejected in others; ``iters`` 0
    is the empty schedule (the accepted start as it is, else c I)."""
    m = _spd(4, 120, seed=7, dtype=np.float64)
    conv = jax.vmap(lambda mm: j_admm._schulz_inverse(
        mm, 0, coeffs=j_admm._scaled_schulz_coeffs(1e-6)))(jnp.asarray(m))
    x0 = np.asarray(conv) * (1.0 + 1e-4)
    x0[1] = -x0[1]
    want = jax.vmap(lambda mm, xx: j_admm._schulz_inverse(mm, iters, xx))(
        jnp.asarray(m), jnp.asarray(x0))
    got = t_admm._schulz_inverse(torch.tensor(m), iters, torch.tensor(x0))
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-9 * scale)
    if iters == 0:
        np.testing.assert_allclose(got[0].numpy(), x0[0], rtol=1e-12)


def test_eager_ekf_keeps_the_plain_schulz(monkeypatch):
    """The eager EKF's 28x28 innovation inverse is not K3's (K4 waits):
    it never calls the K3 wrapper."""
    from go1_qp_mpc_controller_torch.models import kinematics
    from go1_qp_mpc_controller_torch.ops import ekf
    from go1_qp_mpc_controller_torch.utils import rotations

    def refuse(*args, **kwargs):
        raise AssertionError("the EKF reached K3")

    monkeypatch.setattr(schulz_batch, "schulz_inverse_batch", refuse)
    b = 2
    quat = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * b, dtype=torch.float64)
    rot = rotations.quat_to_rot_mat(quat)
    geom = kinematics.a1_leg_geometry(torch.float64, CPU)
    qpos = torch.tensor([0.0, 0.8, -1.6] * 4, dtype=torch.float64).repeat(
        b, 1)
    feet = kinematics.foot_positions_body(qpos, geom)
    x, p = ekf.init_state(rot, feet)
    zeros3 = torch.zeros((b, 3), dtype=torch.float64)
    out = ekf.update_estimation(
        x, p, 0.002, rot, zeros3, zeros3, feet,
        torch.zeros((b, 4, 3), dtype=torch.float64),
        torch.full((b, 4), 100.0, dtype=torch.float64),
        torch.zeros((b,), dtype=torch.int32))
    assert torch.isfinite(out[1]).all()


# schulz_refine=0: the basin-accepted carried inverse is used as it is, so
# both sides iterate on the same inverse. With refinement steps the two
# float32 inverses differ by product round-off, which the QP's r_weights
# ~1e-6 flat directions amplify to ~1e-2 in x on BOTH implementations
# (measured against a float64 reference); the refinement is held in
# float64 below instead.
WARM = dict(seg_iters=40, segments=1, polish=False, schulz_refine=0)


def _fixture_batch(b=8, seed=2):
    f = oracle.test_mpc_fixture()
    rng = np.random.default_rng(seed)
    x0s = (np.tile(f["x0"], (b, 1)) + rng.normal(size=(b, 13)) * 0.01)

    def qps_at(xs):
        def one(x0):
            return j_srb.condense(
                jnp.asarray(f["a_d"], jnp.float32),
                jnp.asarray(f["b_d_list"], jnp.float32), x0,
                jnp.asarray(f["x_ref"], jnp.float32).reshape(10, 13),
                jnp.asarray(f["q_weights"], jnp.float32),
                jnp.asarray(f["r_weights"], jnp.float32),
                jnp.asarray(f["contacts"], jnp.float32))
        return jax.vmap(one)(jnp.asarray(xs, jnp.float32))

    _, warms = jax.vmap(lambda qp: j_admm.mpc_solve(
        qp, j_admm.ADMMSettings(polish=False), return_warm=True))(
            qps_at(x0s))
    return qps_at(x0s + 0.002), warms


def _to_t(cls, tree):
    return convert.from_numpy(cls, jax.tree.map(np.asarray, tree), CPU)


def test_k6_and_warm_batch_match_pallas_f32():
    qps, warms = _fixture_batch()
    b = qps.gradient.shape[0]
    mus = np.linspace(0.3, 0.6, b).astype(np.float32)
    want_sol, want_warm = pallas_admm.mpc_solve_warm_batch(
        qps, warms, jnp.asarray(mus), j_admm.ADMMSettings(**WARM),
        interpret=True)
    t_qps = _to_t(t_srb.CondensedQP, qps)
    t_warms = _to_t(t_admm.WarmState, warms)
    got_sol, got_warm = admm_iterations.mpc_solve_warm_batch(
        t_qps, t_warms, torch.tensor(mus), t_admm.ADMMSettings(**WARM))
    x_err = np.abs(got_sol.x.numpy() - np.asarray(want_sol.x)).max(-1)
    assert x_err.max() < 1e-3, x_err
    y_w = np.asarray(want_sol.y)
    assert (np.abs(got_sol.y.numpy() - y_w).max()
            < 1e-1 * (1 + np.abs(y_w).max()))
    # the residuals agree too (the carried inverse was built at mu = 0.3,
    # so the scenarios with another mu converge less far on both sides)
    p_w = np.asarray(want_sol.primal_res)
    np.testing.assert_allclose(got_sol.primal_res.numpy(), p_w, rtol=0,
                               atol=1e-3 * (1.0 + p_w.max()))
    np.testing.assert_allclose(got_warm.minv.numpy(),
                               np.asarray(want_warm.minv), rtol=0,
                               atol=1e-3 * np.abs(want_warm.minv).max())

    # K6 alone on the same inverses and scaled inputs
    cost = 1.0 / np.abs(np.asarray(qps.hessian)).max(axis=(1, 2))
    eq = np.isclose(np.asarray(qps.lb), np.asarray(qps.ub))
    rho = np.asarray(warms.rho)[:, None]
    rho_vec = np.where(eq, rho * 1e3, rho).astype(np.float32)
    big = np.finfo(np.float32).max / 8
    lb = np.maximum(np.asarray(qps.lb), -big)
    ub = np.minimum(np.asarray(qps.ub), big)
    qbar = (cost[:, None] * np.asarray(qps.gradient)).astype(np.float32)
    y0 = (np.asarray(warms.y) * cost[:, None]).astype(np.float32)
    minv = np.asarray(want_warm.minv)
    args = (minv, qbar, lb, ub, rho_vec, mus, np.asarray(warms.x), y0)
    want_x, want_y = pallas_admm.admm_iterations(
        *[jnp.asarray(a) for a in args], iters=20, interpret=True)
    got_x, got_y = admm_iterations.admm_iterations(
        *[torch.tensor(a) for a in args], iters=20)
    assert np.abs(got_x.numpy() - np.asarray(want_x)).max(-1).max() < 1e-3
    assert (np.abs(got_y.numpy() - np.asarray(want_y)).max()
            < 1e-1 * (1 + np.abs(np.asarray(want_y)).max()))


def test_warm_batch_matches_xla_warm_tick_f64():
    """Float64: ``mpc_solve_warm_batch`` equals the JAX XLA warm tick
    (``admm.mpc_solve_warm``) on x to round-off (no rho adaptation in
    either at these settings); its z is clip(C x)."""
    f = oracle.test_mpc_fixture()
    qp = j_srb.condense(
        jnp.asarray(f["a_d"]), jnp.asarray(f["b_d_list"]),
        jnp.asarray(f["x0"]), jnp.asarray(f["x_ref"]).reshape(10, 13),
        jnp.asarray(f["q_weights"]), jnp.asarray(f["r_weights"]),
        jnp.asarray(f["contacts"]))
    qps = jax.tree.map(lambda a: jnp.stack([a, a * 1.0]), qp)
    qps = qps._replace(gradient=qps.gradient.at[1].multiply(1.01))
    _, warms = jax.vmap(lambda q: j_admm.mpc_solve(
        q, j_admm.ADMMSettings(polish=False), return_warm=True))(qps)
    settings = dict(seg_iters=15, segments=1, polish=False, schulz_refine=2)
    want, _ = jax.vmap(lambda q, w: j_admm.mpc_solve_warm(
        q, w, j_admm.ADMMSettings(**settings)))(qps, warms)
    t = lambda cls, tree: convert.from_numpy(
        cls, jax.tree.map(np.asarray, tree), CPU, torch.float64)
    got, _ = admm_iterations.mpc_solve_warm_batch(
        t(t_srb.CondensedQP, qps), t(t_admm.WarmState, warms),
        torch.full((2,), 0.3, dtype=torch.float64),
        t_admm.ADMMSettings(**settings))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(want.x)).max())


@pytest.mark.parametrize("batch, sms, per_sm, grid", [
    (1, 132, 2, 1), (2, 132, 2, 2), (133, 132, 2, 133), (264, 132, 2, 264),
    (265, 132, 2, 264), (4096, 132, 3, 396)])
def test_k6_persistent_grid(batch, sms, per_sm, grid):
    """K6's grid: every resident block of the card, never more than one a
    scenario (a block loops over b, b + grid, ...)."""
    assert admm_iterations.persistent_grid(batch, sms, per_sm) == grid
    # the blocks' scenario strides cover the batch once
    covered = sorted(b for blk in range(grid)
                     for b in range(blk, batch, grid))
    assert covered == list(range(batch))



def _round_f32(v):
    """The float32 nearest the rational ``v`` (ties to even)."""
    from fractions import Fraction
    c = np.float32(float(v))
    cands = (np.nextafter(c, np.float32(-np.inf)), c,
             np.nextafter(c, np.float32(np.inf)))
    return min(cands, key=lambda f: (abs(Fraction(float(f)) - v),
                                     int(np.array(f).view(np.uint32)) & 1))


def test_k6_quotient_sequence_rounds_like_division():
    """K6 takes y / rho as q0 = y (1 / rho) corrected once,
    q = fma(fma(-rho, q0, y), 1 / rho, q0) (csrc/admm_iterations.cu,
    row_update): with each FMA rounded once, q is the correctly rounded
    quotient the plain loop divides to, over the magnitudes the loop
    meets, exact quotients and all-ones significands included."""
    from fractions import Fraction
    rng = np.random.default_rng(0)
    n = 4000
    rho = (10.0 ** rng.uniform(-6, 6, n)).astype(np.float32)
    y = (rng.choice([-1.0, 1.0], n)
         * 10.0 ** rng.uniform(-10, 10, n)).astype(np.float32)
    ones = np.float32(2.0 - 2.0 ** -23)
    rho[:200] = ones * np.float32(2.0) ** rng.integers(-20, 20, 200)
    y[200:400] = ones * np.float32(2.0) ** rng.integers(-30, 30, 200)
    y[400:600] = rho[400:600] * rng.integers(-1000, 1000, 200)
    y[600] = 0.0
    for yi, ri in zip(y, rho):
        rinv = np.float32(1.0) / ri
        q0 = yi * rinv
        # fma(-rho, q0, y): rho q0 and its difference with y are exact in
        # float64, so one rounding to float32
        r = np.float32(np.float64(yi) - np.float64(ri) * np.float64(q0))
        q = _round_f32(Fraction(float(q0))
                       + Fraction(float(r)) * Fraction(float(rinv)))
        assert q == yi / ri, (yi, ri)

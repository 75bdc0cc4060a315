"""PyTorch port, kernel K1 (fused KKT build + Newton-Schulz inverse) and
the ADMM solve programs that reach it, held against the JAX package.

K1's plain version runs against the Pallas kernel it replaces
(``pallas_admm.schulz_inverse_kkt_batch`` in interpret mode, tile 2) and
against ``admm._schulz_inverse`` on the materialized KKT, in float32 at
3e-4 x max|ref| (the tolerance of tests/test_pallas_admm.py: the Pallas
middle steps are 3-pass bf16 products) and in float64 at 1e-9 relative.
The solve programs agree with the JAX package in float64 to round-off and
in float32 at 2e-1 N (tests/test_pallas_admm.py:326: the condensed QP has
near-flat directions on which algebraically equal f32 formulations differ
at the 0.1 N level).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch.models import srb as t_srb
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_torch.ops import kkt_schulz
from go1_qp_mpc_controller_tpu.models import srb as j_srb
from go1_qp_mpc_controller_tpu.ops import admm as j_admm
from go1_qp_mpc_controller_tpu.ops import pallas_admm
from go1_qp_mpc_controller_tpu.parallel import sweep

torch.set_num_threads(1)
SIGMA = 1e-6
MU = 0.3
# the JAX bench's cold transition settings (polish off: the port has no
# dense polished solve yet)
COLD = dict(seg_iters=30, segments=2, first_seg_iters=20, polish=False,
            schulz_l0=1e-6, schulz_l0_first=1e-3, schulz_l0_refine=1e-4,
            schulz_hi_tail=1)
WARM = dict(seg_iters=20, segments=1, polish=False, schulz_refine=1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _lazies(dtype, batch=6, seed=3):
    scn = sweep.random_scenarios(jax.random.PRNGKey(seed), batch, dtype)

    def lazy_of(s):
        a_c = j_srb.calculate_A_c(s.x0[0:3])
        b_c = j_srb.calculate_B_c(s.mass, s.inertia, s.root_rot, s.foot_pos)
        a_d, b_d = j_srb.discretize(a_c, b_c, 0.0025)
        return j_srb.condense_nilpotent_lazy(a_d, b_d, s.x0, s.x_ref,
                                             s.q_weights, s.r_weights,
                                             s.contacts)

    lazy = jax.vmap(lazy_of)(scn)
    return lazy, t_srb.LazyCondensedQP(*[_t(a) for a in lazy])


def _operands(lazy, rho=0.05):
    def one(lz):
        eq = jnp.isclose(lz.lb, lz.ub)
        rho_vec = jnp.where(eq, rho * 1e3, rho)
        return j_admm._kkt_kernel_operands(lz, rho_vec, SIGMA, MU), rho_vec

    ops, rho_vec = jax.vmap(one)(lazy)

    def m_of(lz, rv, c):
        h = j_srb.lazy_hessian(lz)
        return (c * h + SIGMA * jnp.eye(h.shape[-1], dtype=h.dtype)
                + j_admm._pyramid_ctc_dense(rv, MU, h.dtype))

    m_mats = jax.vmap(m_of)(lazy, rho_vec, ops[4])
    return ops, rho_vec, m_mats


def _warm_start(ref, seed=1):
    """A perturbed converged inverse; scenario 0 gets its negation, which
    fails the basin test (exercises the scaled cold fallback)."""
    rng = np.random.default_rng(seed)
    x0 = np.asarray(ref) + 1e-3 * rng.normal(size=ref.shape).astype(
        np.asarray(ref).dtype)
    x0[0] = -x0[0]
    return x0


def test_k1_plain_matches_pallas_kernel_and_xla_f32():
    lazy, _ = _lazies(jnp.float32)
    ops, _, m_mats = _operands(lazy)
    t_ops = [_t(a) for a in ops]
    coeffs = j_admm._scaled_schulz_coeffs(1e-4)

    ref = jax.vmap(lambda m: j_admm._schulz_inverse(m, 0, coeffs=coeffs))(
        m_mats)
    pal = pallas_admm.schulz_inverse_kkt_batch(*ops, coeffs=coeffs,
                                               interpret=True, tile=2)
    got = kkt_schulz.kkt_schulz(*t_ops, coeffs=coeffs)   # CPU: plain
    scale = np.abs(np.asarray(ref)).max()
    for want in (ref, pal):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=3e-4 * scale, rtol=0)

    x0 = _warm_start(ref)
    ref_w = jax.vmap(lambda m, x: j_admm._schulz_inverse(m, 2, x))(m_mats, x0)
    pal_w = pallas_admm.schulz_inverse_kkt_batch(*ops, x0=x0, iters=2,
                                                 interpret=True, tile=2)
    got_w = kkt_schulz.kkt_schulz(*t_ops, x0=_t(x0), coeffs=(1.0, 1.0))
    for want in (ref_w, pal_w):
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want),
                                   atol=3e-4 * scale, rtol=0)


@pytest.mark.parametrize("variant", ["cold", "warm", "warm_scaled"])
def test_k1_plain_matches_xla_f64(variant):
    """Float64: the plain version computes the JAX XLA schedule to
    round-off (1e-9 x max|ref|)."""
    lazy, t_lazy = _lazies(jnp.float64)
    ops, rho_vec, m_mats = _operands(lazy)
    t_ops = t_admm._kkt_kernel_operands(t_lazy, _t(rho_vec), SIGMA, MU)
    for got, want in zip(t_ops, ops):        # the operand builder too
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-13, atol=0)
    c3 = j_admm._scaled_schulz_coeffs(1e-3)
    c4 = j_admm._scaled_schulz_coeffs(1e-4)
    conv = jax.vmap(lambda m: j_admm._schulz_inverse(m, 0, coeffs=c4))(
        m_mats)
    x0 = _warm_start(conv)
    if variant == "cold":
        want = jax.vmap(lambda m: j_admm._schulz_inverse(m, 0, coeffs=c3))(
            m_mats)
        got = kkt_schulz.kkt_schulz(*t_ops, coeffs=c3)
    elif variant == "warm":
        want = jax.vmap(lambda m, x: j_admm._schulz_inverse(m, 1, x))(
            m_mats, x0)
        got = kkt_schulz.kkt_schulz(*t_ops, x0=_t(x0), coeffs=(1.0,))
    else:
        want = jax.vmap(lambda m, x: j_admm._schulz_inverse(
            m, 0, x, coeffs=c4))(m_mats, x0)
        got = kkt_schulz.kkt_schulz(*t_ops, x0=_t(x0), coeffs=c4)
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-9 * scale, rtol=0)


def _warm0(lazy):
    n, m = lazy.gradient.shape[-1], lazy.lb.shape[-1]
    return j_admm.WarmState(x=jnp.zeros(n, lazy.gradient.dtype),
                            y=jnp.zeros(m, lazy.gradient.dtype),
                            rho=jnp.asarray(0.05, lazy.gradient.dtype),
                            minv=jnp.eye(n, dtype=lazy.gradient.dtype))


def _port_chain(t_lazy, impl):
    """The port's segmented transition solve and the warm tick after it."""
    t_cold = t_admm.ADMMSettings(schulz_impl=impl, **COLD)
    t_warm = t_admm.ADMMSettings(schulz_impl=impl, **WARM)
    batch = t_lazy.gradient.shape[0]
    w0 = t_admm.WarmState(
        x=torch.zeros_like(t_lazy.gradient), y=torch.zeros_like(t_lazy.lb),
        rho=torch.full((batch,), 0.05, dtype=t_lazy.gradient.dtype),
        minv=torch.eye(120, dtype=t_lazy.gradient.dtype).expand(
            batch, 120, 120).contiguous())
    sol_c, w = t_admm.solve_segmented_fused(t_lazy, t_cold, MU, w0)
    sol_w, w2 = t_admm.mpc_solve_warm_fused(t_lazy, w, t_warm, mu=MU)
    return sol_c, w, sol_w, w2


def _solve_pair(dtype):
    """(JAX, port) results of a segmented transition solve followed by a
    warm tick from its carry, on the same lazy QPs."""
    lazy, t_lazy = _lazies(dtype)
    j_cold = j_admm.ADMMSettings(schulz_impl="auto", **COLD)
    j_warm = j_admm.ADMMSettings(schulz_impl="auto", **WARM)

    def jax_chain(lz):
        sol_c, w = j_admm.solve_segmented_fused(lz, j_cold, MU, _warm0(lz))
        sol_w, w2 = j_admm.mpc_solve_warm_fused(lz, w, j_warm, mu=MU)
        return sol_c, w, sol_w, w2

    j_out = jax.vmap(jax_chain)(lazy)
    return j_out, _port_chain(t_lazy, "auto")


def test_solves_match_jax_f64():
    """Float64: the segmented cold solve and the warm tick after it equal
    the JAX programs (whose CPU route is the XLA one) to round-off; the
    port's K1 route takes the plain K1 on the CPU."""
    j_out, t_out = _solve_pair(jnp.float64)
    for j_res, t_res in zip(j_out, t_out):
        for name, got, want in zip(t_res._fields, t_res, j_res):
            want = np.asarray(want)
            scale = max(1.0, np.abs(want).max())
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-8 * scale, err_msg=name)


def test_solves_match_jax_f32():
    j_out, t_out = _solve_pair(jnp.float32)
    for j_res, t_res in zip(j_out, t_out):
        np.testing.assert_allclose(t_res.x.numpy(), np.asarray(j_res.x),
                                   atol=2e-1, rtol=0)


def test_every_schulz_impl_takes_the_k1_route():
    """The JAX package's three schulz_impl names are accepted and give the
    same solves (one route, K1); any other name is refused."""
    _, t_lazy = _lazies(jnp.float64, batch=2)
    want = _port_chain(t_lazy, "auto")
    for impl in ("pallas", "xla"):
        for t_res, w_res in zip(_port_chain(t_lazy, impl), want):
            for name, got, w in zip(t_res._fields, t_res, w_res):
                assert torch.equal(got, w), (impl, name)
    with pytest.raises(ValueError):
        _port_chain(t_lazy, "cublas")


def test_k1_wrapper_checks_inputs():
    """A CUDA launch needs float32 (B, 4, 12, 120) etc.; an empty schedule
    is refused on every device."""
    _, t_lazy = _lazies(jnp.float64, batch=2)
    eq = torch.isclose(t_lazy.lb, t_lazy.ub)
    rho_vec = torch.where(eq, 50.0, 0.05).to(torch.float64)
    ops = t_admm._kkt_kernel_operands(t_lazy, rho_vec, SIGMA, MU)
    with pytest.raises(ValueError):
        kkt_schulz.kkt_schulz(*ops, coeffs=())

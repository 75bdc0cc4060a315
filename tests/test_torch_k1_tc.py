"""PyTorch port, K1's precision schedule and routes.

On the card K1 runs the steps before the last ``hi_tail`` as 3xTF32
tensor-core products (``csrc/schulz_tc.cuh``, as K3 does) and the tail,
the basin test and the accepted warm step in FP32; its plain version
takes the middle products from ``kkt_schulz.matmul_3xtf32`` when asked
(``middle_matmul``). Here, on the CPU:

- the emulated K1 schedule against ``pallas_admm.schulz_inverse_kkt_batch
  (..., interpret=True)`` (bf16x3 middles, emulated too) on random sweep
  scenarios' lazy factors, cold and warm, at ``hi_tail`` 0, 1 and 2:
  within 3e-4 x max|X| (tests/test_pallas_admm.py:287-302's tolerance)
  and a balanced residual max|M_b X_b - I| below 1e-4 (as for K3);
- the three fused solvers hand ``ADMMSettings.schulz_hi_tail`` to K1;
- ``kkt_schulz.route`` picks the one-block tensor-core route for
  schedules with a 3xTF32 step and the FP32 body for those without;
- with the defaults, ``kkt_schulz`` computes what it did before.
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
TF32 = kkt_schulz.matmul_3xtf32
SIGMA = 1e-6
MU = 0.3


def _lazies(batch=4, seed=5):
    """(JAX, port) float32 lazy QPs of random sweep scenarios."""
    scn = sweep.random_scenarios(jax.random.PRNGKey(seed), batch,
                                 jnp.float32)

    def lazy_of(s):
        a_c = j_srb.calculate_A_c(s.x0[0:3])
        b_c = j_srb.calculate_B_c(s.mass, s.inertia, s.root_rot, s.foot_pos)
        a_d, b_d = j_srb.discretize(a_c, b_c, 0.0025)
        return j_srb.condense_nilpotent_lazy(a_d, b_d, s.x0, s.x_ref,
                                             s.q_weights, s.r_weights,
                                             s.contacts)

    lazy = jax.vmap(lazy_of)(scn)
    return lazy, t_srb.LazyCondensedQP(
        *[torch.tensor(np.asarray(a)) for a in lazy])


def _operands(lazy, rho=0.05):
    def one(lz):
        rho_vec = jnp.where(jnp.isclose(lz.lb, lz.ub), rho * 1e3, rho)
        return j_admm._kkt_kernel_operands(lz, rho_vec, SIGMA, MU)

    return tuple(jnp.asarray(a, jnp.float32) for a in jax.vmap(one)(lazy))


@pytest.fixture(scope="module")
def case():
    """K1 operands, a converged inverse of them and a warm start that
    scenario 0 fails (its negation: the scaled cold fallback)."""
    lazy, _ = _lazies()
    ops = _operands(lazy)
    conv = np.asarray(pallas_admm.schulz_inverse_kkt_batch(
        *ops, coeffs=j_admm._scaled_schulz_coeffs(1e-5), interpret=True,
        tile=2, hi_tail=12))
    rng = np.random.default_rng(0)
    x0 = (conv * (1.0 + 1e-3 * rng.normal(size=conv.shape))).astype(
        np.float32)
    x0[0] = -x0[0]
    return ops, x0


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("hi_tail", [0, 1, 2])
def test_k1_emulation_matches_the_pallas_kernel(case, start, hi_tail):
    ops, x0 = case
    x0 = x0 if start == "warm" else None
    coeffs = j_admm._scaled_schulz_coeffs(1e-3 if start == "cold" else 1e-4)
    want = np.asarray(pallas_admm.schulz_inverse_kkt_batch(
        *ops, x0=None if x0 is None else jnp.asarray(x0), coeffs=coeffs,
        interpret=True, tile=2, hi_tail=hi_tail), np.float64)
    t_ops = [torch.tensor(np.asarray(a)) for a in ops]
    got = kkt_schulz.kkt_schulz_plain(
        *t_ops, x0=None if x0 is None else torch.tensor(x0), coeffs=coeffs,
        hi_tail=hi_tail, middle_matmul=TF32)
    assert bool(torch.isfinite(got).all())
    scale = np.abs(want).max()
    assert np.abs(got.double().numpy() - want).max() < 3e-4 * scale
    # the balanced residual, in float64
    m = kkt_schulz.kkt_build_plain(*t_ops).double()
    s = torch.rsqrt(torch.diagonal(m, dim1=-2, dim2=-1))
    unb = s[:, :, None] * s[:, None, :]
    resid = ((m * unb) @ (got.double() / unb) - torch.eye(120,
                                                         dtype=m.dtype))
    assert float(resid.abs().max()) < 1e-4


def test_fused_solvers_hand_hi_tail_to_k1(monkeypatch):
    tails = []
    plain = kkt_schulz.kkt_schulz

    def record(tiled, dmain, off1, off2, cost, x0=None, coeffs=(1.0,),
               hi_tail=None):
        tails.append(hi_tail)
        return plain(tiled, dmain, off1, off2, cost, x0, coeffs, hi_tail)

    monkeypatch.setattr(kkt_schulz, "kkt_schulz", record)
    _, lazy = _lazies(batch=2)
    batch = lazy.gradient.shape[0]
    settings = t_admm.ADMMSettings(seg_iters=3, segments=2, polish=False,
                                   schulz_l0=1e-4, schulz_l0_first=1e-3,
                                   schulz_refine=1, schulz_hi_tail=1)
    w0 = t_admm.WarmState(
        x=torch.zeros_like(lazy.gradient), y=torch.zeros_like(lazy.lb),
        rho=torch.full((batch,), 0.05),
        minv=torch.eye(120).expand(batch, 120, 120).contiguous())
    _, warm = t_admm.solve_segmented_fused(lazy, settings, MU, w0)
    assert tails == [1, 1]
    tails.clear()
    t_admm.solve_warm_fused(lazy, warm, settings._replace(schulz_hi_tail=0),
                            MU)
    assert tails == [0]
    tails.clear()
    t_admm.solve_cold_fused(lazy, settings._replace(schulz_hi_tail=3), MU,
                            torch.full((batch,), 0.05))
    assert tails == [3]


C9 = (1.5,) * 9
W1 = (1.0,)


@pytest.mark.parametrize("coeffs, hi_tail, want", [
    (C9, None, "cta"),              # the wrapper's default tail of 2
    (C9, 1, "cta"),                 # the main path's cold program
    (C9, 0, "cta"),
    (C9, 8, "cta"),
    (C9, 9, "fp32"),                # the tail covers the schedule
    (C9, 12, "fp32"),               # ... and is clamped to it
    (W1, None, "fp32"),             # the steady warm tick: one FP32 step
    (W1, 1, "fp32"),
    (W1, 0, "cta"),
])
def test_route(coeffs, hi_tail, want):
    assert kkt_schulz.route(coeffs, hi_tail) == want
    assert kkt_schulz.BLOCKS[want] == {"cta": 1, "fp32": 0}[want]


def test_defaults_compute_what_they_did():
    """On the CPU ``kkt_schulz`` takes ``@`` for every product whatever
    ``hi_tail`` says, and counts no launch; the plain version emulates
    the card's middle products only when asked."""
    lazy, _ = _lazies(batch=2, seed=7)
    ops = [torch.tensor(np.asarray(a)) for a in _operands(lazy)]
    coeffs = t_admm._scaled_schulz_coeffs(1e-3)
    base = kkt_schulz.schulz_balanced_plain(kkt_schulz.kkt_build_plain(*ops),
                                            None, coeffs)
    kkt_schulz.reset_launches()
    for tail in (None, 0, 1, 5):
        assert torch.equal(kkt_schulz.kkt_schulz(*ops, coeffs=coeffs,
                                                 hi_tail=tail), base)
    assert torch.equal(kkt_schulz.kkt_schulz_plain(*ops, coeffs=coeffs),
                       base)
    assert not torch.equal(kkt_schulz.kkt_schulz_plain(
        *ops, coeffs=coeffs, hi_tail=1, middle_matmul=TF32), base)
    assert torch.equal(kkt_schulz.kkt_schulz_plain(
        *ops, coeffs=coeffs, hi_tail=len(coeffs), middle_matmul=TF32), base)
    assert kkt_schulz.launches == 0
    assert set(kkt_schulz.route_launches.values()) == {0}

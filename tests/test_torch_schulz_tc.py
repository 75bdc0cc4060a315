"""PyTorch port, the 3xTF32 schedule of K3 (n = 120) and K5.

On the card the middle steps of K3 at n = 120 and of K5 run 3xTF32
tensor-core products (``csrc/schulz_tc.cuh``); their plain versions take
the products from ``kkt_schulz.matmul_3xtf32`` when asked
(``middle_matmul``). Here, on the CPU:

- ``tf32_round`` is ``cvt.rna.tf32.f32`` bit for bit: ties away from zero,
  10 mantissa bits kept, NaN and infinity through; hi + lo rebuilds x to
  2^-21 relative;
- the emulated K3 schedule against ``pallas_admm.schulz_inverse_batch(...,
  interpret=True)`` (whose bf16x3 middles are emulated too) on the cases
  of tests/test_pallas_admm.py:89-123: within 1e-3 x max|X| and
  max|M X - I| < 1e-4 (that test's tolerances);
- the emulated K5 schedule against ``pallas_admm.schulz_balanced(...,
  interpret=True)`` on the cases of tests/test_pallas_admm.py:126-156:
  within 5e-6 (that test's tolerance);
- on float32 KKTs from a closed-loop trot (``rollout_batched``, the K1
  calls after the trot starts), the emulated schedule within 3e-4 of the
  FP32 plain version per scenario in balanced coordinates (chip_smoke's
  K3 gate): the controller's KKTs are worse conditioned than random ones,
  where a single-pass product diverges (the JAX docstrings' warning);
- with the defaults, the plain versions compute what they did before;
- the dense solvers hand ``ADMMSettings.schulz_hi_tail`` to K3, and the
  wrapper picks the cluster route up to ``CROSSOVER`` matrices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch.compat import convert
from go1_qp_mpc_controller_torch.envs import rollout as t_rollout
from go1_qp_mpc_controller_torch.models import srb as t_srb
from go1_qp_mpc_controller_torch.models import types as t_types
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_torch.ops import (admm_iterations, kkt_schulz,
                                             schulz_balanced, schulz_batch)
from go1_qp_mpc_controller_tpu.compat import oracle
from go1_qp_mpc_controller_tpu.models import srb as j_srb
from go1_qp_mpc_controller_tpu.ops import admm as j_admm
from go1_qp_mpc_controller_tpu.ops import pallas_admm

torch.set_num_threads(1)
TF32 = kkt_schulz.matmul_3xtf32


def _bits(x):
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def test_tf32_round_is_cvt_rna():
    one, big = 1.0, torch.finfo(torch.float32).max
    x = torch.tensor([one, one + 2 ** -11, one + 2 ** -10 + 2 ** -11,
                      -(one + 2 ** -11), one + 2 ** -12, one + 3 * 2 ** -12,
                      big, -big, 1e-40, -0.0], dtype=torch.float32)
    want = [one, one + 2 ** -10, one + 2 ** -9, -(one + 2 ** -10), one,
            one + 2 ** -10, np.inf, -np.inf, None, -0.0]
    got = kkt_schulz.tf32_round(x)
    for g, w in zip(got.tolist()[:8], want[:8]):
        assert g == w
    # ties away from zero, past the largest TF32 to infinity; a subnormal
    # keeps its top 10 mantissa bits
    assert int(_bits(got[8:9])) == (int(_bits(x[8:9])) + 0x1000) & 0xFFFFE000
    assert int(_bits(got[9:10])) == 0x80000000
    special = torch.tensor([np.nan, np.inf, -np.inf])
    out = kkt_schulz.tf32_round(special)
    assert torch.isnan(out[0]) and out[1] == np.inf and out[2] == -np.inf


def test_tf32_split_rebuilds_x():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=4096) * np.exp(rng.uniform(-20, 20, 4096)),
                     dtype=torch.float32)
    hi = kkt_schulz.tf32_round(x)
    lo = kkt_schulz.tf32_round(x - hi)
    assert int((_bits(hi) & 0x1FFF).max()) == 0       # 10 mantissa bits
    assert int((_bits(lo) & 0x1FFF).max()) == 0
    assert float(((hi - x) / x).abs().max()) <= 2.0 ** -11
    rel = ((hi.double() + lo.double() - x.double()) / x.double()).abs()
    assert float(rel.max()) <= 2.0 ** -21


def test_matmul_3xtf32_is_near_float64():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(2, 3, 120, 120))
    got = TF32(torch.tensor(a, dtype=torch.float32),
               torch.tensor(b, dtype=torch.float32)).double().numpy()
    want = a.astype(np.float32).astype(np.float64) @ b.astype(
        np.float32).astype(np.float64)
    # a float32 product of these sums is ~1e-6 off float64; the three
    # passes keep that (a single TF32 pass is ~1e-3 off)
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def _k3_cases():
    """tests/test_pallas_admm.py:89-123's matrices, schedule and starts."""
    rng = np.random.default_rng(3)
    b, n = 8, 120
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    m = a @ a.transpose(0, 2, 1) / n + 3.0 * np.eye(n, dtype=np.float32)
    coeffs = j_admm._scaled_schulz_coeffs(1e-6)
    x_ref = np.asarray(jax.vmap(lambda mm: j_admm._schulz_inverse(
        mm, 0, coeffs=coeffs))(jnp.asarray(m)))
    x0 = x_ref * (1.0 + 1e-3)
    x0_mix = x0.copy()
    x0_mix[::2] = 5.0
    return m, coeffs, {"cold": None, "warm": x0, "mixed": x0_mix}


@pytest.mark.parametrize("case", ["cold", "warm", "mixed"])
def test_k3_emulation_matches_the_pallas_kernel(case):
    m, coeffs, starts = _k3_cases()
    x0 = starts[case]
    want = np.asarray(pallas_admm.schulz_inverse_batch(
        jnp.asarray(m), 0, x0=None if x0 is None else jnp.asarray(x0),
        coeffs=coeffs, interpret=True), np.float64)
    got = kkt_schulz.schulz_balanced_plain(
        torch.tensor(m), None if x0 is None else torch.tensor(x0), coeffs,
        hi_tail=schulz_batch.default_hi_tail(coeffs),
        middle_matmul=TF32).double().numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-3 * scale
    resid = np.abs(np.einsum("bij,bjk->bik", m.astype(np.float64), got)
                   - np.eye(120)).max()
    assert resid < 1e-4, resid


def _balanced_case():
    """tests/test_pallas_admm.py:126-156's balanced matrix (float64 under
    the tests' x64 setting; the emulation takes it in float32)."""
    n = 120
    a = jax.random.normal(jax.random.PRNGKey(0), (n, n), jnp.float32)
    m = a @ a.T / n + 3.0 * jnp.eye(n)
    s = jax.lax.rsqrt(jnp.diagonal(m))
    return m * s[:, None] * s[None, :]


@pytest.mark.parametrize("case", ["cold", "warm_accept", "warm_reject",
                                  "accept_0_steps", "reject_0_steps"])
def test_k5_emulation_matches_the_pallas_kernel(case):
    mb = _balanced_case()
    cold = pallas_admm.schulz_balanced(mb, 20, interpret=True)
    iters, x0 = {"cold": (20, None),
                 "warm_accept": (4, cold * (1.0 + 1e-3)),
                 "warm_reject": (20, jnp.full(mb.shape, 5.0)),
                 "accept_0_steps": (0, cold * (1.0 + 1e-3)),
                 "reject_0_steps": (0, jnp.full(mb.shape, 5.0))}[case]
    want = np.asarray(pallas_admm.schulz_balanced(mb, iters, x0_b=x0,
                                                  interpret=True))
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    got = schulz_balanced.schulz_balanced_plain(
        f32(mb), iters, None if x0 is None else f32(x0), middle_matmul=TF32)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-6, rtol=0)
    if case == "cold":
        resid = np.abs(np.asarray(mb) @ got.numpy() - np.eye(120)).max()
        assert resid < 1e-5


def _trot_kkt_calls(ticks=90, walk_from=20):
    """The K1 calls of a float32 closed-loop trot at batch 3 (perturbed
    starts), from the tick the trot starts: (M, x0, coeffs) with M the
    materialized KKT."""
    model = t_types.default_robot_model(torch.float32, "cpu")
    params = t_types.default_ctrl_params(torch.float32, "cpu")
    carry = t_rollout.init_carry(model, params, 3, dtype=torch.float32,
                                 device="cpu")
    rng = np.random.default_rng(2)
    sim = carry.sim._replace(root_lin_vel=carry.sim.root_lin_vel
                             + torch.tensor(0.01 * rng.normal(size=(3, 3)),
                                            dtype=torch.float32))
    carry = carry._replace(sim=sim)
    calls, tick = [], [0]
    plain = kkt_schulz.kkt_schulz

    def record(tiled, dmain, off1, off2, cost, x0=None, coeffs=(1.0,),
               hi_tail=None):
        if tick[0] >= walk_from:
            calls.append((kkt_schulz.kkt_build_plain(tiled, dmain, off1, off2,
                                                     cost), x0, coeffs))
        return plain(tiled, dmain, off1, off2, cost, x0, coeffs, hi_tail)

    def command(i, ctrl):
        tick[0] = i
        walk = i >= walk_from
        vel = torch.zeros_like(ctrl.root_lin_vel_d)
        vel[:, 0] = 0.3 if walk else 0.0
        return ctrl._replace(
            movement_mode=torch.full_like(ctrl.movement_mode, int(walk)),
            root_lin_vel_d=vel)

    settings = t_admm.ADMMSettings(
        seg_iters=30, segments=2, first_seg_iters=20, polish=False,
        schulz_l0=1e-6, schulz_l0_first=1e-3, schulz_l0_refine=1e-4,
        schulz_hi_tail=1)
    mp = pytest.MonkeyPatch()
    mp.setattr(kkt_schulz, "kkt_schulz", record)
    try:
        t_rollout.rollout_batched(carry, model, params, ticks, 0.002,
                                  settings=settings, command_fn=command)
    finally:
        mp.undo()
    return calls


@pytest.mark.parametrize("hi_tail", [0, 1, 2])
def test_emulation_on_controller_kkts(hi_tail):
    calls = _trot_kkt_calls()
    long = [c for c in calls if len(c[2]) > 2]
    assert len(long) >= 3 and any(c[1] is None for c in long)
    worst = 0.0
    for m, x0, coeffs in long:
        want = kkt_schulz.schulz_balanced_plain(m, x0, coeffs)
        got = kkt_schulz.schulz_balanced_plain(m, x0, coeffs, hi_tail, TF32)
        assert bool(torch.isfinite(got).all())
        s = torch.rsqrt(torch.diagonal(m, dim1=-2, dim2=-1))
        unb = s[:, :, None] * s[:, None, :]
        err = (((got - want) / unb).abs().amax((1, 2))
               / (want / unb).abs().amax((1, 2)))
        worst = max(worst, float(err.max()))
    assert worst <= 3e-4, worst


def test_defaults_compute_what_they_did():
    """Without ``middle_matmul`` the plain versions take ``@`` for every
    product whatever ``hi_tail`` says (K1's and K4's plain versions keep
    their numbers)."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(2, 40, 40))
    m = torch.tensor(a @ a.transpose(0, 2, 1) / 40 + 3 * np.eye(40),
                     dtype=torch.float32)
    coeffs = t_admm._scaled_schulz_coeffs(1e-4)
    base = kkt_schulz.schulz_balanced_plain(m, None, coeffs)
    for tail in (None, 0, 1, 5):
        assert torch.equal(
            kkt_schulz.schulz_balanced_plain(m, None, coeffs, tail), base)
    assert not torch.equal(kkt_schulz.schulz_balanced_plain(
        m, None, coeffs, 1, TF32), base)
    assert torch.equal(kkt_schulz.schulz_balanced_plain(
        m, None, coeffs, len(coeffs), TF32), base)


def test_routes_and_default_tail():
    c20 = (1.0,) * 20
    assert schulz_batch.route(120, 1, c20) == "cluster"
    assert schulz_batch.route(120, schulz_batch.CROSSOVER, c20) == "cluster"
    assert schulz_batch.route(120, schulz_batch.CROSSOVER + 1, c20) == "cta"
    assert schulz_batch.route(12, 1, c20) == "n12"
    # no 3xTF32 step left: the FP32 body, at any batch
    for coeffs, tail in (((1.0,), None), ((), None), (c20, 20),
                        ((1.0,) * 3, 5)):
        assert schulz_batch.route(120, 4096, coeffs, tail) == "fp32"
    assert schulz_batch.route(120, 4096, (1.0,) * 3) == "cta"
    assert schulz_batch.default_hi_tail((1.0,) * 20) == 2
    assert schulz_batch.default_hi_tail((1.0,)) == 1
    assert schulz_batch.default_hi_tail(()) == 0
    assert schulz_batch.default_hi_tail((1.0,) * 6, 1) == 1
    schulz_batch.reset_launches()
    schulz_batch.schulz_inverse_batch(torch.eye(120)[None] * 2.0,
                                      coeffs=(1.0,) * 3, hi_tail=1)
    assert schulz_batch.launches == 0
    assert set(schulz_batch.route_launches.values()) == {0}


def _fixture_qp(batch=2, seed=0):
    """The test_mpc.cpp fixture QP at ``batch`` perturbed start states, in
    float32."""
    f = oracle.test_mpc_fixture()
    rng = np.random.default_rng(seed)
    x0s = np.tile(f["x0"], (batch, 1))
    x0s[:, 5] += rng.uniform(-0.02, 0.02, batch)
    f32 = jnp.float32
    qps = jax.vmap(lambda x0: j_srb.condense(
        jnp.asarray(f["a_d"], f32), jnp.asarray(f["b_d_list"], f32), x0,
        jnp.asarray(f["x_ref"], f32).reshape(10, 13),
        jnp.asarray(f["q_weights"], f32), jnp.asarray(f["r_weights"], f32),
        jnp.asarray(f["contacts"], f32)))(jnp.asarray(x0s, f32))
    return convert.from_numpy(t_srb.CondensedQP,
                              jax.tree.map(np.asarray, qps),
                              torch.device("cpu"), torch.float32)


def test_dense_solvers_hand_hi_tail_to_k3(monkeypatch):
    tails = []
    plain = schulz_batch.schulz_inverse_batch

    def record(m, x0=None, coeffs=(1.0,), hi_tail=None):
        tails.append(hi_tail)
        return plain(m, x0, coeffs, hi_tail)

    monkeypatch.setattr(schulz_batch, "schulz_inverse_batch", record)
    qp = _fixture_qp()
    settings = t_admm.ADMMSettings(polish=False, segments=2, seg_iters=5,
                                   schulz_refine=3, schulz_hi_tail=1)
    sol, warm = t_admm.mpc_solve(qp, settings, return_warm=True)
    assert tails and set(tails) == {1}
    tails.clear()
    t_admm.mpc_solve_warm(qp, warm, settings)
    assert tails == [1]
    tails.clear()
    admm_iterations.mpc_solve_warm_batch(
        qp, warm, torch.full((2,), 0.3), settings._replace(schulz_hi_tail=0))
    assert tails == [0]
    tails.clear()
    t_admm._schulz_inverse(qp.hessian + torch.eye(120), 4)
    assert tails == [2]

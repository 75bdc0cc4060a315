"""PyTorch port, the condensation variants of ``models/srb.py``: the general
block recursion ``condense``, its nilpotent closed form, the block-Toeplitz
form, the dense constraint matrix, the averaged-euler linearization, the
receding per-step B and the reference trajectory at any horizon, held
against the JAX package on the same seeded numpy inputs (float64, the two
packages compute the same formulas: 1e-12 on the QPs, stated per check),
and against each other as tests/test_srb_condensation.py holds them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch.models import srb as t_srb
from go1_qp_mpc_controller_tpu.compat import oracle
from go1_qp_mpc_controller_tpu.models import srb as j_srb

torch.set_num_threads(1)
F64 = torch.float64
BATCH = 4


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _inputs(seed, per_step=True):
    """A batch of scenarios around the oracle fixture: per-step B (the
    receding footholds of distinct velocities) or one B shared across the
    horizon, seeded x0 / x_ref / weight perturbations."""
    f = oracle.test_mpc_fixture()
    rng = np.random.default_rng(seed)
    b_list, x0, x_ref, q, r = [], [], [], [], []
    for _ in range(BATCH):
        vel = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.3, 0.3), 0.0])
        b = oracle.receding_b_d_list(f["mass"], f["inertia"], f["rot"],
                                     f["foot_pos"], vel, f["dt"])
        b_list.append(b if per_step else np.broadcast_to(b[0], b.shape))
        x0.append(f["x0"] + 0.01 * rng.normal(size=13))
        x_ref.append(f["x_ref"].reshape(10, 13)
                     + 0.01 * rng.normal(size=(10, 13)))
        q.append(f["q_weights"] * rng.uniform(0.5, 1.5, 13))
        r.append(f["r_weights"] * rng.uniform(0.5, 1.5, 12))
    contacts = np.array([[1, 1, 1, 1], [1, 0, 0, 1], [0, 1, 1, 0],
                         [1, 1, 1, 0]], np.float64)
    a_d = np.broadcast_to(f["a_d"], (BATCH, 13, 13))
    return dict(a_d=a_d, b=np.stack(b_list), x0=np.stack(x0),
                x_ref=np.stack(x_ref), q=np.stack(q), r=np.stack(r),
                contacts=contacts)


def _jax_qps(fn, inp, b):
    return [fn(jnp.asarray(inp["a_d"][i]), jnp.asarray(b[i]),
               jnp.asarray(inp["x0"][i]), jnp.asarray(inp["x_ref"][i]),
               jnp.asarray(inp["q"][i]), jnp.asarray(inp["r"][i]),
               jnp.asarray(inp["contacts"][i])) for i in range(BATCH)]


def _torch_qp(fn, inp, b):
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=F64)
    return fn(t(inp["a_d"]), t(b), t(inp["x0"]), t(inp["x_ref"]),
              t(inp["q"]), t(inp["r"]), torch.as_tensor(inp["contacts"]))


def _hold(got, want_list, atol):
    for i, want in enumerate(want_list):
        _close(got.hessian[i], want.hessian, atol)
        _close(got.gradient[i], want.gradient, atol)
        _close(got.lb[i], want.lb, 0)
        _close(got.ub[i], want.ub, 0)


@pytest.mark.parametrize("name", ["condense", "condense_nilpotent"])
def test_per_step_condensation_matches_jax(name):
    """The per-step-B condensations against JAX's on the same inputs, per
    scenario weights, four contact patterns (1e-12 on the QP; the Hessian
    entries reach ~1e2)."""
    inp = _inputs(0)
    got = _torch_qp(getattr(t_srb, name), inp, inp["b"])
    _hold(got, _jax_qps(getattr(j_srb, name), inp, inp["b"]), 1e-12)


def test_toeplitz_condensation_matches_jax():
    """``condense_toeplitz`` (one B shared across the horizon) against
    JAX's (1e-12)."""
    inp = _inputs(1, per_step=False)
    b0 = inp["b"][:, 0]
    got = _torch_qp(t_srb.condense_toeplitz, inp, b0)
    _hold(got, _jax_qps(j_srb.condense_toeplitz, inp, b0), 1e-12)


@pytest.mark.parametrize("name", ["condense_toeplitz",
                                  "condense_nilpotent_const"])
def test_shared_b_forms_match_general(name):
    """The shared-B forms equal the general recursion over a broadcast
    per-step B (tests/test_srb_condensation.py:133-203, 1e-12)."""
    inp = _inputs(2, per_step=False)
    general = _torch_qp(t_srb.condense, inp, inp["b"])
    got = _torch_qp(getattr(t_srb, name), inp, inp["b"][:, 0])
    _close(got.hessian, general.hessian, 1e-12)
    _close(got.gradient, general.gradient, 1e-12)
    finite = torch.isfinite(general.lb)
    _close(got.lb[finite], general.lb[finite], 0)


def test_nilpotent_matches_general_and_oracle():
    """The nilpotent closed form equals the general recursion on per-step
    B (1e-12), and both equal the float64 NumPy oracle (1e-9, the oracle's
    gate in tests/test_srb_condensation.py)."""
    inp = _inputs(3)
    general = _torch_qp(t_srb.condense, inp, inp["b"])
    nilp = _torch_qp(t_srb.condense_nilpotent, inp, inp["b"])
    _close(nilp.hessian, general.hessian, 1e-12)
    _close(nilp.gradient, general.gradient, 1e-12)
    for i in range(BATCH):
        ref = oracle.condense(inp["a_d"][i], inp["b"][i], inp["x0"][i],
                              inp["x_ref"][i].reshape(-1), inp["q"][i],
                              inp["r"][i], inp["contacts"][i])
        _close(general.hessian[i], ref.hessian, 1e-9)
        _close(general.gradient[i], ref.gradient, 1e-9)


def test_lazy_condensation_takes_per_scenario_weights():
    """(B, 13) / (B, 12) weights through ``condense_nilpotent_lazy`` equal
    one (13,) / (12,) weight vector per scenario, bit for bit (the sweep
    carries its weights per scenario)."""
    inp = _inputs(4, per_step=False)
    q = np.broadcast_to(inp["q"][0], inp["q"].shape)
    r = np.broadcast_to(inp["r"][0], inp["r"].shape)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=F64)
    common = (t(inp["a_d"]), t(inp["b"][:, 0]), t(inp["x0"]),
              t(inp["x_ref"]))
    contacts = torch.as_tensor(inp["contacts"])
    per = t_srb.condense_nilpotent_lazy(*common, t(q), t(r), contacts)
    shared = t_srb.condense_nilpotent_lazy(*common, t(inp["q"][0]),
                                           t(inp["r"][0]), contacts)
    for a, b in zip(per, shared):
        assert torch.equal(a, b)


def test_constraint_matrix_dense_matches_jax_and_operators():
    """The materialized pyramid equals JAX's and the matrix-free
    operators (exact)."""
    c = t_srb.constraint_matrix_dense()
    _close(c, j_srb.constraint_matrix_dense(), 0)
    u = torch.as_tensor(np.random.default_rng(5).normal(size=120))
    _close(t_srb.constraint_matvec(u), c @ u, 1e-14)


def test_receding_variant_matches_jax():
    """``averaged_euler`` and ``receding_b_d_list`` against JAX's on a
    batch of nonzero velocities (1e-13), and the recession matters."""
    rng = np.random.default_rng(6)
    f = oracle.test_mpc_fixture()
    euler = 0.2 * rng.normal(size=(BATCH, 3))
    ang = 0.4 * rng.normal(size=(BATCH, 3))
    feet = f["foot_pos"] + 0.02 * rng.normal(size=(BATCH, 4, 3))
    vel = rng.uniform(-0.5, 0.5, (BATCH, 3))
    rot = np.stack([oracle.rot_z(y) for y in euler[:, 2]])
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=F64)
    got_e = t_srb.averaged_euler(t(euler), t(ang), f["dt"])
    got_b = t_srb.receding_b_d_list(t(f["mass"]), t(f["inertia"]), t(rot),
                                    t(feet), t(vel), f["dt"])
    for i in range(BATCH):
        _close(got_e[i], j_srb.averaged_euler(
            jnp.asarray(euler[i]), jnp.asarray(ang[i]), f["dt"]), 1e-14)
        _close(got_b[i], j_srb.receding_b_d_list(
            jnp.asarray(f["mass"]), jnp.asarray(f["inertia"]),
            jnp.asarray(rot[i]), jnp.asarray(feet[i]),
            jnp.asarray(vel[i]), f["dt"]), 1e-13)
    assert float((got_b[:, 9] - got_b[:, 0]).abs().max()) > 1e-5


@pytest.mark.parametrize("horizon", [10, 40])
def test_reference_trajectory_horizon_matches_jax(horizon):
    """``reference_trajectory(horizon=)`` against JAX's (1e-13)."""
    rng = np.random.default_rng(7)
    vals = [rng.normal(size=(BATCH, 3)) for _ in range(6)]
    got = t_srb.reference_trajectory(
        *[torch.as_tensor(v) for v in vals], 0.0025, horizon=horizon)
    assert got.shape == (BATCH, horizon, 13)
    for i in range(BATCH):
        _close(got[i], j_srb.reference_trajectory(
            *[jnp.asarray(v[i]) for v in vals], 0.0025, horizon=horizon),
            1e-13)

"""PyTorch port, the single-GPU scenario sweep (``parallel/sweep.py``):
``random_scenarios`` bit-equal to the JAX package's for the same seed,
both solve routes of ``make_sweep_fn`` against the JAX sweep on a
one-device mesh (float64, GRFs within 1e-6 N), ``run_chunked`` against one
shot, and ``main.py sweep``'s JSON keys.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch import main as t_main
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_torch.parallel import sweep as t_sweep
from go1_qp_mpc_controller_tpu.ops import admm as j_admm
from go1_qp_mpc_controller_tpu.parallel import mesh as j_mesh
from go1_qp_mpc_controller_tpu.parallel import sweep as j_sweep

torch.set_num_threads(1)
GRF_TOL = 1e-6    # N, float64
ROUTES = {
    # one segment, no polish: the fused cold program (K1, K6 on the card)
    "fused_cold": dict(seg_iters=40, segments=1, polish=False),
    # main.py sweep's settings: the dense polished solve (K3, K6)
    "dense": dict(seg_iters=25, segments=3),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_random_scenarios_bit_equal_to_jax(seed, dtype):
    got = t_sweep.random_scenarios(seed, 64, getattr(torch, dtype), "cpu")
    want = j_sweep.random_scenarios(jax.random.PRNGKey(seed), 64,
                                    getattr(jnp, dtype))
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        assert g.shape == w.shape, name
        assert np.array_equal(g.numpy(), w), name


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sweep_routes_match_jax(route):
    """Each route of ``make_sweep_fn`` against JAX's ``make_sweep_fn`` on
    a one-device mesh, batch 24, float64: GRFs and the whole horizon's
    forces within 1e-6 N, residuals within 1e-9 relative, the same
    stats."""
    batch = 24
    settings = ROUTES[route]
    scn_t = t_sweep.random_scenarios(3, batch, torch.float64, "cpu")
    got = t_sweep.make_sweep_fn("cpu", 0.0025,
                                t_admm.ADMMSettings(**settings))(scn_t)
    mesh = j_mesh.make_mesh(mpc_parallel=1, devices=jax.devices()[:1])
    want = j_sweep.make_sweep_fn(mesh, 0.0025,
                                 j_admm.ADMMSettings(**settings))(
        j_sweep.random_scenarios(jax.random.PRNGKey(3), batch, jnp.float64))
    np.testing.assert_allclose(got.grf.numpy(), np.asarray(want.grf),
                               atol=GRF_TOL, rtol=0)
    np.testing.assert_allclose(got.forces_all.numpy(),
                               np.asarray(want.forces_all), atol=GRF_TOL,
                               rtol=0)
    for name in ("primal_res", "dual_res"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w,
                                   atol=1e-9 * max(1.0, np.abs(w).max()),
                                   rtol=0, err_msg=name)
    assert got.stats["num_solves"] == float(want.stats["num_solves"])
    np.testing.assert_allclose(float(got.stats["max_primal_res"]),
                               float(want.stats["max_primal_res"]),
                               rtol=1e-9, atol=1e-12)


def test_sweep_solutions_are_physical():
    """The physical bars of tests/test_sharding.py:59-82 on the port's
    dense sweep (75 x 5 iterations, batch 32, float64)."""
    scn = t_sweep.random_scenarios(0, 32, torch.float64, "cpu")
    out = t_sweep.make_sweep_fn(
        "cpu", 0.0025, t_admm.ADMMSettings(seg_iters=75, segments=5))(scn)
    grf = out.grf.numpy()
    contacts = scn.contacts.numpy()
    mu = scn.mu.numpy()
    assert np.abs(grf[~contacts]).max() < 0.1
    fz = grf[..., 2]
    assert np.all(fz > -0.05)
    assert np.all(np.abs(grf[..., 0]) <= mu[:, None] * fz + 0.1)
    assert np.all(np.abs(grf[..., 1]) <= mu[:, None] * fz + 0.1)
    assert np.all(fz.sum(-1) > 0.2 * scn.mass.numpy() * 9.8)


def test_chunked_sweep_matches_single_shot():
    """``run_chunked`` over two chunks equals one shot (1e-12 in float64;
    tests/test_sharding.py:85-97), stats aggregated as floats."""
    scn = t_sweep.random_scenarios(0, 32, torch.float64, "cpu")
    fn = t_sweep.make_sweep_fn("cpu", 0.0025, t_admm.ADMMSettings(
        seg_iters=10, segments=1, polish=False))
    one = fn(scn)
    chunked = t_sweep.run_chunked(fn, scn, 16)
    np.testing.assert_allclose(chunked.grf.numpy(), one.grf.numpy(),
                               atol=1e-12, rtol=0)
    assert chunked.stats["num_solves"] == 32.0
    assert chunked.stats["max_primal_res"] == float(
        one.stats["max_primal_res"])
    with pytest.raises(ValueError):
        t_sweep.run_chunked(fn, scn, 12)


def test_sweep_refuses_scenarios_on_another_device():
    scn = t_sweep.random_scenarios(0, 2, torch.float32, "cpu")
    fn = t_sweep.make_sweep_fn("cpu", 0.0025)
    with pytest.raises(ValueError):
        fn(scn._replace(x0=scn.x0.to("meta")))


def test_main_sweep_prints_jax_keys(capsys):
    """``main.py sweep`` prints the JAX sweep's JSON keys, with finite
    residuals and one solve a scenario."""
    t_main.main(["--device", "cpu", "--preset", "gazebo_mpc", "sweep",
                 "--batch", "32"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"num_solves", "max_primal_res", "max_dual_res",
                        "mesh"}
    assert out["num_solves"] == 32.0
    assert out["mesh"] == {"data": 1, "mpc": 1}
    assert np.isfinite([out["max_primal_res"], out["max_dual_res"]]).all()

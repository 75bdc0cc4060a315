"""PyTorch port, the last small pieces held against the JAX package on
the same numpy-seeded float64 inputs:

- ``models/kinematics.py``: ``dfk_drho``, ``dJ_dq``, ``dJ_drho`` (the
  column-major vec of J as (..., 9, 3)), ``foot_jacobians`` and the
  calibration sizes, within 1e-12;
- ``utils/rotations.py::pseudo_inverse_3x3`` (regular and rank-deficient
  matrices) and ``utils/filters.py::moving_window_update_if`` (one gate
  for all filters, and a gate per row against JAX's vmapped filter),
  within 1e-12;
- ``ops/ekf.py``: the ``innovation_solver="chol"`` route against JAX's
  (1e-10); the JAX parameter order, positional (``innovation_solver`` is
  the twelfth parameter, ``contact_force_norm`` the thirteenth);
  ``EKFResult`` from ``update_estimation`` and ``correct``;
- ``config/params.py`` and ``compat/oracle.py`` equal to the JAX
  package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch.compat import oracle as t_oracle
from go1_qp_mpc_controller_torch.config import params as t_params
from go1_qp_mpc_controller_torch.models import kinematics as t_kin
from go1_qp_mpc_controller_torch.ops import ekf as t_ekf
from go1_qp_mpc_controller_torch.utils import filters as t_filters
from go1_qp_mpc_controller_torch.utils import rotations as t_rot
from go1_qp_mpc_controller_tpu.compat import oracle as j_oracle
from go1_qp_mpc_controller_tpu.config import params as j_params
from go1_qp_mpc_controller_tpu.models import kinematics as j_kin
from go1_qp_mpc_controller_tpu.ops import ekf as j_ekf
from go1_qp_mpc_controller_tpu.utils import filters as j_filters
from go1_qp_mpc_controller_tpu.utils import rotations as j_rot

torch.set_num_threads(1)
TOL = 1e-12
EKF_TOL = 1e-10
DT = 0.002


def _legs(batch, seed):
    """(batch, 4, 3) joint angles near the stand pose and (4, 3) random
    contact calibration offsets, with the A1 geometry."""
    rng = np.random.default_rng(seed)
    q = np.tile([0.0, 0.8, -1.6], (batch, 4, 1)) + 0.3 * rng.normal(
        size=(batch, 4, 3))
    rho_opt = 0.01 * rng.normal(size=(4, 3))
    rho_fix = np.asarray(j_kin.a1_leg_geometry(jnp.float64).rho_fix)
    return q, rho_opt, rho_fix


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=tol * max(1.0, np.abs(want).max()),
                               rtol=0)


@pytest.mark.parametrize("name", ["dfk_drho", "dJ_dq", "dJ_drho", "fk",
                                  "jac"])
def test_kinematics_matches_jax(name):
    q, rho_opt, rho_fix = _legs(6, 0)
    got = getattr(t_kin, name)(*[torch.tensor(a) for a in
                                 (q, rho_opt, rho_fix)])
    want = getattr(j_kin, name)(*[jnp.asarray(a) for a in
                                  (q, rho_opt, rho_fix)])
    assert got.shape == want.shape
    _close(got, want)


def test_foot_jacobians_and_sizes_match_jax():
    q, rho_opt, rho_fix = _legs(5, 1)
    joints = q.reshape(5, 12)
    got = t_kin.foot_jacobians(torch.tensor(joints), t_kin.LegGeometry(
        rho_fix=torch.tensor(rho_fix), rho_opt=torch.tensor(rho_opt)))
    want = j_kin.foot_jacobians(jnp.asarray(joints), j_kin.LegGeometry(
        rho_fix=jnp.asarray(rho_fix), rho_opt=jnp.asarray(rho_opt)))
    assert got.shape == (5, 4, 3, 3)
    _close(got, want)
    assert (t_kin.RHO_OPT_SIZE, t_kin.RHO_FIX_SIZE) == (
        j_kin.RHO_OPT_SIZE, j_kin.RHO_FIX_SIZE) == (3, 5)


def test_pseudo_inverse_3x3_matches_jax():
    rng = np.random.default_rng(2)
    mats = rng.normal(size=(8, 3, 3))
    # rank 2 and rank 1: the tolerance drops the null directions
    mats[1, 2] = mats[1, 0] + mats[1, 1]
    mats[2] = np.outer(rng.normal(size=3), rng.normal(size=3))
    got = t_rot.pseudo_inverse_3x3(torch.tensor(mats))
    _close(got, j_rot.pseudo_inverse_3x3(jnp.asarray(mats)))
    # the Moore-Penrose condition A A+ A = A holds on the singular ones
    a = torch.tensor(mats)
    assert torch.allclose(a @ got @ a, a, atol=1e-12)


def test_moving_window_update_if_matches_jax():
    """A (3,)-valued filter of window 4 gated by one 0-d predicate, and
    five such filters gated a row each (against JAX's filter under vmap),
    over 9 pushes."""
    rng = np.random.default_rng(4)
    values = rng.normal(size=(9, 5, 3))
    gates = rng.uniform(size=(9, 5)) > 0.4
    one_t = t_filters.moving_window_init(4, value_shape=(3,),
                                         dtype=torch.float64)
    one_j = j_filters.moving_window_init(4, (3,), jnp.float64)
    rows_t = t_filters.moving_window_init(4, lead=(5,), value_shape=(3,),
                                          dtype=torch.float64)
    rows_j = jax.vmap(lambda _: j_filters.moving_window_init(
        4, (3,), jnp.float64))(jnp.arange(5))
    for v, g in zip(values, gates):
        one_t, avg_t = t_filters.moving_window_update_if(
            one_t, torch.tensor(v[0]), torch.tensor(g[0]))
        one_j, avg_j = j_filters.moving_window_update_if(
            one_j, jnp.asarray(v[0]), jnp.asarray(g[0]))
        _close(avg_t, avg_j)
        rows_t, ravg_t = t_filters.moving_window_update_if(
            rows_t, torch.tensor(v), torch.tensor(g))
        rows_j, ravg_j = jax.vmap(j_filters.moving_window_update_if)(
            rows_j, jnp.asarray(v), jnp.asarray(g))
        _close(ravg_t, ravg_j)
    for got, want in zip(one_t + rows_t, one_j + rows_j):
        _close(got, want)


def _ekf_args(batch, seed):
    """Seeded EKF operands (the distribution of tests/test_torch_observe_
    ekf.py), float64 numpy, unbatched order of ``update_estimation``."""
    rng = np.random.default_rng(seed)
    quat = 0.1 * rng.normal(size=(batch, 4))
    quat[:, 0] += 1.0
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    rot = np.asarray(j_rot.quat_to_rot_mat(jnp.asarray(quat)))
    q, rho_opt, rho_fix = _legs(batch, seed)
    fpr = np.asarray(j_kin.fk(jnp.asarray(q), jnp.asarray(rho_opt),
                              jnp.asarray(rho_fix)))
    x0, p0 = jax.vmap(j_ekf.init_state)(jnp.asarray(rot), jnp.asarray(fpr))
    p0 = np.asarray(p0) + 0.01 * rng.normal(size=(batch, 18, 18))
    p0 = 0.5 * (p0 + p0.transpose(0, 2, 1)) + 3.0 * np.eye(18)
    return [np.asarray(x0), p0, rot, rng.normal(size=(batch, 3)),
            0.5 * rng.normal(size=(batch, 3)), fpr,
            rng.normal(size=(batch, 4, 3)),
            120.0 * rng.uniform(size=(batch, 4)),
            (rng.uniform(size=batch) > 0.5).astype(np.int32)]


def _port_call(args, *rest, **kw):
    t = [torch.tensor(a) for a in args]
    return t_ekf.update_estimation(*t[:2], DT, *t[2:], *rest, **kw)


@pytest.mark.parametrize("flat", [True, False])
def test_ekf_chol_route_matches_jax(flat):
    args = _ekf_args(12, 5)
    got = _port_call(args, assume_flat_ground=flat, innovation_solver="chol")
    want = jax.vmap(lambda x, p, *a: j_ekf.update_estimation(
        x, p, jnp.asarray(DT), *a, assume_flat_ground=flat,
        innovation_solver="chol"))(*[jnp.asarray(a) for a in args])
    assert isinstance(got, t_ekf.EKFResult)
    assert got._fields == want._fields
    for g, w in zip(got, want):
        _close(g, w, EKF_TOL)


def test_ekf_positional_order_is_jax_order():
    """Twelve and thirteen positional arguments mean what they mean in
    JAX's ``update_estimation``: ``innovation_solver``, then
    ``contact_force_norm``."""
    args = _ekf_args(6, 6)
    chol = _port_call(args, True, "chol")
    assert isinstance(chol, t_ekf.EKFResult)
    for g, w in zip(chol, _port_call(args, innovation_solver="chol")):
        assert torch.equal(g, w)
    go1 = _port_call(args, True, "schulz", 1000.0)
    for g, w in zip(go1, _port_call(args, contact_force_norm=1000.0)):
        assert torch.equal(g, w)
    want = jax.vmap(lambda x, p, *a: j_ekf.update_estimation(
        x, p, jnp.asarray(DT), *a, True, "chol", 1000.0))(
        *[jnp.asarray(a) for a in args])
    for g, w in zip(_port_call(args, True, "chol", 1000.0), want):
        _close(g, w, EKF_TOL)
    with pytest.raises(ValueError, match="unknown innovation solver"):
        _port_call(args, True, "qr")


def test_ekf_correct_returns_ekf_result():
    args = [torch.tensor(a) for a in _ekf_args(3, 7)]
    pred = t_ekf.predict(*args[:2], DT, *args[2:])
    res = t_ekf.correct(pred, t_ekf.innovation_inverse(pred.s_mat, "plain"))
    assert isinstance(res, t_ekf.EKFResult)
    x, p, c = res                  # callers unpack it as a tuple
    assert x.shape == (3, 18) and p.shape == (3, 18, 18) and c.shape == (3, 4)


def test_params_equal_jax():
    names = lambda m: {k for k in dir(m) if k.isupper()}
    assert names(t_params) == names(j_params)
    for k in names(j_params):
        assert getattr(t_params, k) == getattr(j_params, k), k


def test_oracle_copy_equals_jax():
    public = lambda m: {k for k in dir(m) if not k.startswith("_")}
    assert public(t_oracle) == public(j_oracle)
    ft, fj = t_oracle.test_mpc_fixture(), j_oracle.test_mpc_fixture()
    assert ft.keys() == fj.keys()
    for k in fj:
        assert np.array_equal(np.asarray(ft[k]), np.asarray(fj[k])), k
    grf_t, x_t, _, info_t = t_oracle.solve_test_mpc_fixture()
    grf_j, x_j, _, info_j = j_oracle.solve_test_mpc_fixture()
    assert np.array_equal(x_t, x_j) and np.array_equal(grf_t, grf_j)
    assert info_t == info_j

"""PyTorch port, leaf modules: rotations, bezier, filters, kinematics, the
SRB condensation, the state containers and the Schulz schedule, held
against the JAX package on the same seeded numpy inputs.

Float64 throughout (tests/conftest.py enables JAX x64): the two packages
compute the same formulas, so they agree to round-off (tolerances 1e-10
to 1e-12, stated per check); the condensation is also held against the
float64 NumPy oracle at 1e-9, as tests/test_srb_condensation.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch.compat import convert
from go1_qp_mpc_controller_torch.models import kinematics as t_kin
from go1_qp_mpc_controller_torch.models import srb as t_srb
from go1_qp_mpc_controller_torch.models import types as t_types
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_torch.utils import bezier as t_bezier
from go1_qp_mpc_controller_torch.utils import filters as t_filters
from go1_qp_mpc_controller_torch.utils import rotations as t_rot
from go1_qp_mpc_controller_tpu.compat import oracle
from go1_qp_mpc_controller_tpu.models import kinematics as j_kin
from go1_qp_mpc_controller_tpu.models import srb as j_srb
from go1_qp_mpc_controller_tpu.models import types as j_types
from go1_qp_mpc_controller_tpu.ops import admm as j_admm
from go1_qp_mpc_controller_tpu.utils import bezier as j_bezier
from go1_qp_mpc_controller_tpu.utils import filters as j_filters
from go1_qp_mpc_controller_tpu.utils import rotations as j_rot

torch.set_num_threads(1)
F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.array(a))


def _dicts(tree):
    """Nested dicts of arrays from a JAX NamedTuple pytree, the layout of
    ``convert.to_numpy`` (so both flatten in the same key order)."""
    if hasattr(tree, "_asdict"):
        return {k: _dicts(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def test_rotations_match_jax():
    rng = np.random.default_rng(0)
    quat = rng.normal(size=(16, 4))
    euler = rng.normal(size=(16, 3)) * 0.7
    vec = rng.normal(size=(16, 3))
    a = rng.normal(size=(16, 3, 3)) + 3 * np.eye(3)
    pairs = [
        (t_rot.quat_to_euler(_t(quat)), j_rot.quat_to_euler(quat)),
        (t_rot.quat_to_rot_mat(_t(quat)), j_rot.quat_to_rot_mat(quat)),
        (t_rot.euler_to_rot_mat(_t(euler)), j_rot.euler_to_rot_mat(euler)),
        (t_rot.rot_z(_t(euler[:, 2])), j_rot.rot_z(euler[:, 2])),
        (t_rot.skew(_t(vec)), j_rot.skew(vec)),
        (t_rot.solve_3x3(_t(a), _t(vec)), j_rot.solve_3x3(a, vec)),
        (t_rot.cal_dihedral_angle(_t(vec), _t(euler)),
         j_rot.cal_dihedral_angle(vec, euler)),
    ]
    for got, want in pairs:
        _close(got, want, 1e-12)


def test_bezier_swing_matches_jax():
    rng = np.random.default_rng(1)
    t = rng.uniform(size=(5, 4))
    start = rng.normal(size=(5, 4, 3))
    final = rng.normal(size=(5, 4, 3))
    _close(t_bezier.swing_foot_pos(_t(t), _t(start), _t(final)),
           j_bezier.swing_foot_pos(t, start, final), 1e-12)
    _close(t_bezier.swing_foot_pos(_t(t), _t(start), _t(final), 0.2),
           j_bezier.swing_foot_pos(t, start, final, 0.2), 1e-12)


@pytest.mark.parametrize("stacked", [False, True])
def test_masked_moving_window_matches_jax(stacked):
    """The port's filters keep (batch[, legs]) leading axes; the JAX
    package vmaps the same filter over them. Ten masked pushes into a
    window of 4 (wraparound included)."""
    rng = np.random.default_rng(2)
    batch, window = 3, 4
    if stacked:
        t_state = t_filters.moving_window_init_stacked(
            4, window, (batch,), (3,), F64)
        j_one = j_filters.moving_window_init_stacked(4, window, (3,),
                                                     jnp.float64)
        lead, value = (batch, 4), (3,)
    else:
        t_state = t_filters.moving_window_init(window, (batch,), (), F64)
        j_one = j_filters.moving_window_init(window, (), jnp.float64)
        lead, value = (batch,), ()
    j_state = jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape),
                           j_one)
    if stacked:
        j_update = jax.vmap(j_filters.moving_window_update_masked)
    else:
        j_update = jax.vmap(j_filters.moving_window_update_if)
    for _ in range(10):
        v = rng.normal(size=lead + value)
        mask = rng.uniform(size=lead) > 0.3
        t_state, t_avg = t_filters.moving_window_update_masked(
            t_state, _t(v), _t(mask))
        j_state, j_avg = j_update(j_state, v, mask)
        _close(t_avg, j_avg, 1e-12)
    for got, want in zip(t_state, j_state):
        _close(got, want, 1e-12)


def test_kinematics_match_jax():
    rng = np.random.default_rng(3)
    q = np.array([0.0, 0.8, -1.6]) + 0.3 * rng.normal(size=(6, 4, 3))
    rho_opt = 0.01 * rng.normal(size=(4, 3))
    geom = t_kin.a1_leg_geometry(F64, "cpu")
    jgeom = j_kin.a1_leg_geometry(jnp.float64)
    rho_fix = np.asarray(jgeom.rho_fix)
    _close(geom.rho_fix, rho_fix, 0)
    _close(t_kin.fk(_t(q), _t(rho_opt), geom.rho_fix),
           j_kin.fk(q, rho_opt, rho_fix), 1e-12)
    _close(t_kin.jac(_t(q), _t(rho_opt), geom.rho_fix),
           j_kin.jac(q, rho_opt, rho_fix), 1e-12)
    _close(t_kin.foot_positions_body(_t(q.reshape(6, 12)), geom),
           j_kin.foot_positions_body(q.reshape(6, 12), jgeom), 1e-12)
    feet = np.asarray(j_kin.fk(q, np.zeros((4, 3)), rho_fix))
    _close(t_kin.inverse_kinematics(_t(feet), geom.rho_fix),
           j_kin.inverse_kinematics(feet, rho_fix), 1e-10)


def _random_mpc_inputs(rng, batch):
    euler = rng.normal(size=(batch, 3)) * 0.3
    rot = np.asarray(j_rot.euler_to_rot_mat(euler))
    feet = rng.normal(size=(batch, 4, 3)) * 0.25
    x0 = rng.normal(size=(batch, 13))
    x_ref = rng.normal(size=(batch, 10, 13))
    contacts = rng.uniform(size=(batch, 4)) > 0.4
    return euler, rot, feet, x0, x_ref, contacts


def test_srb_condensation_matches_jax_and_oracle():
    rng = np.random.default_rng(4)
    batch = 4
    euler, rot, feet, x0, x_ref, contacts = _random_mpc_inputs(rng, batch)
    model = j_types.default_robot_model(jnp.float64)
    params = j_types.default_ctrl_params(jnp.float64)
    mass, inertia = np.asarray(model.mass), np.asarray(model.trunk_inertia)
    qw, rw = np.asarray(params.q_weights), np.asarray(params.r_weights)
    dt = 0.0025

    t_ac = t_srb.calculate_A_c(_t(euler))
    t_bc = t_srb.calculate_B_c(_t(mass), _t(inertia), _t(rot), _t(feet))
    t_ad, t_bd = t_srb.discretize(t_ac, t_bc, dt)
    t_lazy = t_srb.condense_nilpotent_lazy(t_ad, t_bd, _t(x0), _t(x_ref),
                                           _t(qw), _t(rw), _t(contacts))
    t_h = t_srb.lazy_hessian(t_lazy)
    u = rng.normal(size=(batch, 120))
    y = rng.normal(size=(batch, 200))

    def one(e, r, f, x, xr, c, uu, yy):
        a_c = j_srb.calculate_A_c(e)
        b_c = j_srb.calculate_B_c(mass, inertia, r, f)
        a_d, b_d = j_srb.discretize(a_c, b_c, dt)
        lz = j_srb.condense_nilpotent_lazy(a_d, b_d, x, xr, qw, rw, c)
        return (a_c, b_c, lz, j_srb.lazy_hessian(lz),
                j_srb.lazy_hessian_matvec(lz, uu), j_srb.lazy_hessian_diag(lz),
                j_srb.constraint_matvec(uu), j_srb.constraint_rmatvec(yy))

    j_ac, j_bc, j_lazy, j_h, j_hv, j_hd, j_cu, j_cty = jax.vmap(one)(
        euler, rot, feet, x0, x_ref, contacts, u, y)
    _close(t_ac, j_ac, 1e-15)
    _close(t_bc, j_bc, 1e-12)
    for got, want in zip(t_lazy, j_lazy):
        scale = max(1.0, np.abs(np.asarray(want)[np.isfinite(want)]).max())
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-10 * scale, rtol=0)
    _close(t_h, j_h, 1e-10)
    _close(t_srb.lazy_hessian_matvec(t_lazy, _t(u)), j_hv, 1e-10)
    _close(t_srb.lazy_hessian_diag(t_lazy), j_hd, 1e-10)
    _close(t_srb.constraint_matvec(_t(u)), j_cu, 1e-12)
    _close(t_srb.constraint_rmatvec(_t(y)), j_cty, 1e-12)

    # the float64 oracle (ConvexMpc.cpp loops) on the same inputs
    for b in range(batch):
        a_d, _ = oracle.discretize(oracle.calculate_A_c(euler[b]),
                                   np.zeros((13, 12)), dt)
        _, b_d = oracle.discretize(
            a_d, oracle.calculate_B_c(mass, inertia, rot[b], feet[b]), dt)
        ref = oracle.condense(a_d, np.stack([b_d] * 10), x0[b],
                              x_ref[b].reshape(-1), qw, rw, contacts[b])
        _close(t_h[b], ref.hessian, 1e-9)
        _close(t_lazy.gradient[b], ref.gradient, 1e-9)
        _close(t_lazy.lb[b], ref.lb, 0)
        _close(t_lazy.ub[b], ref.ub, 0)


def test_reference_trajectory_and_state_match_jax():
    rng = np.random.default_rng(5)
    batch = 3
    args = [rng.normal(size=(batch, 3)) for _ in range(6)]
    got = t_srb.reference_trajectory(*[_t(a) for a in args], 0.0025)
    want = jax.vmap(lambda *a: j_srb.reference_trajectory(*a, 0.0025))(*args)
    _close(got, want, 1e-14)
    got = t_srb.mpc_state(*[_t(a) for a in args[:4]])
    want = jax.vmap(j_srb.mpc_state)(*args[:4])
    _close(got, want, 0)


def test_state_containers_and_carry_match_jax():
    """Defaults equal the JAX package's; ``from_numpy`` / ``to_numpy``
    carry a JAX state (nested filters included) into the port and back."""
    batch = 2
    model = t_types.default_robot_model(F64, "cpu")
    params = t_types.default_ctrl_params(F64, "cpu")
    jmodel = j_types.default_robot_model(jnp.float64)
    jparams = j_types.default_ctrl_params(jnp.float64)
    for got, want in zip(params, jparams):
        _close(got, want, 0)
    _close(model.mass, jmodel.mass, 0)
    _close(model.trunk_inertia, jmodel.trunk_inertia, 0)
    _close(model.default_foot_pos, jmodel.default_foot_pos, 0)

    state = t_types.init_ctrl_state(model, batch, F64, "cpu")
    jstate = jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape),
                          j_types.init_ctrl_state(jmodel, jnp.float64))
    jnp_state = jax.tree.map(np.asarray, jstate)
    ported = convert.from_numpy(t_types.CtrlState, jnp_state._asdict(),
                                "cpu", F64)
    flat_t = jax.tree.leaves(convert.to_numpy(state))
    flat_p = jax.tree.leaves(convert.to_numpy(ported))
    flat_j = jax.tree.leaves(_dicts(jnp_state))
    assert len(flat_t) == len(flat_p) == len(flat_j)
    for a, b, c in zip(flat_t, flat_p, flat_j):
        assert a.shape == c.shape and a.dtype == c.dtype
        _close(a, c, 0)
        _close(b, c, 0)
    assert ported.recent_contact_filter.buffer.shape == (batch, 4, 60, 3)


@pytest.mark.parametrize("l0", [1e-6, 1e-5, 1e-4, 1e-3])
def test_scaled_schulz_coeffs_equal_jax(l0):
    assert t_admm._scaled_schulz_coeffs(l0) == j_admm._scaled_schulz_coeffs(l0)

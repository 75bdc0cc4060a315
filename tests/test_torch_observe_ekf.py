"""PyTorch port, kernel K2 (the whole observe + EKF stage), held against
the JAX package.

The plain version runs against the Pallas kernel it replaces
(``pallas_ekf.observe_ekf_lanes`` in interpret mode) in float32 at batch 24
(not a multiple of the 128-lane tile, so the padding is exercised), at the
tolerances of tests/test_pallas_ekf.py: 1e-5 x max(1, max|ref|), 5e-4 on x
and P (lane FMA chains against the reference's matmuls). In float64 it
equals the JAX reference composition (rotations + kinematics +
``ekf.update_estimation``) to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch.ops import ekf as t_ekf
from go1_qp_mpc_controller_torch.ops import observe_ekf
from go1_qp_mpc_controller_tpu.models import kinematics as j_kin
from go1_qp_mpc_controller_tpu.ops import ekf as j_ekf
from go1_qp_mpc_controller_tpu.ops import pallas_ekf
from go1_qp_mpc_controller_tpu.utils import rotations as j_rot

torch.set_num_threads(1)
NAMES = [name for name, _ in observe_ekf.OUTPUTS]
DT = 0.002


def _inputs(batch, seed, dtype):
    """Seeded inputs in the distribution of tests/test_pallas_ekf.py."""
    rng = np.random.default_rng(seed)
    quat = 0.1 * rng.normal(size=(batch, 4))
    quat[:, 0] += 1.0
    acc = rng.normal(size=(batch, 3))
    gyro = 0.5 * rng.normal(size=(batch, 3))
    qpos = np.tile([0.0, 0.8, -1.6], 4) + 0.2 * rng.normal(size=(batch, 12))
    qvel = rng.normal(size=(batch, 12))
    ffoot = 120.0 * rng.uniform(size=(batch, 4))
    mode = (rng.uniform(size=batch) > 0.5).astype(np.int32)
    geom = j_kin.a1_leg_geometry(jnp.float64)
    rot = np.asarray(j_rot.quat_to_rot_mat(quat))
    fpr = np.asarray(j_kin.foot_positions_body(qpos, geom))
    x0, p0 = jax.vmap(j_ekf.init_state)(rot, fpr)
    p0 = np.asarray(p0) + 0.01 * rng.normal(size=(batch, 18, 18))
    p0 = 0.5 * (p0 + p0.transpose(0, 2, 1)) + 3.0 * np.eye(18)
    arrays = [np.asarray(x0), p0, quat, acc, gyro, qpos, qvel, ffoot]
    arrays = [a.astype(dtype) for a in arrays] + [mode]
    geom_np = (np.asarray(geom.rho_opt, dtype), np.asarray(geom.rho_fix,
                                                            dtype))
    return arrays, geom_np


def _port(arrays, geom_np, dtype):
    t = [torch.tensor(a) for a in arrays]
    return observe_ekf.observe_ekf(*t, DT, torch.tensor(geom_np[0]),
                                   torch.tensor(geom_np[1]))


def _reference(x, P, quat, acc, gyro, qpos, qvel, ffoot, mode, rho_opt,
               rho_fix, dt):
    """The JAX package's per-scenario reference composition
    (controller._observe_ekf_fn ``ref``)."""
    rot = j_rot.quat_to_rot_mat(quat)
    euler = j_rot.quat_to_euler(quat)
    fpr = j_kin.fk(qpos.reshape(4, 3), rho_opt, rho_fix)
    jf = j_kin.jac(qpos.reshape(4, 3), rho_opt, rho_fix)
    fvr = jnp.einsum('lij,lj->li', jf, qvel.reshape(4, 3))
    res = j_ekf.update_estimation(x, P, dt, rot, acc, gyro, fpr, fvr, ffoot,
                                  mode, innovation_solver="schulz")
    return (rot, euler, j_rot.rot_z(euler[2]), fpr, fpr @ rot.T, fvr, jf,
            rot @ gyro, res.x, res.P, res.estimated_contacts)


def test_k2_plain_matches_pallas_kernel_f32():
    """Against the Pallas kernel and the JAX reference composition, both
    in float32."""
    arrays, geom_np = _inputs(24, 0, np.float32)
    got = _port(arrays, geom_np, np.float32)
    j_args = [jnp.asarray(a) for a in arrays]
    out = pallas_ekf.observe_ekf_lanes(
        *j_args, jnp.asarray(DT, jnp.float32), jnp.asarray(geom_np[0]),
        jnp.asarray(geom_np[1]), interpret=True)
    ref = jax.vmap(lambda *a: _reference(
        *a, jnp.asarray(geom_np[0]), jnp.asarray(geom_np[1]),
        jnp.asarray(DT, jnp.float32)))(*j_args)
    tols = {"x": 5e-4, "P": 5e-4}
    for name, r in zip(NAMES, ref):
        for want in (np.asarray(out[name]), np.asarray(r)):
            atol = tols.get(name, 1e-5) * max(1.0, np.abs(want).max())
            np.testing.assert_allclose(got[name].numpy(), want, atol=atol,
                                       rtol=0, err_msg=name)


def test_k2_plain_matches_reference_composition_f64():
    arrays, geom_np = _inputs(24, 1, np.float64)
    got = _port(arrays, geom_np, np.float64)
    want = jax.vmap(lambda *a: _reference(*a, geom_np[0], geom_np[1], DT))(
        *arrays)
    for name, w in zip(NAMES, want):
        w = np.asarray(w)
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=1e-10 * max(1.0, np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("mode", [0, 1])
def test_k2_contact_semantics(mode):
    """Standing mode forces full contact; walking scales by force / 100."""
    arrays, geom_np = _inputs(8, 2, np.float32)
    arrays[-1] = np.full(8, mode, np.int32)
    got = _port(arrays, geom_np, np.float32)["est_contacts"].numpy()
    want = 1.0 if mode == 0 else np.clip(arrays[7] / 100.0, 0.0, 1.0)
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape),
                               atol=1e-6)


def test_ekf_init_matches_jax():
    rng = np.random.default_rng(3)
    rot = np.asarray(j_rot.euler_to_rot_mat(0.2 * rng.normal(size=(4, 3))))
    fpr = rng.normal(size=(4, 4, 3))
    jx, jp = jax.vmap(j_ekf.init_state)(rot, fpr)
    tx, tp = t_ekf.init_state(torch.tensor(rot), torch.tensor(fpr))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-15)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=0)


def test_k2_wrapper_needs_no_card_for_cpu_input():
    """A CPU tensor takes the plain version and counts no launch."""
    observe_ekf.reset_launches()
    arrays, geom_np = _inputs(2, 5, np.float32)
    _port(arrays, geom_np, np.float32)
    assert observe_ekf.launches == 0

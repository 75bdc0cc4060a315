"""PyTorch port, kernels K4 and K5: their plain versions against the JAX
package's Pallas kernels in interpret mode, and the EKF's route to K4.

- K4 (``ops/schulz_lanes.py``): the plain version against
  ``pallas_admm.schulz_inverse_lanes(..., lane_tile=4, interpret=True)`` at
  b = 9, n = 28 in float32, within 5e-4 x max|X| (tests/test_pallas_admm.py
  :217-219), and against the vmapped ``admm._schulz_inverse`` in float64
  within 1e-10.
- K5 (``ops/schulz_balanced.py``): the plain version against
  ``pallas_admm.schulz_balanced(..., interpret=True)`` on the cold,
  warm-accept and warm-reject cases of tests/test_pallas_admm.py:126-156
  and on the empty schedule, within 5e-6.
- ``ekf.update_estimation(sinv=...)``: "auto" on a CPU tensor is the plain
  version exactly; an unknown route raises.

On CPU tensors the wrappers take their plain versions and count no
launches; the CUDA kernels are held against the same plain versions in
tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go1_qp_mpc_controller_torch.ops import _build
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_torch.ops import ekf as t_ekf
from go1_qp_mpc_controller_torch.ops import schulz_balanced, schulz_lanes
from go1_qp_mpc_controller_tpu.ops import admm as j_admm
from go1_qp_mpc_controller_tpu.ops import pallas_admm

torch.set_num_threads(1)
COEFFS = t_admm._scaled_schulz_coeffs(1e-5)


def _spread_spd(b=9, n=28, seed=7):
    """tests/test_pallas_admm.py:198-204's matrices."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    spd = a @ np.swapaxes(a, -1, -2) / n + 0.2 * np.eye(n, dtype=np.float32)
    d = np.exp(rng.uniform(-2, 2, size=(b, n))).astype(np.float32)
    return spd * d[:, :, None] * d[:, None, :]


def test_k4_plain_matches_the_pallas_kernel_f32():
    spd = _spread_spd()
    want = np.asarray(pallas_admm.schulz_inverse_lanes(
        jnp.asarray(spd), COEFFS, lane_tile=4, interpret=True))
    schulz_lanes.reset_launches()
    got = schulz_lanes.schulz_inverse_lanes(torch.tensor(spd), COEFFS)
    assert schulz_lanes.launches == 0              # CPU: the plain version
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4 * scale, rtol=0)
    resid = np.einsum("bij,bjk->bik", spd, got.numpy()) - np.eye(28)
    assert np.abs(resid).max() < 1e-3


def test_k4_plain_matches_the_xla_schedule_f64():
    spd = _spread_spd(seed=11).astype(np.float64)
    want = np.asarray(jax.vmap(lambda s: j_admm._schulz_inverse(
        s, 0, coeffs=COEFFS))(jnp.asarray(spd)))
    got = schulz_lanes.schulz_inverse_lanes(torch.tensor(spd), COEFFS)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10, rtol=0)


def _row_heavy(b=5, seed=3):
    """Spread SPD matrices with row 0's off-diagonal entries tripled: the
    largest absolute row sum of the balanced matrix is then far above the
    largest column sum, so a body that took column sums (K2's shortcut on
    its symmetrized S) would start from another c0."""
    m = _spread_spd(b, seed=seed)
    m[:, 0, 1:] *= 3.0
    return m


def test_k4_plain_takes_row_sums_like_the_pallas_kernel():
    m = _row_heavy()
    coeffs = COEFFS[:3]
    want = np.asarray(pallas_admm.schulz_inverse_lanes(
        jnp.asarray(m), coeffs, lane_tile=4, interpret=True))
    got = schulz_lanes.schulz_inverse_lanes(torch.tensor(m), coeffs)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale, rtol=0)
    # the schedule is a polynomial in M_b, so the column-sum variant is the
    # row-sum one of M' transposed back: far from it here
    cols = schulz_lanes.schulz_inverse_lanes(
        torch.tensor(m).transpose(1, 2).contiguous(), coeffs).transpose(1, 2)
    assert np.abs(cols.numpy() - want).max() > 1e-2 * scale


@pytest.mark.parametrize("steps", [0, 65])
def test_k4_entry_refuses_a_schedule_out_of_range(steps):
    with pytest.raises(ValueError):
        schulz_lanes.schulz_inverse_lanes(torch.eye(28)[None], (1.0,) * steps)


def test_k4_schedule_is_the_jax_ekf_schedule():
    assert t_ekf.SINV_L0 == 1e-5
    assert len(COEFFS) == 12 and COEFFS[-2:] == (1.0, 1.0)
    assert COEFFS == j_admm._scaled_schulz_coeffs(1e-5)


def _balanced_case(seed=0, n=120):
    """tests/test_pallas_admm.py:126-136's balanced matrix, float32."""
    a = jax.random.normal(jax.random.PRNGKey(seed), (n, n), jnp.float32)
    m = a @ a.T / n + 3.0 * jnp.eye(n)
    s = jax.lax.rsqrt(jnp.diagonal(m))
    return m * s[:, None] * s[None, :]


@pytest.mark.parametrize("case", ["cold", "warm_accept", "warm_reject",
                                  "accept_0_steps", "reject_0_steps"])
def test_k5_plain_matches_the_pallas_kernel(case):
    mb = _balanced_case()
    cold = pallas_admm.schulz_balanced(mb, 20, interpret=True)
    iters, x0 = {"cold": (20, None),
                 "warm_accept": (4, cold * (1.0 + 1e-3)),
                 "warm_reject": (20, jnp.full(mb.shape, 5.0)),
                 "accept_0_steps": (0, cold * (1.0 + 1e-3)),
                 "reject_0_steps": (0, jnp.full(mb.shape, 5.0))}[case]
    want = np.asarray(pallas_admm.schulz_balanced(mb, iters, x0_b=x0,
                                                  interpret=True))
    schulz_balanced.reset_launches()
    got = schulz_balanced.schulz_balanced(
        torch.tensor(np.asarray(mb)), iters,
        None if x0 is None else torch.tensor(np.asarray(x0)))
    assert schulz_balanced.launches == 0
    np.testing.assert_allclose(got.numpy(), want, atol=5e-6, rtol=0)
    if case == "cold":
        resid = np.abs(np.asarray(mb) @ got.numpy() - np.eye(120)).max()
        assert resid < 1e-5


def test_k5_entry_refuses_a_long_schedule():
    with pytest.raises(ValueError):
        schulz_balanced.schulz_balanced(torch.eye(120), 65)


def _ekf_inputs(batch=6, seed=4):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.tensor(rng.normal(size=s))
    quat = torch.nn.functional.normalize(
        torch.tensor([1.0, 0, 0, 0]) + 0.1 * t(batch, 4), dim=-1)
    from go1_qp_mpc_controller_torch.utils import rotations
    p0 = 0.01 * t(batch, 18, 18)
    p0 = 0.5 * (p0 + p0.transpose(1, 2)) + torch.eye(18)
    return (t(batch, 18), p0, 0.002, rotations.quat_to_rot_mat(quat),
            t(batch, 3), t(batch, 3), 0.3 * t(batch, 4, 3), t(batch, 4, 3),
            torch.tensor(rng.uniform(0, 120, size=(batch, 4))),
            torch.tensor(rng.integers(0, 2, size=batch), dtype=torch.int32))


def test_ekf_sinv_routes():
    args = _ekf_inputs()
    schulz_lanes.reset_launches()
    auto = t_ekf.update_estimation(*args, sinv="auto")
    plain = t_ekf.update_estimation(*args, sinv="plain")
    assert schulz_lanes.launches == 0
    for a, p in zip(auto, plain):
        assert torch.equal(a, p)
    with pytest.raises(ValueError):
        t_ekf.update_estimation(*args, sinv="chol")
    # the matrix the route inverts: the predict step's innovation
    s_mat = t_ekf.predict(*args).s_mat
    assert s_mat.shape == (6, 28, 28)
    assert torch.allclose(s_mat, s_mat.transpose(1, 2))
    assert bool((torch.linalg.eigvalsh(s_mat) > 0).all())


def test_every_tpu_kernel_has_a_cuda_source():
    assert _build.KERNELS == ("kkt_schulz", "observe_ekf", "schulz_batch",
                              "admm_iterations", "schulz_lanes",
                              "schulz_balanced")
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()

"""The port's CUDA kernels on the card: K1 and K2 against their plain
versions, the wrappers' input checks, and a few main-path ticks through
both kernels.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels build at first
use); without a card they skip. This file imports neither JAX nor the JAX
package. On the GPU machine:

    python3 -m pytest tests/test_torch_kernels_cuda.py

Tolerances: K1 3e-4 x max|plain| (the JAX tests' Schulz tolerance), over
the batch and per scenario in balanced coordinates; K2 1e-5 x max(1,
max|plain|), 5e-4 on x and P (tests/test_pallas_ekf.py).
"""

import pytest
import torch

from go1_qp_mpc_controller_torch.envs import rollout
from go1_qp_mpc_controller_torch.models import kinematics, srb, types
from go1_qp_mpc_controller_torch.ops import admm, ekf, kkt_schulz
from go1_qp_mpc_controller_torch.ops import observe_ekf
from go1_qp_mpc_controller_torch.utils import rotations

pytestmark = pytest.mark.cuda
F32 = torch.float32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _k1_operands(batch, device, seed=0):
    """K1 operands of seeded random scenarios around the standing pose."""
    gen = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=gen, dtype=F32).to(device)
    model = types.default_robot_model(F32, device)
    params = types.default_ctrl_params(F32, device)
    euler = 0.1 * rn(batch, 3)
    rot = rotations.euler_to_rot_mat(euler)
    feet = (model.default_foot_pos + 0.03 * rn(batch, 4, 3)) @ rot.transpose(
        -1, -2)
    contacts = torch.rand((batch, 4), generator=gen).to(device) > 0.3
    pos = 0.3 + 0.01 * rn(batch, 3)
    x0 = srb.mpc_state(euler, pos, 0.2 * rn(batch, 3), 0.2 * rn(batch, 3))
    x_ref = srb.reference_trajectory(pos, euler, pos, 0.0 * euler,
                                     0.0 * euler, 0.2 * rn(batch, 3),
                                     params.mpc_dt)
    a_d, b_d = srb.discretize(
        srb.calculate_A_c(euler),
        srb.calculate_B_c(model.mass, model.trunk_inertia, rot, feet),
        params.mpc_dt)
    lazy = srb.condense_nilpotent_lazy(a_d, b_d, x0, x_ref,
                                       params.q_weights, params.r_weights,
                                       contacts)
    eq = torch.isclose(lazy.lb, lazy.ub)
    rho_vec = torch.where(eq, 50.0, 0.05).to(F32)
    return admm._kkt_kernel_operands(lazy, rho_vec, 1e-6, 0.3)


@pytest.mark.parametrize("variant", ["cold", "warm", "warm_scaled"])
def test_k1_kernel_matches_plain(card, variant):
    ops = _k1_operands(256, card)
    c3 = admm._scaled_schulz_coeffs(1e-3)
    c4 = admm._scaled_schulz_coeffs(1e-4)
    conv = kkt_schulz.kkt_schulz(*ops, coeffs=c4)
    # every fourth scenario's warm start fails the basin test
    bad = (torch.arange(256, device=card) % 4 == 0)[:, None, None]
    x0 = torch.where(bad, -conv, conv).contiguous()
    x0, coeffs = {"cold": (None, c3), "warm": (x0, (1.0,)),
                  "warm_scaled": (x0, c4)}[variant]
    got = kkt_schulz.kkt_schulz(*ops, x0=x0, coeffs=coeffs)
    want = kkt_schulz.kkt_schulz_plain(*ops, x0=x0, coeffs=coeffs)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 3e-4 * float(want.abs().max())
    # per scenario in balanced coordinates, where every block is O(1)
    m = kkt_schulz.kkt_build_plain(*ops)
    s = torch.rsqrt(torch.diagonal(m, dim1=-2, dim2=-1))
    unb = s[:, :, None] * s[:, None, :]
    got_b, want_b = got / unb, want / unb
    err_b = (got_b - want_b).abs().amax((1, 2)) / want_b.abs().amax((1, 2))
    assert float(err_b.max()) <= 3e-4


def _k2_inputs(batch, device, seed=1):
    gen = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=gen, dtype=F32)
    quat = 0.1 * rn(batch, 4)
    quat[:, 0] += 1.0
    qpos = torch.tensor([0.0, 0.8, -1.6] * 4) + 0.2 * rn(batch, 12)
    geom = kinematics.a1_leg_geometry(F32, "cpu")
    x0, p0 = ekf.init_state(rotations.quat_to_rot_mat(quat),
                            kinematics.foot_positions_body(qpos, geom))
    p0 = p0 + 0.01 * rn(batch, 18, 18)
    p0 = 0.5 * (p0 + p0.transpose(1, 2)) + 3.0 * torch.eye(18)
    mode = (torch.rand((batch,), generator=gen) > 0.5).to(torch.int32)
    args = [x0, p0, quat, rn(batch, 3), 0.5 * rn(batch, 3), qpos,
            rn(batch, 12), 120.0 * torch.rand((batch, 4), generator=gen),
            mode]
    return ([a.to(device).contiguous() for a in args]
            + [0.002, geom.rho_opt.to(device), geom.rho_fix.to(device)])


def test_k2_kernel_matches_plain(card):
    args = _k2_inputs(300, card)
    got = observe_ekf.observe_ekf(*args)
    want = observe_ekf.observe_ekf_plain(*args)
    for name, _ in observe_ekf.OUTPUTS:
        tol = 5e-4 if name in ("x", "P") else 1e-5
        atol = tol * max(1.0, float(want[name].abs().max()))
        assert float((got[name] - want[name]).abs().max()) <= atol, name


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    ops = _k1_operands(4, card)
    with pytest.raises(TypeError):
        kkt_schulz.kkt_schulz(*[o.double() for o in ops])
    with pytest.raises(ValueError):
        kkt_schulz.kkt_schulz(*ops, coeffs=(1.0,) * 65)
    args = _k2_inputs(4, card)
    args[1] = args[1].transpose(1, 2)           # not contiguous
    with pytest.raises(ValueError):
        observe_ekf.observe_ekf(*args)


def test_main_path_ticks_launch_both_kernels(card):
    model = types.default_robot_model(F32, card)
    params = types.default_ctrl_params(F32, card)
    carry = rollout.init_carry(model, params, 8, dtype=F32, device=card)
    settings = admm.ADMMSettings(seg_iters=30, segments=2,
                                 first_seg_iters=20, polish=False,
                                 schulz_l0=1e-6, schulz_l0_first=1e-3,
                                 schulz_l0_refine=1e-4, schulz_impl="auto")
    kkt_schulz.reset_launches()
    observe_ekf.reset_launches()
    _, trace = rollout.rollout_batched(carry, model, params, 5, 0.002,
                                       settings=settings)
    torch.cuda.synchronize()
    assert observe_ekf.launches == 5
    assert kkt_schulz.launches >= 5
    assert torch.isfinite(trace.foot_forces_grf).all()


def test_compact_tick_launches_k1_on_the_sub_batch(card):
    """A tick with a few flagged scenarios takes the compacted cold
    sub-batch route: the base program's K1 launch, then one for each cold
    segment on the gathered sub-batch."""
    model = types.default_robot_model(F32, card)
    params = types.default_ctrl_params(F32, card)
    carry = rollout.init_carry(model, params, 16, dtype=F32, device=card)
    settings = admm.ADMMSettings(seg_iters=30, segments=2,
                                 first_seg_iters=20, polish=False,
                                 schulz_l0=1e-6, schulz_l0_first=1e-3,
                                 schulz_l0_refine=1e-4, schulz_impl="auto")
    # standing, past the young-carry window: every scenario runs warm
    carry, _ = rollout.rollout_batched(carry, model, params, 45, 0.002,
                                       settings=settings, compact_k=4)
    qc = carry.ctrl.qp_warm_contacts.clone()
    qc[[0, 5]] = ~qc[[0, 5]]
    carry = carry._replace(ctrl=carry.ctrl._replace(qp_warm_contacts=qc))
    kkt_schulz.reset_launches()
    stats = {}
    _, trace = rollout.rollout_batched(carry, model, params, 1, 0.002,
                                       settings=settings, compact_k=4,
                                       stats=stats)
    torch.cuda.synchronize()
    assert stats == {"compact": 1}
    assert kkt_schulz.launches == 1 + settings.segments
    assert torch.isfinite(trace.foot_forces_grf).all()

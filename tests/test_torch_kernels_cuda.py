"""The port's CUDA kernels on the card: K1 to K6 against their plain
versions, the wrappers' input checks, and a few ticks of the paths
through them (the estimator thread's K4 launch a frame and the RL loop's
a tick among them), and ``chip_smoke.py``'s RL and replay phases at a
reduced size.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels build at first
use); without a card they skip. This file imports neither JAX nor the JAX
package. On the GPU machine:

    python3 -m pytest tests/test_torch_kernels_cuda.py

Tolerances: K1 and K3 3e-4 x max|plain| (the JAX tests' Schulz
tolerance), over the batch and per scenario in balanced coordinates; K2
1e-5 x max(1, max|plain|), 5e-4 on x and P (tests/test_pallas_ekf.py);
K6 per scenario on x (and z): within 1e-3 of the plain version
(tests/test_pallas_admm.py) and within 2e-3 of the same loop in float64
(1e-3 more for the float32 loop's own round-off on the QP's flat
directions); on y within 0.1 x (1 + max|y|) of the plain version. K4
5e-4 x max|plain| per matrix (tests/test_pallas_admm.py:217-219), or on
ill-conditioned innovation matrices twice the plain version's distance to
the float64 schedule; K5 5e-6 (tests/test_pallas_admm.py:126-156). K3
at n = 120, K1 and K5 are also held against their plain versions with
the kernels' 3xTF32 middle products (``kkt_schulz.matmul_3xtf32``), at
``chip_smoke.K3_EMU_TOL``, ``K1_EMU_TOL`` and ``K5_EMU_TOL``.
"""

import sys

import pytest
import torch

sys.path.insert(0, ".")        # chip_smoke.py lives at the repo root
import chip_smoke  # noqa: E402

from go1_qp_mpc_controller_torch.envs import rollout
from go1_qp_mpc_controller_torch.models import kinematics, srb, types
from go1_qp_mpc_controller_torch.ops import admm, admm_iterations, ekf
from go1_qp_mpc_controller_torch.ops import kkt_schulz, observe_ekf, qp
from go1_qp_mpc_controller_torch.ops import schulz_batch
from go1_qp_mpc_controller_torch.utils import graphs, rotations

pytestmark = pytest.mark.cuda
F32 = torch.float32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _lazy(batch, device, seed=0):
    """Lazy condensed QPs of seeded random scenarios around the standing
    pose."""
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
    return srb.condense_nilpotent_lazy(a_d, b_d, x0, x_ref,
                                       params.q_weights, params.r_weights,
                                       contacts)


def _k1_operands(batch, device, seed=0):
    """K1 operands of seeded random scenarios around the standing pose."""
    lazy = _lazy(batch, device, seed)
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


@pytest.mark.parametrize("hi_tail", [0, 1, 2])
@pytest.mark.parametrize(
    "variant, batch",
    [(v, b) for b in (1, 17, 128, 256)
     for v in ("cold", "warm", "warm_scaled")] + [("cold", 4096)])
def test_k1_routes_match_plain(card, batch, variant, hi_tail):
    """K1 at FP32 tail ``hi_tail`` on the route the wrapper picks
    (``kkt_schulz.route``), one counted launch, and on the other route for
    the same schedule: within 3e-4 of the float32 plain version per
    scenario in balanced coordinates and within ``chip_smoke.K1_EMU_TOL``
    of the emulation with the kernel's 3xTF32 middle steps. Batch 4096
    (the fleet's whole-batch cold solve) on the cold schedule."""
    ops = _k1_operands(batch, card, seed=batch)
    c3 = admm._scaled_schulz_coeffs(1e-3)
    c4 = admm._scaled_schulz_coeffs(1e-4)
    conv = kkt_schulz.kkt_schulz_plain(*ops, coeffs=c4)
    bad = (torch.arange(batch, device=card) % 4 == 0)[:, None, None]
    x0 = torch.where(bad, -conv, conv).contiguous()
    x0, coeffs = {"cold": (None, c3), "warm": (x0, (1.0,)),
                  "warm_scaled": (x0, c4)}[variant]
    tail = kkt_schulz.default_hi_tail(coeffs, hi_tail)
    m = kkt_schulz.kkt_build_plain(*ops)
    want = kkt_schulz.kkt_schulz_plain(*ops, x0=x0, coeffs=coeffs)
    emu = kkt_schulz.kkt_schulz_plain(*ops, x0=x0, coeffs=coeffs,
                                      hi_tail=tail,
                                      middle_matmul=kkt_schulz.matmul_3xtf32)

    def check(got, against):
        assert torch.isfinite(got).all()
        assert float(_balanced_error(got, want, m).max()) <= 3e-4
        assert (float(_balanced_error(got, against, m).max())
                <= chip_smoke.K1_EMU_TOL)

    kkt_schulz.reset_launches()
    way = kkt_schulz.route(coeffs, tail)
    check(kkt_schulz.kkt_schulz(*ops, x0=x0, coeffs=coeffs, hi_tail=tail),
          emu)
    assert kkt_schulz.launches == 1 and kkt_schulz.route_launches[way] == 1
    # the other route: "cta" runs an all-FP32 schedule on the tensor-core
    # body's FP32 steps; "fp32" runs every step FP32 whatever the tail
    if way == "cta":
        check(kkt_schulz._launch(*ops, x0, coeffs, len(coeffs),
                                 kkt_schulz.BLOCKS["fp32"]), want)
    else:
        check(kkt_schulz._launch(*ops, x0, coeffs, tail,
                                 kkt_schulz.BLOCKS["cta"]), want)


def test_k1_refuses_a_route_it_does_not_have(card):
    """The kernel takes blocks 0 ("fp32") and 1 ("cta") only; any other
    value is refused before a launch and the wrapper raises."""
    ops = _k1_operands(2, card)
    for blocks in (2, 8, -1):
        with pytest.raises(RuntimeError, match=f"blocks={blocks} "):
            kkt_schulz._launch(*ops, None, (1.0,) * 4, 2, blocks)
    got = kkt_schulz.kkt_schulz(*ops, coeffs=(1.0,) * 4)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("batch", [1, 5])
def test_k2_small_batches_match_plain(card, batch):
    """One scenario, and a batch that leaves a block's last warps idle."""
    args = _k2_inputs(batch, card, seed=batch)
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


def _ticks_launches(module, name):
    """``module``'s launches since its counter and ``graphs``' records were
    reset, less those of the eager warm-up runs of the captures made
    since: the launches of the ticks themselves (graph replays)."""
    return module.launches - graphs.warmup_launches.get(name, (0, {}))[0]


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
    admm_iterations.reset_launches()
    graphs.reset_records()
    _, trace = rollout.rollout_batched(carry, model, params, 5, 0.002,
                                       settings=settings)
    torch.cuda.synchronize()
    assert _ticks_launches(observe_ekf, "observe_ekf") == 5
    assert _ticks_launches(kkt_schulz, "kkt_schulz") >= 5
    # every tick's ADMM loop
    assert _ticks_launches(admm_iterations, "admm_iterations") >= 5
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


def _balanced_error(got, want, m):
    """Per-scenario error in balanced coordinates, relative to the
    scenario's largest balanced entry."""
    s = torch.rsqrt(torch.diagonal(m, dim1=-2, dim2=-1))
    unb = s[:, :, None] * s[:, None, :]
    got_b, want_b = got / unb, want / unb
    return (got_b - want_b).abs().amax((1, 2)) / want_b.abs().amax((1, 2))


def _balance_kkts(batch, device, seed=2):
    """K3's n = 12 operands: the balance QP's KKT at rho = 0.1."""
    gen = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=gen, dtype=F32).to(device)
    acc = torch.tensor([0.0, 0.0, 147.0, 0.0, 0.0, 0.0],
                       device=device) + 5.0 * rn(batch, 6)
    feet = torch.tensor([[0.17, 0.15, -0.3], [0.17, -0.15, -0.3],
                         [-0.17, 0.15, -0.3], [-0.17, -0.15, -0.3]],
                        device=device) + 0.02 * rn(batch, 4, 3)
    rot_z = rotations.rot_z(0.3 * rn(batch))
    contacts = torch.rand((batch, 4), generator=gen).to(device) > 0.3
    bqp = qp.build_balance_qp(acc, rot_z, feet, contacts)
    c = torch.tensor(qp.balance_constraint_matrix(), dtype=F32,
                     device=device)
    cost = 1.0 / bqp.hessian.abs().amax((1, 2))
    rho_vec = torch.where(torch.isclose(bqp.lb, bqp.ub), 100.0, 0.1)
    return (cost[:, None, None] * bqp.hessian + 1e-6 * torch.eye(
        12, device=device) + c.T @ (rho_vec[..., None] * c)).contiguous()


@pytest.mark.parametrize("n", [120, 12])
@pytest.mark.parametrize("warm", [False, True])
def test_k3_kernel_matches_plain(card, n, warm):
    if n == 120:
        m = kkt_schulz.kkt_build_plain(*_k1_operands(256, card))
    else:
        m = _balance_kkts(256, card)
    coeffs = (1.0,) * 20
    x0 = None
    if warm:
        conv = schulz_batch.schulz_inverse_batch(
            m, coeffs=admm._scaled_schulz_coeffs(1e-6))
        bad = (torch.arange(256, device=card) % 8 == 0)[:, None, None]
        x0 = torch.where(bad, -conv, conv).contiguous()
    schulz_batch.reset_launches()
    got = schulz_batch.schulz_inverse_batch(m, x0, coeffs)
    assert schulz_batch.launches == 1
    want = kkt_schulz.schulz_balanced_plain(m, x0, coeffs)
    assert torch.isfinite(got).all()
    assert float(_balanced_error(got, want, m).max()) <= 3e-4
    if warm:   # the empty schedule: the accepted start, else c I
        got0 = schulz_batch.schulz_inverse_batch(m, x0, ())
        want0 = kkt_schulz.schulz_balanced_plain(m, x0, ())
        assert float(_balanced_error(got0, want0, m).max()) <= 3e-4


def _k3_120(batch, card, warm, coeffs=(1.0,) * 20, seed=0):
    """n = 120 KKTs and, if ``warm``, starts of which every eighth (the
    first among them) fails the basin test."""
    m = kkt_schulz.kkt_build_plain(*_k1_operands(batch, card, seed))
    if not warm:
        return m, None
    conv = kkt_schulz.schulz_balanced_plain(
        m, coeffs=admm._scaled_schulz_coeffs(1e-6))
    bad = (torch.arange(batch, device=card) % 8 == 0)[:, None, None]
    return m, torch.where(bad, -conv, conv).contiguous()


def _assert_k3_close(got, m, x0, coeffs, hi_tail=None):
    """Within 3e-4 of the float32 plain version and within
    ``chip_smoke.K3_EMU_TOL`` of the plain version with the kernel's
    3xTF32 middle products, per scenario in balanced coordinates."""
    tail = schulz_batch.default_hi_tail(coeffs, hi_tail)
    want = kkt_schulz.schulz_balanced_plain(m, x0, coeffs)
    emu = kkt_schulz.schulz_balanced_plain(m, x0, coeffs, tail,
                                           kkt_schulz.matmul_3xtf32)
    assert torch.isfinite(got).all()
    assert float(_balanced_error(got, want, m).max()) <= 3e-4
    assert float(_balanced_error(got, emu, m).max()) <= chip_smoke.K3_EMU_TOL


@pytest.mark.parametrize("batch", [1, 2, 16, 17, 256])
@pytest.mark.parametrize("warm", [False, True])
def test_k3_routes_match_plain(card, batch, warm):
    """n = 120 on the route the wrapper picks for ``batch`` (a cluster of
    8 blocks a matrix up to ``CROSSOVER``, one block above), one counted
    launch; the other route passes the same gates."""
    m, x0 = _k3_120(batch, card, warm, seed=batch)
    coeffs = (1.0,) * 20
    schulz_batch.reset_launches()
    got = schulz_batch.schulz_inverse_batch(m, x0, coeffs)
    way = "cluster" if batch <= schulz_batch.CROSSOVER else "cta"
    assert schulz_batch.launches == 1
    assert schulz_batch.route_launches == {"cluster": int(way == "cluster"),
                                           "cta": int(way == "cta"),
                                           "fp32": 0, "n12": 0}
    _assert_k3_close(got, m, x0, coeffs)
    other = schulz_batch._launch(m, x0, coeffs, 2,
                                 1 if way == "cluster" else
                                 schulz_batch.CLUSTER)
    _assert_k3_close(other, m, x0, coeffs)


K3_ROUTE_CASES = {   # case: (warm, schedule, hi_tail)
    "cold": (False, (1.0,) * 20, 2),
    "scaled_tail0": (False, admm._scaled_schulz_coeffs(1e-6), 0),
    "scaled_tail2": (False, admm._scaled_schulz_coeffs(1e-6), 2),
    "warm": (True, (1.0,) * 20, 2),
    "one_tf32_step": (False, (1.0,) * 4, 2),
    "warm_one_tf32_step": (True, (1.0,) * 4, 2),
}


@pytest.mark.parametrize("case", list(K3_ROUTE_CASES))
@pytest.mark.parametrize("batch", [17, 4096])
def test_k3_cta_and_cluster_routes_give_the_same_bits(card, batch, case):
    """n = 120: the CTA route (one block a matrix, wgmma) and the cluster
    route (``CLUSTER`` blocks a matrix, mma.sync) split every operand with
    the same rounding and sum every product entry in the same order, so
    they return the same bits: 20 plain steps cold, the scaled l0 = 1e-6
    schedule with no FP32 tail and with two FP32 steps, 20 steps from warm
    starts of which every eighth fails the basin test, and schedules with
    exactly one 3xTF32 step (the first step folded or the basin test's,
    the last two FP32), cold and warm."""
    warm, coeffs, tail = K3_ROUTE_CASES[case]
    m, x0 = _k3_120(batch, card, warm, seed=batch)
    cta = schulz_batch._launch(m, x0, coeffs, tail, 1)
    cluster = schulz_batch._launch(m, x0, coeffs, tail, schulz_batch.CLUSTER)
    assert torch.isfinite(cta).all()
    assert torch.equal(cta, cluster)


@pytest.mark.parametrize("batch", [1, 64])
def test_k3_fp32_route_without_tf32_steps(card, batch):
    """The warm refinement's one step (hi_tail leaves no 3xTF32 step) runs
    K1's FP32 body at n = 120, one counted launch."""
    m, x0 = _k3_120(batch, card, True, seed=5)
    schulz_batch.reset_launches()
    got = schulz_batch.schulz_inverse_batch(m, x0, (1.0,))
    assert schulz_batch.launches == 1
    assert schulz_batch.route_launches["fp32"] == 1
    _assert_k3_close(got, m, x0, (1.0,))


@pytest.mark.parametrize("hi_tail", [0, 1, 2])
@pytest.mark.parametrize("batch", [1, 64])
def test_k3_hi_tail_matches_plain(card, hi_tail, batch):
    """The scaled l0 = 1e-6 schedule with the last ``hi_tail`` steps FP32
    and the rest 3xTF32, on both routes."""
    coeffs = admm._scaled_schulz_coeffs(1e-6)
    m, _ = _k3_120(batch, card, False, seed=3)
    got = schulz_batch.schulz_inverse_batch(m, None, coeffs, hi_tail=hi_tail)
    _assert_k3_close(got, m, None, coeffs, hi_tail)


@pytest.mark.parametrize("steps", [0, 64])
@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("warm", [False, True])
def test_k3_schedule_lengths(card, steps, batch, warm):
    """The empty schedule (c I, or the accepted start) and the longest
    one."""
    coeffs = (1.0,) * steps
    m, x0 = _k3_120(batch, card, warm, seed=4)
    got = schulz_batch.schulz_inverse_batch(m, x0, coeffs)
    _assert_k3_close(got, m, x0, coeffs)


def test_a_cluster_launch_that_cannot_be_made_raises(card):
    """16 blocks a matrix is past the portable cluster size the kernels
    are set up for: the device refuses the launch and the wrapper raises
    (there is no fallback route)."""
    from go1_qp_mpc_controller_torch.ops import schulz_balanced

    m, _ = _k3_120(2, card, False)
    with pytest.raises(RuntimeError, match="16 blocks"):
        schulz_batch._launch(m, None, (1.0,) * 4, 2, 16)
    with pytest.raises(RuntimeError, match="16 blocks"):
        schulz_balanced._launch(torch.eye(120, device=card), 4, None, 16)
    # the card is still usable
    got = schulz_batch.schulz_inverse_batch(m, None, (1.0,) * 20)
    _assert_k3_close(got, m, None, (1.0,) * 20)


def _k6_inputs(batch, device, seed=3):
    """K6's operands of a warm tick, made as chip_smoke.py's dense warm
    chain makes them (its scenario distribution and settings): a fresh
    cold solve, then five warm ticks with the state drifting. (On the
    worse-conditioned scenarios of ``_lazy``, with random attitude, rates
    and stance, any float32 loop, the plain one included, strays from the
    float64 loop by more than the 1e-3 tolerance.)"""
    scn = chip_smoke.random_scenarios(batch, seed, device)
    mu = scn.mu
    _, warm = admm.mpc_solve_cold(
        chip_smoke.condense(scn, scn.x0, dense=False),
        admm.ADMMSettings(seg_iters=40, segments=1, polish=False,
                          schulz_l0=1e-6, schulz_hi_tail=1),
        mu=mu, contacts=scn.contacts, foot_pos=scn.foot_pos)
    settings = admm.ADMMSettings(seg_iters=15, segments=1, polish=False,
                                 schulz_refine=1)
    drift = torch.zeros((batch, 13), device=device)
    drift[:, 9] = 0.001
    drift[:, 3] = 0.0005
    x0 = scn.x0
    for _ in range(5):
        x0 = x0 + drift
        qps = chip_smoke.condense(scn, x0, dense=True)
        ops, _ = admm_iterations.warm_batch_operands(qps, warm, mu, settings)
        _, warm = admm_iterations.mpc_solve_warm_batch(qps, warm, mu,
                                                       settings)
    return ops


def _plain_loop(ops, x, z, y, iters):
    """The plain ADMM loop (``admm._admm_iterations``) on ``ops``'
    operands, in their dtype."""
    mu = ops["mu"][:, None]
    return admm._admm_iterations(
        admm._minv_solve(ops["minv"]), x, z, y, ops["qbar"], ops["lb"],
        ops["ub"], ops["rho_vec"], iters, 1.6, 1e-6,
        lambda v: srb.constraint_matvec(v, mu),
        lambda v: srb.constraint_rmatvec(v, mu))


def _assert_k6_close(got, plain, ref64):
    """Per scenario: within 1e-3 of the plain loop and 2e-3 of the float64
    one."""
    assert torch.isfinite(got).all()
    assert float((got - plain).abs().amax(-1).max()) < 1e-3
    assert float((got.double() - ref64).abs().amax(-1).max()) <= 2e-3


@pytest.mark.parametrize("iters", [20, 80])
def test_k6_kernel_matches_plain(card, iters):
    ops = _k6_inputs(256, card)
    admm_iterations.reset_launches()
    x, y = admm_iterations.admm_iterations(**ops, iters=iters)
    assert admm_iterations.launches == 1
    xw, yw = admm_iterations.admm_iterations_plain(**ops, iters=iters,
                                                   alpha=1.6, sigma=1e-6)
    x64, _ = admm_iterations.admm_iterations_plain(
        **{k: v.double() for k, v in ops.items()}, iters=iters, alpha=1.6,
        sigma=1e-6)
    _assert_k6_close(x, xw, x64)
    assert torch.isfinite(y).all()
    assert bool(((y - yw).abs().amax(-1)
                 <= 0.1 * (1.0 + yw.abs().amax(-1))).all())


@pytest.mark.parametrize("iters", [20, 80])
def test_k6_loop_from_a_carried_iterate_matches_plain(card, iters):
    """``admm_loop`` (the solver's segments and warm ticks) starts from a
    carried z, not clip(C x0): ten plain iterations in, K6 against the
    plain loop on x, z and y."""
    ops = _k6_inputs(256, card)
    z0 = torch.clamp(srb.constraint_matvec(ops["x0"], ops["mu"][:, None]),
                     ops["lb"], ops["ub"])
    x, z, y = _plain_loop(ops, ops["x0"], z0, ops["y0"], 10)
    admm_iterations.reset_launches()
    got = admm_iterations.admm_loop(ops["minv"], ops["qbar"], ops["lb"],
                                    ops["ub"], ops["rho_vec"], ops["mu"],
                                    x, z, y, iters, 1.6, 1e-6)
    assert admm_iterations.launches == 1
    want = _plain_loop(ops, x, z, y, iters)
    ops64 = {k: v.double() for k, v in ops.items()}
    want64 = _plain_loop(ops64, x.double(), z.double(), y.double(), iters)
    for g, w, w64 in zip(got[:2], want[:2], want64[:2]):
        _assert_k6_close(g, w, w64)
    assert bool(((got[2] - want[2]).abs().amax(-1)
                 <= 0.1 * (1.0 + want[2].abs().amax(-1))).all())


@pytest.fixture(scope="module")
def k6_ops():
    """K6's operands (``_k6_inputs``) at batch 512, made once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return _k6_inputs(512, torch.device("cuda"))


@pytest.mark.parametrize("iters", [20, 80])
@pytest.mark.parametrize("start", ["clip", "carried"])
@pytest.mark.parametrize("batch", [1, 2, 133, 512])
def test_k6_batches_match_plain(k6_ops, batch, start, iters):
    """K6's persistent grid at one scenario, two, a partial wave and 512,
    from clip(C x0) (the ``admm_iterations`` entry's start) and from a
    carried z ten plain iterations in (``admm_loop``'s), against the plain
    loop; each scenario bit-identical to the same scenario in the
    batch-512 launch."""
    o = k6_ops
    z = torch.clamp(srb.constraint_matvec(o["x0"], o["mu"][:, None]),
                    o["lb"], o["ub"])
    x, y = o["x0"], o["y0"]
    if start == "carried":
        x, z, y = _plain_loop(o, x, z, y, 10)
    launch = lambda n: admm_iterations._launch(
        o["minv"][:n], o["qbar"][:n], o["lb"][:n], o["ub"][:n],
        o["rho_vec"][:n], o["mu"][:n], x[:n],
        None if start == "clip" else z[:n], y[:n], iters, 1.6, 1e-6)
    admm_iterations.reset_launches()
    got = launch(batch)
    assert admm_iterations.launches == 1
    ops = {k: v[:batch] for k, v in o.items()}
    start_b = (x[:batch], z[:batch], y[:batch])
    want = _plain_loop(ops, *start_b, iters)
    want64 = _plain_loop({k: v.double() for k, v in ops.items()},
                         *(t.double() for t in start_b), iters)
    for g, w, w64 in zip(got[:2], want[:2], want64[:2]):
        _assert_k6_close(g, w, w64)
    assert bool(((got[2] - want[2]).abs().amax(-1)
                 <= 0.1 * (1.0 + want[2].abs().amax(-1))).all())
    for g, w in zip(got, launch(512)):
        assert torch.equal(g, w[:batch])


def test_k6_nan_stays_in_its_scenario(k6_ops):
    """A scenario with NaN in qbar comes back non-finite in x and y; the
    other scenarios of its launch are bit-identical to a clean launch."""
    line, passed = chip_smoke.k6_nan_check(k6_ops, batch=133, poisoned=66)
    assert passed, line


def test_k6_refuses_an_unaligned_inverse(card):
    ops = _k6_inputs(2, card)
    buf = torch.empty(2 * 120 * 120 + 1, device=card)
    minv = buf[1:].view(2, 120, 120)
    minv.copy_(ops["minv"])
    with pytest.raises(ValueError, match="aligned"):
        admm_iterations.admm_iterations(**dict(ops, minv=minv))


def test_new_wrappers_refuse_what_the_kernels_do_not_take(card):
    m = _balance_kkts(4, card)
    with pytest.raises(TypeError):
        schulz_batch.schulz_inverse_batch(m.double())
    with pytest.raises(ValueError):
        schulz_batch.schulz_inverse_batch(torch.eye(28, device=card).expand(
            4, 28, 28).contiguous())
    ops = _k6_inputs(4, card)
    ops["mu"] = ops["mu"].double()
    with pytest.raises(TypeError):
        admm_iterations.admm_iterations(**ops)


@pytest.mark.parametrize("inputs", ["innovation", "spread_spd"])
def test_k4_kernel_matches_plain(card, inputs):
    """K4 against its plain version: per matrix within 5e-4 x max|plain|
    on the spread-diagonal SPD matrices of tests/test_pallas_admm.py; on
    the EKF's innovation matrices (balanced condition ~3e4, where any
    two float32 summation orders differ by ~1e-3) within twice the plain
    version's own distance to the float64 schedule."""
    from go1_qp_mpc_controller_torch.ops import schulz_lanes

    from go1_qp_mpc_controller_torch.runtime import estimator

    coeffs = admm._scaled_schulz_coeffs(ekf.SINV_L0)
    if inputs == "innovation":
        predict = estimator.make_estimator_predict(
            types.default_robot_model(F32, card))
        m = predict(*_k2_inputs(256, card)[:10]).s_mat
    else:
        m = torch.tensor(chip_smoke.spread_spd(256, 28, 7), device=card)
    m = m.contiguous()
    schulz_lanes.reset_launches()
    got = schulz_lanes.schulz_inverse_lanes(m, coeffs)
    assert schulz_lanes.launches == 1
    want = schulz_lanes.schulz_inverse_lanes_plain(m, coeffs)
    ref = schulz_lanes.schulz_inverse_lanes_plain(m.double(), coeffs)
    assert torch.isfinite(got).all()
    rel = lambda x, r: float(((x.double() - r).abs().amax((1, 2))
                              / r.abs().amax((1, 2))).max())
    if inputs == "spread_spd":
        assert rel(got, want.double()) <= 5e-4
    else:
        assert rel(got, ref) <= max(5e-4, 2.0 * rel(want, ref))


def _near_symmetric(batch, device, seed=11):
    """Spread-diagonal SPD matrices made unsymmetric at round-off: each
    entry moved by at most two units in its last place, independently of
    its transpose."""
    import numpy as np
    m = chip_smoke.spread_spd(batch, 28, seed)
    ulps = np.random.default_rng(seed + 1).integers(-2, 3, m.shape)
    m = m * (1.0 + ulps * 2.0 ** -23).astype(np.float32)
    return torch.tensor(m, device=device)


@pytest.mark.parametrize("batch", [1, 33, 4096])
def test_k4_batches_on_a_matrix_symmetric_up_to_round_off(card, batch):
    """K4 at the estimator's batch, a partial wave and 4096, on matrices
    symmetric only up to round-off: per matrix within 5e-4 x max|plain|
    and max|S X - I| < 1e-3 (tests/test_pallas_admm.py:217-219)."""
    from go1_qp_mpc_controller_torch.ops import schulz_lanes

    m = _near_symmetric(batch, card)
    assert not torch.equal(m, m.transpose(1, 2))
    coeffs = admm._scaled_schulz_coeffs(ekf.SINV_L0)
    schulz_lanes.reset_launches()
    got = schulz_lanes.schulz_inverse_lanes(m, coeffs)
    assert schulz_lanes.launches == 1
    want = schulz_lanes.schulz_inverse_lanes_plain(m, coeffs)
    assert torch.isfinite(got).all()
    rel = ((got - want).abs().amax((1, 2)) / want.abs().amax((1, 2))).max()
    assert float(rel) <= 5e-4
    eye = torch.eye(28, dtype=torch.float64, device=card)
    assert float((m.double() @ got.double() - eye).abs().max()) < 1e-3


def test_k4_takes_row_sums(card):
    """On a matrix whose balanced row sums are far above its column sums
    (row 0's off-diagonal entries tripled), three steps of K4 agree with
    the plain version, which takes row sums like the JAX body."""
    from go1_qp_mpc_controller_torch.ops import schulz_lanes

    m = chip_smoke.spread_spd(33, 28, 3)
    m[:, 0, 1:] *= 3.0
    m = torch.tensor(m, device=card)
    coeffs = admm._scaled_schulz_coeffs(ekf.SINV_L0)[:3]
    got = schulz_lanes.schulz_inverse_lanes(m, coeffs)
    want = schulz_lanes.schulz_inverse_lanes_plain(m, coeffs)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_ekf_auto_route_launches_k4_and_k2_plain_does_not(card):
    from go1_qp_mpc_controller_torch.ops import schulz_lanes

    args = _k2_inputs(64, card)
    x, p, quat, acc, gyro, qpos, qvel, ffoot, mode, dt, rho_opt, rho_fix = (
        args)
    rot = rotations.quat_to_rot_mat(quat)
    q_legs = qpos.reshape(64, 4, 3)
    fpr = kinematics.fk(q_legs, rho_opt, rho_fix)
    fvr = torch.einsum('blij,blj->bli', kinematics.jac(q_legs, rho_opt,
                                                       rho_fix),
                       qvel.reshape(64, 4, 3))
    schulz_lanes.reset_launches()
    auto = ekf.update_estimation(x, p, dt, rot, acc, gyro, fpr, fvr, ffoot,
                                 mode)
    assert schulz_lanes.launches == 1
    plain = ekf.update_estimation(x, p, dt, rot, acc, gyro, fpr, fvr, ffoot,
                                  mode, sinv="plain")
    observe_ekf.observe_ekf_plain(*args)
    assert schulz_lanes.launches == 1
    for a, b in zip(auto, plain):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 5e-4 * max(
            1.0, float(b.abs().max()))


@pytest.mark.parametrize("case", ["cold", "warm_accept", "warm_reject",
                                  "accept_0_steps", "reject_0_steps"])
def test_k5_kernel_matches_plain(card, case):
    """K5 (one cluster of 8 blocks) within 5e-6 of its float32 plain
    version and within ``chip_smoke.K5_EMU_TOL`` of the plain version
    with its 3xTF32 middle products."""
    from go1_qp_mpc_controller_torch.ops import schulz_balanced

    gen = torch.Generator().manual_seed(0)
    a = torch.randn((120, 120), generator=gen, dtype=torch.float64)
    m = a @ a.T / 120 + 3.0 * torch.eye(120, dtype=torch.float64)
    s = torch.rsqrt(torch.diagonal(m))
    mb = (m * s[:, None] * s[None, :]).to(card, F32).contiguous()
    cold = schulz_balanced.schulz_balanced_plain(mb, 20)
    iters, x0 = {"cold": (20, None),
                 "warm_accept": (4, (cold * (1.0 + 1e-3)).contiguous()),
                 "warm_reject": (20, torch.full((120, 120), 5.0,
                                                device=card)),
                 "accept_0_steps": (0, (cold * (1.0 + 1e-3)).contiguous()),
                 "reject_0_steps": (0, torch.full((120, 120), 5.0,
                                                  device=card))}[case]
    schulz_balanced.reset_launches()
    got = schulz_balanced.schulz_balanced(mb, iters, x0)
    assert schulz_balanced.launches == 1
    want = schulz_balanced.schulz_balanced_plain(mb, iters, x0)
    emu = schulz_balanced.schulz_balanced_plain(
        mb, iters, x0, middle_matmul=kkt_schulz.matmul_3xtf32)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 5e-6
    assert float((got - emu).abs().max()) <= chip_smoke.K5_EMU_TOL
    if case == "cold":
        eye = torch.eye(120, device=card)
        assert float((mb @ got - eye).abs().max()) < 1e-5


def test_k4_k5_wrappers_refuse_what_the_kernels_do_not_take(card):
    from go1_qp_mpc_controller_torch.ops import schulz_balanced, schulz_lanes

    coeffs = admm._scaled_schulz_coeffs(ekf.SINV_L0)
    eye = lambda n: torch.eye(n, device=card).expand(4, n, n).contiguous()
    with pytest.raises(ValueError):
        schulz_lanes.schulz_inverse_lanes(eye(12), coeffs)
    with pytest.raises(TypeError):
        schulz_lanes.schulz_inverse_lanes(eye(28).double(), coeffs)
    with pytest.raises(ValueError):
        schulz_balanced.schulz_balanced(torch.eye(28, device=card), 5)
    with pytest.raises(TypeError):
        schulz_balanced.schulz_balanced(
            torch.eye(120, device=card, dtype=torch.float64), 5)


def test_estimator_thread_launches_k4_each_frame(card):
    """The runtime's estimator thread on the card: one K4 launch a sensor
    frame, the estimate finite and near the standing root."""
    import numpy as np

    from go1_qp_mpc_controller_torch.ops import schulz_lanes
    from go1_qp_mpc_controller_torch.runtime import bridge, estimator, feeder

    model = types.default_robot_model(F32, card)
    params = types.default_ctrl_params(F32, card)
    b = bridge.RtBridge()
    try:
        fd = feeder.SimFeeder(b, model, params, height=0.3, device=card)
        ctrl = fd.initial_ctrl_state()
        est = estimator.EstimatorThread(b, model, ctrl.estimator_x,
                                        ctrl.estimator_P, time_scale=0.1)
        schulz_lanes.reset_launches()
        fd.start(duration_s=10.0)
        est.start(num_frames=20)
        est._thread.join(timeout=30.0)
        fd.stop()
        torch.cuda.synchronize()
        assert est.error is None and fd.error is None
        assert est.frames == 20 and schulz_lanes.launches == 20
        x, _, _ = est.snapshot()
        assert torch.isfinite(x).all()
        assert np.linalg.norm(x[0, :3].cpu().numpy() - fd.sim_root_pos) < 0.05
    finally:
        b.close()


def test_captured_runtime_steps_match_eager(card):
    """The runtime's CUDA-graph replays (the feeder's tick, the estimator's
    frame with K4 inside, the fast step, each route of the GRF solve)
    equal the same steps run eagerly on the same inputs, within 1e-6 x
    max(1, max|eager|); K4 on the estimator's (1, 28, 28) innovation
    matrix agrees with its plain version."""
    import numpy as np
    from torch.utils import _pytree as pytree

    from go1_qp_mpc_controller_torch.config import presets
    from go1_qp_mpc_controller_torch.runtime import estimator, feeder, loop

    def close(got, want):
        for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
            w = w.double()
            tol = 1e-6 * max(1.0, float(w.abs().max()))
            assert float((g.double() - w).abs().max()) <= tol

    model, params, static = presets.load_preset("gazebo_mpc", device=card)
    cl = loop.ControlLoop(model, params, static,
                          types.init_ctrl_state(model, 1, device=card),
                          estimate_in_feed=True)
    try:
        fd = feeder.SimFeeder(cl.bridge, model, params, device=card)
        tau = torch.full((1, 12), 0.3, device=card)
        close(fd._tick(fd._sim, fd._forces_z, tau)[1],
              fd._step_and_read(fd._sim, fd._forces_z, tau))

        cl.state = fd.initial_ctrl_state()
        cl.warmup()
        assert cl._fast is not None
        est = cl._est_ready
        # each graph against its eager step, and K4 on each frame's
        # innovation matrix against its plain version (chip_smoke's gate);
        # a frame after two dropped ones replays the same graphs with its
        # own dt
        predict = estimator.make_estimator_predict(model)
        coeffs = admm._scaled_schulz_coeffs(ekf.SINV_L0)
        for gap in (1, 3):
            frame = est._frame(np.concatenate([
                [0.999, 0.02, -0.01, 0.0], [0.1, -0.2, 9.7],
                [0.05, 0.0, -0.1], cl.state.joint_pos[0].cpu().numpy()
                + 0.01, np.zeros(12), [40.0, 60.0, 55.0, 45.0]]),
                gap * est.period)
            pred = predict(est._x, est._P, *est._split(frame), est._mode(1),
                           gap * est.period)
            close(est._step(est._x, est._P, frame, est._mode(1))[1],
                  ekf.correct(pred, ekf.innovation_inverse(pred.s_mat,
                                                           "auto")))
            readings, passed = chip_smoke.k4_check(
                pred.s_mat, coeffs, chip_smoke.K4_S_TOL,
                chip_smoke.K4_S_RES_TOL)
            assert passed, readings
        sensors = cl._sensor_data({"quat": [1.0, 0, 0, 0],
                                   "acc": [0.0, 0.0, 9.8],
                                   "gyro": np.zeros(3),
                                   "joint_pos": cl.state.joint_pos[0].cpu()
                                   .double().numpy(),
                                   "joint_vel": np.zeros(12),
                                   "foot_force": np.full(4, 50.0)})
        close(cl._fast(cl.state, sensors, cl.params)[1],
              cl.fast_step(cl.state, sensors, cl.params))
        parts = cl._grf_parts().parts
        args = (cl.state, cl.params)
        pre = parts["pre"][0](args, ())
        cl._grf(*args)
        for name in ("warm", "window", "cold", "health"):
            close(cl._grf.run(name), parts[name][0](args, (pre,)))
    finally:
        cl.close()


def test_captured_step_counts_replayed_kernel_launches(card):
    """A captured step that launches a counted kernel keeps its wrapper's
    counter honest: its warm-up runs count (and are summed apart), the
    capture counts nothing, every replay counts its launch; the replay
    equals the eager call."""
    from go1_qp_mpc_controller_torch.ops import schulz_lanes
    from go1_qp_mpc_controller_torch.utils import graphs

    coeffs = admm._scaled_schulz_coeffs(ekf.SINV_L0)
    fn = lambda s: schulz_lanes.schulz_inverse_lanes(s, coeffs)
    m = (torch.eye(28, device=card) * 2.0).expand(2, 28, 28).contiguous()
    schulz_lanes.reset_launches()
    graphs.reset_records()
    step = graphs.StagedStep(graphs.single(fn), m)
    torch.cuda.synchronize()
    assert schulz_lanes.launches == 2                  # the warm-up runs
    assert graphs.warmup_launches == {"schulz_lanes": (2, {})}
    assert step._graphs["step"][2] == {"schulz_lanes": (1, {})}
    for k in range(3):
        m_k = m * (1.0 + k)
        assert torch.equal(step(m_k)[1], fn(m_k))
    assert schulz_lanes.launches == 2 + 3 + 3
    assert graphs.replayed_launches == {"schulz_lanes": (3, {})}


def test_dense_paths_launch_k3_and_k6(card):
    """A polished cold transition tick of the batched controller runs the
    dense solve on K3; the dense warm batch tick runs K3 then K6."""
    model = types.default_robot_model(F32, card)
    params = types.default_ctrl_params(F32, card)
    carry = rollout.init_carry(model, params, 8, dtype=F32, device=card)
    schulz_batch.reset_launches()
    graphs.reset_records()
    _, trace = rollout.rollout_batched(carry, model, params, 2, 0.002,
                                       settings=admm.ADMMSettings(
                                           seg_iters=25, segments=3))
    torch.cuda.synchronize()
    # two cold ticks, 3 segments
    assert _ticks_launches(schulz_batch, "schulz_batch") == 2 * 3
    assert torch.isfinite(trace.foot_forces_grf).all()

    ops = _k1_operands(8, card)
    lazy_h = kkt_schulz.kkt_build_plain(*ops)
    qps = srb.CondensedQP(hessian=lazy_h, gradient=torch.zeros(
        (8, 120), device=card), lb=torch.zeros((8, 200), device=card),
        ub=torch.full((8, 200), 180.0, device=card))
    warm = admm.WarmState(x=torch.zeros((8, 120), device=card),
                          y=torch.zeros((8, 200), device=card),
                          rho=torch.full((8,), 0.1, device=card),
                          minv=torch.eye(120, device=card).expand(
                              8, 120, 120).contiguous())
    schulz_batch.reset_launches()
    admm_iterations.reset_launches()
    sol, _ = admm_iterations.mpc_solve_warm_batch(
        qps, warm, torch.full((8,), 0.3, device=card),
        admm.ADMMSettings(seg_iters=15, segments=1, polish=False))
    torch.cuda.synchronize()
    assert schulz_batch.launches == 1 and admm_iterations.launches == 1
    assert torch.isfinite(sol.x).all()


def test_k3_n12_matches_plain_on_riccati_matrices(card):
    """K3 at n = 12 on the matrices the stagewise Riccati pass hands it
    (every stage of the first pass of a cold H = 40 solve, batch 256, and
    each stage's first matrix alone, the one robot's batch), with the
    pass's scaled l0 = 1e-7 schedule: one launch a stage on the "n12"
    route, each within 3e-4 of the plain version per scenario."""
    g = chip_smoke.riccati_g(256, 5, card)
    coeffs = admm._scaled_schulz_coeffs(1e-7)
    for m in [s.contiguous() for stage in g for s in (stage, stage[:1])]:
        schulz_batch.reset_launches()
        got = schulz_batch.schulz_inverse_batch(m, coeffs=coeffs)
        assert schulz_batch.route_launches["n12"] == 1
        want = kkt_schulz.schulz_balanced_plain(m, None, coeffs)
        assert torch.isfinite(got).all()
        assert float(_balanced_error(got, want, m).max()) <= 3e-4


@pytest.mark.parametrize("route", ["dense", "fused"])
def test_sweep_routes_match_float64_at_batch_4096(card, route):
    """Each sweep route at batch 4096 on the card (the dense polished
    route on K3 and K6, the fused cold route on K1 and K6): the first 64
    scenarios' GRFs against the same solve in float64 on the CPU, within
    ``chip_smoke.f64_gate`` of the plain float32 version's distance."""
    from go1_qp_mpc_controller_torch.parallel import sweep

    settings = admm.ADMMSettings(**(chip_smoke.SWEEP_DENSE if route == "dense"
                                    else chip_smoke.SWEEP_FUSED))
    scn = sweep.random_scenarios(11, 4096, F32, card)
    for module in (kkt_schulz, schulz_batch, admm_iterations):
        module.reset_launches()
    out = sweep.make_sweep_fn(card, 0.0025, settings)(scn)
    torch.cuda.synchronize()
    if route == "dense":
        assert schulz_batch.launches == settings.segments
        assert kkt_schulz.launches == 0
    else:
        assert kkt_schulz.launches == 1 and schulz_batch.launches == 0
    assert admm_iterations.launches >= 1
    assert torch.isfinite(out.forces_all).all()
    head = sweep.take(scn, slice(0, 64))
    ref = {dt: sweep.make_sweep_fn("cpu", 0.0025, settings)(
        chip_smoke.on_cpu(head, dt)).grf
        for dt in (torch.float64, torch.float32)}
    card_gap = chip_smoke.grf_gap(out.grf[:64], ref[torch.float64])
    plain_gap = chip_smoke.grf_gap(ref[torch.float32], ref[torch.float64])
    assert chip_smoke.f64_gate(card_gap, plain_gap), (card_gap, plain_gap)


def test_stagewise_replay_equals_eager(card):
    """The stagewise solve with its iterations replayed as CUDA graphs
    equals the eager one bit for bit, and both launch K3 at n = 12 once a
    stage a Riccati pass (3 segments of a cold solve at H = 40)."""
    from go1_qp_mpc_controller_torch.ops import stagewise
    from go1_qp_mpc_controller_torch.parallel import sweep

    scn = sweep.random_scenarios(12, 64, F32, card)
    sols = {}
    for replay in (True, False):
        stagewise.REPLAY = replay
        try:
            schulz_batch.reset_launches()
            sols[replay] = chip_smoke.stagewise_chain(scn, 40, 2)
            torch.cuda.synchronize()
        finally:
            stagewise.REPLAY = True
        assert schulz_batch.route_launches["n12"] == 40 * (3 + 2)
    for got, want in zip(sols[True], sols[False]):
        assert torch.isfinite(got.u).all()
        assert torch.equal(got.u, want.u) and torch.equal(got.y, want.y)


def _mixed_route_ticks(device, batch, ticks, n_cold=5, h=40):
    """``ticks`` standing ticks of ``control_step(horizon=h)`` at ``batch``
    after a first all-cold tick, the first ``n_cold`` scenarios made young
    before each (a cold solve) and the others old (a warm tick). Returns
    (GRFs a tick, routes a tick)."""
    from go1_qp_mpc_controller_torch.ctrl import controller

    model = types.default_robot_model(F32, device)
    params = types.default_ctrl_params(F32, device)
    ctrl = rollout.init_carry(model, params, batch, dtype=F32, device=device,
                              horizon=h).ctrl
    kw = dict(settings=admm.ADMMSettings(**chip_smoke.LH_COLD),
              warm_settings=admm.ADMMSettings(**chip_smoke.LH_WARM),
              use_terrain_adapt=False, horizon=h)
    young = torch.arange(batch, device=device) < n_cold
    grfs, routes = [], []
    for tick in range(ticks + 1):
        if tick:
            ctrl = ctrl._replace(mpc_init_counter=torch.where(
                young, 0, 1000).to(ctrl.mpc_init_counter.dtype))
        stats = {}
        ctrl = controller.control_step(ctrl, model, params, 0.002,
                                       stats=stats, **kw)
        grfs.append(ctrl.foot_forces_grf.clone())
        routes.append(stats)
    return grfs, routes


def test_stagewise_routed_batch_captures_each_bucket_once(card, monkeypatch):
    """A routed tick at H = 40 splits the batch into cold and warm
    sub-batches: each replays at its power-of-two bucket, so a run of
    ticks with the same split captures each (bucket, schedule) once, holds
    no more memory after its first mixed ticks, and gives the GRFs of the
    eager solve (1e-3 N; the padding changes only the batched products'
    batch count)."""
    from go1_qp_mpc_controller_torch.ops import stagewise
    from go1_qp_mpc_controller_torch.utils import graphs

    captured = []

    class Counted(graphs.StagedStep):
        def __init__(self, stages, u, *rest):
            captured.append(tuple(u.shape))
            super().__init__(stages, u, *rest)

    monkeypatch.setattr(stagewise.graphs, "StagedStep", Counted)
    monkeypatch.setattr(stagewise, "_captured", {})
    batch, ticks = 200, 8
    got, routes = _mixed_route_ticks(card, batch, 2)
    torch.cuda.synchronize()
    before, n_before = torch.cuda.memory_allocated(card), len(captured)
    more, more_routes = _mixed_route_ticks(card, batch, ticks)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated(card) - before
    assert routes[0] == {"cold": batch}
    assert all(r == {"cold": 5, "warm": batch - 5}
               for r in routes[1:] + more_routes[1:])
    # the all-cold tick pads 200 to 256; the mixed ticks replay the 5 cold
    # scenarios at 8 and the 195 warm ones at 256
    assert sorted(set(captured)) == [(8, 40, 12), (256, 40, 12)]
    assert len(captured) == n_before == 3, captured
    assert grown < 1 << 20, grown
    monkeypatch.setattr(stagewise, "REPLAY", False)
    eager, _ = _mixed_route_ticks(card, batch, ticks)
    for a, b in zip(more, eager):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)


def test_rl_paths_on_the_card(card, monkeypatch):
    """``chip_smoke.rl_phase`` at batch 64 and one span: the RL rollout's
    captured ticks launch no counted kernel, meet tests/test_rl.py's
    criteria on every scenario and hold the CPU float64 run's first
    scenarios (the phase's gates)."""
    monkeypatch.setattr(chip_smoke, "RL_BATCH", 64)
    monkeypatch.setattr(chip_smoke, "RL_SPANS", 1)
    _, lines, passed = chip_smoke.rl_phase(0, card, "card")
    assert passed, lines


def test_rl_loop_halves_match_eager_and_launch_k4_each_tick(card):
    """The RL loop on the card: its two captured halves equal the same
    functions run eagerly on the same inputs (within 1e-6 x max(1,
    max|eager|)), and each action tick launches K4 once."""
    import numpy as np
    from torch.utils import _pytree as pytree

    from go1_qp_mpc_controller_torch.models import policy
    from go1_qp_mpc_controller_torch.ops import schulz_lanes
    from go1_qp_mpc_controller_torch.runtime import rl_loop

    def close(got, want):
        for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
            w = w.double()
            tol = 1e-6 * max(1.0, float(w.abs().max()))
            assert float((g.double() - w).abs().max()) <= tol

    model = types.default_robot_model(F32, card)
    actor = policy.init_mlp(torch.Generator().manual_seed(0), device=card)
    loop = rl_loop.RLControlLoop(model, actor, hardware=False)
    try:
        loop.warmup()
        joints = np.array([0.0, 0.8, -1.6] * 4)
        sensors = {"quat": [0.999, 0.02, -0.01, 0.0], "acc": [0.1, -0.2, 9.7],
                   "gyro": [0.05, 0.0, -0.1], "joint_pos": joints,
                   "joint_vel": np.zeros(12),
                   "foot_force": [40.0, 60.0, 55.0, 45.0]}
        x, p = loop._init_estimate(sensors)
        frame = loop._frame(sensors, [0.3, 0.0, 0.0], True)
        pred = loop._pre_fn(x, p, frame, loop.rl_state)
        close(loop._pre(x, p, frame, loop.rl_state)[1], pred)
        s_inv = ekf.innovation_inverse(pred.s_mat, "plain")
        close(loop._post(pred, s_inv, loop.rl_state, frame)[1],
              loop._post_fn(pred, s_inv, loop.rl_state, frame))
        schulz_lanes.reset_launches()
        for k in range(5):
            loop.bridge.push_sensors(*[np.asarray(sensors[key]) for key in
                                       ("quat", "acc", "gyro", "joint_pos",
                                        "joint_vel", "foot_force")])
            loop.toggle = k == 2
            assert loop.run(num_ticks=k + 1) == k + 1
        torch.cuda.synchronize()
        assert schulz_lanes.launches == 5
        assert int(loop.rl_state.movement_mode[0]) == 1
        _, cmd = loop.bridge.read_command()
        assert np.isfinite(cmd["q"]).all()
    finally:
        loop.close()


def test_replay_reproduces_the_recorded_trot(card, monkeypatch):
    """``chip_smoke.replay_phase`` on a 150-tick recording (the walk from
    tick 100): the replayed torques and GRFs are the recorded rollout's
    within ``chip_smoke.REPLAY_TOL``, K1, K2, K3 and K6 launched, and the
    joint-signal replay tracks its signal."""
    monkeypatch.setattr(chip_smoke, "REPLAY_TICKS", 150)
    _, lines, passed = chip_smoke.replay_phase(card, "card")
    assert passed, lines


def test_captured_one_robot_ticks_equal_eager(card, monkeypatch):
    """``chip_smoke.captured_steps_phase`` at 140 ticks: the captured
    one-robot MPC and balance-QP ticks equal the eager composition of the
    same parts bit for bit, with equal launches per kernel and route and
    equal route sequences (warm, window, cold and a health re-solve)."""
    monkeypatch.setattr(chip_smoke, "CAPTURED_TICKS", 140)
    monkeypatch.setattr(chip_smoke, "CAPTURED_WALK_AT", 60)
    monkeypatch.setattr(chip_smoke, "CAPTURED_POISON_AT", 50)
    monkeypatch.setattr(chip_smoke, "CAPTURED_PROFILE_TICKS", 5)
    _, lines, passed = chip_smoke.captured_steps_phase(card, "card")
    assert passed, lines

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Builds the port's CUDA kernels from ``go1_qp_mpc_controller_torch/csrc``,
holds each against its plain PyTorch version on the card at the main
path's shapes, then drives the main path (the batched closed-loop
controller tick, ``envs.rollout.rollout_batched``) at batch 4096 and checks
that it walks and that it went through the kernels. Each phase prints one
line; the last line is ``{"ok": true, "device": {...}}`` and is printed
only when every phase passed.

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero
                                     # when there is none or a phase fails
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): FP32 outside the
# tensor cores and HBM3 bandwidth. Every kernel here runs FP32 FMA.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
N = 120           # MPC decision variables
F32 = 4           # bytes
# the main path's size: the JAX bench's batch; ~130 ticks of trot onset and
# a full gait cycle, then 120 timed ticks (one full gait cycle at the
# default counters, so every route appears at its steady frequency), then
# 60 ticks (half a cycle: one contact flip and its window) under the
# profiler
BATCH = 4096
ONSET_TICKS = 130
TIMED_TICKS = 120
PROFILE_TICKS = 60
REPS = 5          # launches per kernel timing
# scenarios whose carried contact pattern is flipped to drive the
# compacted cold sub-batch route, and the ticks allowed to find it
COMPACT_SCENARIOS = (0, 1000, 2047, 3000, 4095)
COMPACT_TRIES = 8


def _fail(msg):
    print(f"FAIL {msg}", flush=True)
    return 1


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi gave no answer: " + out.stderr.strip())


def cuda_ms(fn, reps=5):
    """Mean device time of ``fn()`` in ms (CUDA events), after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of the FLOP time at the FP32 peak
    and the byte time at the HBM peak."""
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def random_kkt_operands(batch, gen, device):
    """K1 operands of ``batch`` seeded random MPC scenarios around the
    standing pose, condensed by the port's own ``srb``."""
    import torch
    from go1_qp_mpc_controller_torch.models import srb, types
    from go1_qp_mpc_controller_torch.ops import admm
    from go1_qp_mpc_controller_torch.utils import rotations

    f32 = torch.float32
    rn = lambda *s: torch.randn(s, generator=gen, dtype=f32).to(device)
    model = types.default_robot_model(f32, device)
    params = types.default_ctrl_params(f32, device)
    euler = 0.1 * rn(batch, 3)
    rot = rotations.euler_to_rot_mat(euler)
    feet = (model.default_foot_pos + 0.03 * rn(batch, 4, 3)) @ rot.transpose(
        -1, -2)
    patterns = torch.tensor([[1, 1, 1, 1], [1, 0, 0, 1], [0, 1, 1, 0],
                             [1, 1, 1, 0]], dtype=torch.bool)
    pick = torch.randint(0, 4, (batch,), generator=gen)
    contacts = patterns[pick].to(device)
    pos = torch.tensor([0.0, 0.0, 0.3], dtype=f32, device=device) \
        + 0.01 * rn(batch, 3)
    x0 = srb.mpc_state(euler, pos, 0.2 * rn(batch, 3), 0.2 * rn(batch, 3))
    zero3 = torch.zeros((batch, 3), dtype=f32, device=device)
    vel_d = torch.tensor([0.25, 0.0, 0.0], dtype=f32,
                         device=device).expand(batch, 3)
    x_ref = srb.reference_trajectory(pos, euler, pos, zero3, zero3, vel_d,
                                     params.mpc_dt)
    a_d, b_d = srb.discretize(
        srb.calculate_A_c(euler),
        srb.calculate_B_c(model.mass, model.trunk_inertia, rot, feet),
        params.mpc_dt)
    lazy = srb.condense_nilpotent_lazy(a_d, b_d, x0, x_ref,
                                       params.q_weights, params.r_weights,
                                       contacts)
    rho = torch.exp(math.log(0.02) + math.log(50.0) * torch.rand(
        (batch,), generator=gen)).to(device=device, dtype=f32)
    eq = torch.isclose(lazy.lb, lazy.ub)
    rho_vec = torch.where(eq, (rho * 1e3)[:, None], rho[:, None])
    return admm._kkt_kernel_operands(lazy, rho_vec, 1e-6, 0.3)


def k1_phase(batch, gen, device, reps):
    """K1 against its plain version: cold l0=1e-3, and warm refine=1 and
    l0=1e-4 from a warm start (an eighth of the batch given a start that
    fails the basin test). Returns (record for the kernels line, lines,
    passed)."""
    import torch
    from go1_qp_mpc_controller_torch.ops import admm, kkt_schulz

    ops = random_kkt_operands(batch, gen, device)
    coeffs = admm._scaled_schulz_coeffs
    x_good = kkt_schulz.kkt_schulz(*ops, coeffs=coeffs(1e-4))
    bad = (torch.arange(batch, device=device) % 8 == 0)[:, None, None]
    x0 = torch.where(bad, -x_good, x_good).contiguous()

    # basin test as the kernel runs it, to count this run's products
    m = kkt_schulz.kkt_build_plain(*ops)
    s = torch.rsqrt(torch.diagonal(m, dim1=-2, dim2=-1))
    unb = s[:, :, None] * s[:, None, :]
    inner = (m * unb) @ (x0 / unb)
    ok = ((torch.diagonal(inner, dim1=-2, dim2=-1).amin(-1) > 1e-4)
          & (inner.abs().sum(-1).amax(-1) < 3.0))
    n_ok = int(ok.sum())

    in_bytes = batch * (4 * 12 * N + 3 * N + 1) * F32
    mat_bytes = batch * N * N * F32
    build_flops = batch * N * N * 9.0
    prod = 2.0 * N ** 3
    variants = {
        "cold_l0=1e-3": (None, coeffs(1e-3)),
        "warm_refine=1": (x0, (1.0,)),
        "warm_l0=1e-4": (x0, coeffs(1e-4)),
    }
    mb = m * unb
    eye = torch.eye(N, dtype=mb.dtype, device=device)
    lines, records = [], {}
    for name, (xw, sched) in variants.items():
        got = kkt_schulz.kkt_schulz(*ops, x0=xw, coeffs=sched)
        want = kkt_schulz.kkt_schulz_plain(*ops, x0=xw, coeffs=sched)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        median = float(want.abs().median())
        # the gate: the error per scenario, relative to that scenario's
        # largest entry, in balanced coordinates (X_b = S^-1 X S^-1). There
        # every block of the inverse is O(1), so the small blocks of the
        # equality (swing-leg) rows weigh as much as the large ones, and a
        # low-scale scenario as much as the largest.
        got_b, want_b = got / unb, want / unb
        err_b = ((got_b - want_b).abs().amax((1, 2))
                 / want_b.abs().amax((1, 2)))
        worst_b = float(err_b.max())
        # balanced residual inf-norm ||M_b X_b - I|| of each, per scenario
        res = lambda xb: (mb @ xb - eye).abs().sum(-1).amax(-1)
        res_k, res_p = res(got_b), res(want_b)
        res_gap = float((res_k - res_p).abs().max())
        tol = 3e-4
        finite = bool(torch.isfinite(got).all())
        kernel_ms = cuda_ms(lambda: kkt_schulz.kkt_schulz(
            *ops, x0=xw, coeffs=sched), reps)
        plain_ms = cuda_ms(lambda: kkt_schulz.kkt_schulz_plain(
            *ops, x0=xw, coeffs=sched), reps)
        n = len(sched)
        if xw is None:
            products = batch * 2 * (n - 1) if sched[0] != 1.0 \
                else batch * 2 * n
            nbytes = in_bytes + mat_bytes
        else:
            products = (batch + n_ok) + batch * 2 * (n - 1)
            nbytes = in_bytes + 2 * mat_bytes
        bound_ms, bound_by = bound(products * prod + build_flops, nbytes)
        passed = finite and worst_b <= tol
        lines.append(
            f"K1 {name}: batch {batch}, {n} steps, basin-accepted "
            f"{n_ok if xw is not None else 0}/{batch}, max_abs_err {err:.3e}"
            f" (relative to max|plain| {rel:.3e}; median|plain| "
            f"{median:.3e}); worst per-scenario balanced error {worst_b:.3e}"
            f" (tolerance {tol:g} x the scenario's max|plain_b|); balanced "
            f"residual max kernel {float(res_k.max()):.3e} plain "
            f"{float(res_p.max()):.3e}, largest gap {res_gap:.3e}; "
            f"kernel_ms {kernel_ms:.4f}, plain_ms {plain_ms:.4f}, "
            f"bound_ms {bound_ms:.4f} ({bound_by}) "
            f"{'PASS' if passed else 'FAIL'}")
        records[name] = dict(err=err, kernel_ms=kernel_ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, passed=passed)
    library_ms = cuda_ms(lambda: torch.linalg.inv(m), reps)
    lines.append(f"K1 library yardstick: torch.linalg.inv on the "
                 f"materialized batch of M (inverse only, not the build): "
                 f"library_ms {library_ms:.4f}")
    warm = records["warm_refine=1"]
    record = {
        "name": "kkt_schulz", "route": "cuda",
        "source": "go1_qp_mpc_controller_torch/csrc/kkt_schulz.cu",
        "replaces": "go1_qp_mpc_controller_tpu/ops/pallas_admm.py:394",
        "max_abs_err": max(r["err"] for r in records.values()),
        "ms": warm["kernel_ms"], "plain_ms": warm["plain_ms"],
        "bound_ms": warm["bound_ms"], "bound_by": warm["bound_by"],
        "library_ms": library_ms}
    return record, lines, all(r["passed"] for r in records.values())


def random_ekf_inputs(batch, gen, device):
    """Seeded random observe + EKF inputs (the JAX package's
    tests/test_pallas_ekf.py distribution)."""
    import torch
    from go1_qp_mpc_controller_torch.models import kinematics
    from go1_qp_mpc_controller_torch.ops import ekf
    from go1_qp_mpc_controller_torch.utils import rotations

    f32 = torch.float32
    rn = lambda *s: torch.randn(s, generator=gen, dtype=f32)
    quat = 0.1 * rn(batch, 4)
    quat[:, 0] += 1.0
    acc = rn(batch, 3)
    gyro = 0.5 * rn(batch, 3)
    qpos = torch.tensor([0.0, 0.8, -1.6] * 4) + 0.2 * rn(batch, 12)
    qvel = rn(batch, 12)
    ffoot = 120.0 * torch.rand((batch, 4), generator=gen)
    mode = (torch.rand((batch,), generator=gen) > 0.5).to(torch.int32)
    geom = kinematics.a1_leg_geometry(f32, "cpu")
    x0, p0 = ekf.init_state(rotations.quat_to_rot_mat(quat),
                            kinematics.foot_positions_body(qpos, geom))
    p0 = p0 + 0.01 * rn(batch, 18, 18)
    p0 = 0.5 * (p0 + p0.transpose(1, 2)) + 3.0 * torch.eye(18)
    args = [t.to(device).contiguous() for t in
            (x0, p0, quat, acc, gyro, qpos, qvel, ffoot, mode)]
    return args + [0.002, geom.rho_opt.to(device), geom.rho_fix.to(device)]


def k2_phase(batch, gen, device, reps):
    """K2 against its plain version on all 11 outputs."""
    import torch
    from go1_qp_mpc_controller_torch.ops import observe_ekf

    args = random_ekf_inputs(batch, gen, device)
    got = observe_ekf.observe_ekf(*args)
    want = observe_ekf.observe_ekf_plain(*args)
    torch.cuda.synchronize()
    worst, max_err, passed = 0.0, 0.0, True
    for name, _ in observe_ekf.OUTPUTS:
        tol = 5e-4 if name in ("x", "P") else 1e-5
        w = want[name].float()
        err = float((got[name] - w).abs().max())
        atol = tol * max(1.0, float(w.abs().max()))
        passed &= bool(torch.isfinite(got[name]).all()) and err <= atol
        worst = max(worst, err / atol)
        max_err = max(max_err, err)
    kernel_ms = cuda_ms(lambda: observe_ekf.observe_ekf(*args), reps)
    plain_ms = cuda_ms(lambda: observe_ekf.observe_ekf_plain(*args), reps)
    # bytes: each input read once, each output written once
    in_floats = 18 + 324 + 4 + 3 + 3 + 12 + 12 + 4 + 1
    out_floats = sum(math.prod(shape) for _, shape in observe_ekf.OUTPUTS)
    nm, ns = 28, 18
    flops_per = (22 * 2 * nm ** 3            # Schulz, first step folded
                 + 2 * ns * nm * nm          # gain K = P C' S^-1
                 + 2 * 2 * ns ** 3           # (I - K C) P (I - K C)'
                 + 2 * ns * ns * nm          # K R K'
                 + 2 * ns * nm)              # K err
    bound_ms, bound_by = bound(batch * flops_per,
                               batch * (in_floats + out_floats) * F32)
    line = (f"K2 observe+EKF: batch {batch}, 11 outputs, max_abs_err "
            f"{max_err:.3e} (worst err/tolerance {worst:.3f}; tolerance "
            f"5e-4 on x, P and 1e-5 elsewhere, x max(1, max|plain|)), "
            f"kernel_ms {kernel_ms:.4f}, plain_ms {plain_ms:.4f}, "
            f"bound_ms {bound_ms:.4f} ({bound_by}) "
            f"{'PASS' if passed else 'FAIL'}")
    record = {
        "name": "observe_ekf", "route": "cuda",
        "source": "go1_qp_mpc_controller_torch/csrc/observe_ekf.cu",
        "replaces": "go1_qp_mpc_controller_tpu/ops/pallas_ekf.py:280",
        "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    return record, [line], passed


def profile_lines(run, ticks, wall_ms_per_tick):
    """Device time by kernel over ``run()`` (``ticks`` more main-path
    ticks) from torch.profiler: device time per tick against the
    un-profiled wall time per tick ``wall_ms_per_tick`` (the profiler's own
    host overhead inflates the profiled wall time), and the kernels that
    take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        name = ev.name.replace("(anonymous namespace)::", "").split("(")[0]
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + end - start, cnt + 1)
    if not spans:
        return ["profile: torch.profiler recorded no device events"]
    busy, last = 0.0, -math.inf
    for start, end in sorted(spans):        # union of kernel intervals
        if end > last:
            busy += end - max(start, last)
            last = end
    total = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    per_tick = busy / 1e3 / ticks
    lines = [f"profile: {ticks} ticks, device busy {per_tick:.3f} ms a tick "
             f"({100 * per_tick / wall_ms_per_tick:.1f}% of the "
             f"{wall_ms_per_tick:.3f} ms un-profiled wall time a tick; "
             f"profiled wall {wall_us / 1e3 / ticks:.3f} ms a tick), "
             f"{len(spans) / ticks:.0f} kernel launches a tick"]
    lines += [f"profile: {t / 1e3 / ticks:.3f} ms a tick ({100 * t / total:.1f}%"
              f") in {c / ticks:g} launches a tick: {name[:80]}"
              for name, (t, c) in top]
    return lines


def main_path_phase(batch, onset_ticks, timed_ticks, seed, device,
                    profile_ticks, card):
    """``rollout_batched`` at ``batch``: a seeded perturbed standing start
    commanded to trot at 0.25 m/s from the first tick (as the JAX bench
    does), ``onset_ticks`` untimed then ``timed_ticks`` timed, then the
    ticks that drive the compacted cold sub-batch route, then
    ``profile_ticks`` more under torch.profiler (after the launch counts
    are read). Returns (launch counts, lines, passed)."""
    import torch
    from go1_qp_mpc_controller_torch.envs import rollout
    from go1_qp_mpc_controller_torch.models import types
    from go1_qp_mpc_controller_torch.ops import admm, kkt_schulz, observe_ekf

    f32 = torch.float32
    # the JAX bench's cold transition settings (bench.py settings_cold_ctrl)
    settings = admm.ADMMSettings(seg_iters=30, segments=2,
                                 first_seg_iters=20, polish=False,
                                 schulz_l0=1e-6, schulz_l0_first=1e-3,
                                 schulz_l0_refine=1e-4, schulz_hi_tail=1,
                                 schulz_impl="pallas")
    model = types.default_robot_model(f32, device)
    params = types.default_ctrl_params(f32, device)
    carry = rollout.init_carry(model, params, batch, dtype=f32,
                               device=device)
    gen = torch.Generator().manual_seed(seed)
    dz = 0.01 * torch.randn((batch,), generator=gen)
    dv = 0.02 * torch.randn((batch, 3), generator=gen)
    sim = carry.sim._replace(
        root_pos=carry.sim.root_pos + torch.nn.functional.pad(
            dz[:, None], (2, 0)).to(device),
        root_lin_vel=carry.sim.root_lin_vel + dv.to(device))
    vel = torch.tensor([0.25, 0.0, 0.0], dtype=f32, device=device)
    ctrl = carry.ctrl._replace(
        movement_mode=torch.ones_like(carry.ctrl.movement_mode),
        root_lin_vel_d=vel.expand(batch, 3).clone())
    carry = carry._replace(sim=sim, ctrl=ctrl)

    kkt_schulz.reset_launches()
    observe_ekf.reset_launches()
    onset_stats, timed_stats = {}, {}
    t0 = time.perf_counter()
    carry, tr_onset = rollout.rollout_batched(
        carry, model, params, onset_ticks, 0.002, settings=settings,
        stats=onset_stats)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    carry, tr = rollout.rollout_batched(
        carry, model, params, timed_ticks, 0.002, settings=settings,
        stats=timed_stats)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # the compacted cold sub-batch route: the trot keeps the batch in lock
    # step, so no tick above flags 1..128 scenarios by itself. Flip the
    # carried contact pattern of a few scenarios (as a lone early touchdown
    # would) and tick until a tick takes that route: a tick on which the
    # whole batch transitions overflows to whole-batch cold instead.
    flip = torch.tensor([i for i in COMPACT_SCENARIOS if i < batch],
                        device=device)
    compact_stats, compact_tries, compact_k1, tr_c = {}, 0, None, None
    while compact_k1 is None and compact_tries < COMPACT_TRIES:
        qc = carry.ctrl.qp_warm_contacts.clone()
        qc[flip] = ~qc[flip]
        carry = carry._replace(ctrl=carry.ctrl._replace(qp_warm_contacts=qc))
        k1_before, tick_stats = kkt_schulz.launches, {}
        carry, tr_c = rollout.rollout_batched(
            carry, model, params, 1, 0.002, settings=settings,
            stats=tick_stats)
        compact_tries += 1
        for route, n in tick_stats.items():
            compact_stats[route] = compact_stats.get(route, 0) + n
        if tick_stats == {"compact": 1}:
            compact_k1 = kkt_schulz.launches - k1_before
    torch.cuda.synchronize()
    counts = {"kkt_schulz": kkt_schulz.launches,
              "observe_ekf": observe_ekf.launches}

    ticks = onset_ticks + timed_ticks + compact_tries
    finite = all(bool(torch.isfinite(getattr(t, f)).all())
                 for t in (tr_onset, tr, tr_c) for f in
                 ("root_pos", "root_euler", "joint_torques",
                  "foot_forces_grf"))
    z = tr.root_pos[..., 2]
    tilt = torch.sqrt(tr.root_euler[..., 0] ** 2 + tr.root_euler[..., 1] ** 2)
    healthy = ((z >= 0.25) & (z <= 0.35) & (tilt < 0.25)).all(0)
    share = float(healthy.float().mean())
    contacts = torch.cat([tr_onset.contacts, tr.contacts])
    flipped = bool((contacts != contacts[:1]).any())
    vx = float(tr.root_lin_vel[..., 0].mean())
    rate = batch * timed_ticks / (t2 - t1)
    checks = {
        "finite": finite, "healthy_share>=0.99": share >= 0.99,
        "contacts_flipped": flipped,
        "compact_route_taken": compact_k1 is not None,
        # the base program's launch, then one for each cold segment
        "compact_tick_k1_launches==1+segments":
            compact_k1 == 1 + settings.segments,
        "k2_launches==ticks": counts["observe_ekf"] == ticks,
        "k1_launches>=ticks": counts["kkt_schulz"] >= ticks}
    lines = [
        f"main path: rollout_batched batch {batch}, trot 0.25 m/s, "
        f"{onset_ticks} onset ticks ({t1 - t0:.3f} s) + {timed_ticks} "
        f"timed ticks ({t2 - t1:.3f} s): {rate:.1f} scenario-ticks/s, "
        f"{timed_ticks / (t2 - t1):.2f} ticks/s on {card}",
        f"main path routes: onset {json.dumps(onset_stats)}, timed "
        f"{json.dumps(timed_stats)}, then {compact_tries} ticks with "
        f"{len(flip)} carried contact patterns flipped "
        f"{json.dumps(compact_stats)} (K1 launches on the compact tick: "
        f"{compact_k1}); launches over {ticks} ticks {json.dumps(counts)}",
        f"main path health: healthy share {share:.4f} (height in "
        f"[0.25, 0.35] and tilt < 0.25 rad over the timed ticks), mean vx "
        f"{vx:.4f} m/s, checks {json.dumps(checks)} "
        f"{'PASS' if all(checks.values()) else 'FAIL'}"]
    lines += profile_lines(lambda: rollout.rollout_batched(
        carry, model, params, profile_ticks, 0.002, settings=settings),
        profile_ticks, (t2 - t1) * 1e3 / timed_ticks)
    return counts, lines, all(checks.values())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of every random input")
    args = parser.parse_args(argv)

    try:
        import torch
    except ImportError:
        return _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return _fail("no CUDA device: this smoke test runs only on a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "go1_qp_mpc_controller_torch")):
        return _fail("the go1_qp_mpc_controller_torch package is not beside "
                     "this script")
    sys.path.insert(0, here)
    from go1_qp_mpc_controller_torch.ops import _build
    from go1_qp_mpc_controller_torch.utils.device import pin_f32_matmuls

    pin_f32_matmuls()
    device = torch.device("cuda")
    card = card_line()
    print(f"env: card {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; allow_tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}; float32 matmul precision "
          f"{torch.get_float32_matmul_precision()}", flush=True)
    t0 = time.perf_counter()
    try:
        logs = _build.build_all()
    except RuntimeError as exc:
        print(exc)
        return _fail("kernel build")
    ptxas = [line.strip() for log in logs.values()
             for line in log.splitlines()
             if "registers" in line or "spill" in line]
    print(f"build: {', '.join(_build.KERNELS)} with nvcc in "
          f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}; "
          + " | ".join(ptxas), flush=True)

    ok = True
    records = []
    phases = [
        ("K1", lambda: k1_phase(BATCH,
                                torch.Generator().manual_seed(args.seed),
                                device, REPS)),
        ("K2", lambda: k2_phase(BATCH,
                                torch.Generator().manual_seed(args.seed + 1),
                                device, REPS)),
    ]
    for name, phase in phases:
        try:
            record, lines, passed = phase()
            records.append(record)
            for line in lines:
                print(line, flush=True)
            ok &= passed
        except Exception:     # report the phase and go on to the next
            traceback.print_exc()
            print(f"FAIL {name} phase raised", flush=True)
            ok = False
    try:
        counts, lines, passed = main_path_phase(
            BATCH, ONSET_TICKS, TIMED_TICKS, args.seed, device,
            PROFILE_TICKS, card)
        for line in lines:
            print(line, flush=True)
        ok &= passed
        for record in records:
            record["launches"] = counts[record["name"]]
    except Exception:
        traceback.print_exc()
        print("FAIL main path phase raised", flush=True)
        ok = False
    if not ok:
        print("FAIL at least one phase failed; no result", flush=True)
        return 1
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

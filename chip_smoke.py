#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Builds the port's CUDA kernels from ``go1_qp_mpc_controller_torch/csrc``,
holds each against its plain PyTorch version on the card at the shapes
its paths give it, then drives each path through the entry points a user
calls, with every launch counter set to 0 just before the path and read
just after it:

- the main path: the batched closed-loop controller tick
  (``envs.rollout.rollout_batched``) at batch 4096 with the segmented cold
  settings (K1, K2, K6);
- the dense warm-tick chain: fresh cold solves (``admm.mpc_solve_cold``,
  K1, K6), then 40 warm ticks of ``admm_iterations.mpc_solve_warm_batch``
  (K3, K6) at batch 4096;
- one robot (``envs.rollout.rollout``, batch 1) trotting with the EKF and
  polished cold solves (K1, K2, K3, K6), then standing on the balance QP
  (K3);
- the batched tick with the polished cold settings (K1, K2, K3, K6).

Each phase prints its lines; the last line is ``{"ok": true, "device":
{...}}`` and is printed only when every phase passed.

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
# the dense warm-tick chain (the JAX bench's solver program, bench.py:
# 470-504): warm ticks after the fresh cold solve, and the scenarios held
# against the tight polished reference
CHAIN_TICKS = 40
TIGHT_SCENARIOS = 256
# one robot: standing, then trot at 0.25 m/s (tests/test_walking.py
# test_forward_trot_with_ekf), then the balance-QP stand (test_stand_qp_mode)
ROBOT_STAND_TICKS = 100
ROBOT_TICKS = 1200
ROBOT_PROFILE_TICKS = 60
QP_TICKS = 400
# the batched tick with polished cold solves: half a gait cycle timed
POLISHED_ONSET_TICKS = 130
POLISHED_TIMED_TICKS = 60
# the polished settings of main.py rollout and tests/test_walking.py
POLISHED = dict(seg_iters=25, segments=3)
# K6 per scenario: on x, within 1e-3 of its plain version (the tolerance
# of tests/test_pallas_admm.py:75-83) and within 1e-3 + 1e-3 of the same
# loop in float64 (the second 1e-3 for the float32 loop's own round-off on
# the QP's flat directions: the plain float32 loop is at most 7.3e-4 from
# float64 on the dense chain's operands on an H100); on y, within
# 0.1 (1 + max|y_plain|)
K6_TOL = 1e-3
K6_F64_TOL = 2e-3


def _fail(msg):
    print(f"FAIL {msg}", flush=True)
    return 1


def kernel_modules():
    """{kernel record name: its wrapper module (launch counter)}."""
    from go1_qp_mpc_controller_torch.ops import (admm_iterations,
                                                 kkt_schulz, observe_ekf,
                                                 schulz_batch)
    return {"kkt_schulz": kkt_schulz, "observe_ekf": observe_ekf,
            "schulz_batch": schulz_batch,
            "admm_iterations": admm_iterations}


def reset_counts():
    for module in kernel_modules().values():
        module.reset_launches()


def read_counts():
    import torch
    torch.cuda.synchronize()
    return {name: module.launches
            for name, module in kernel_modules().items()}


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
    n_ok = basin_accepted(m, x0)

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
        products = schulz_products(batch, xw, sched, n_ok)
        nbytes = in_bytes + (1 if xw is None else 2) * mat_bytes
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
    from go1_qp_mpc_controller_torch.ops import admm, kkt_schulz

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

    reset_counts()
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
    counts = read_counts()

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
        "k1_launches>=ticks": counts["kkt_schulz"] >= ticks,
        # every route ends in at least one ADMM loop on K6
        "k6_launches>=ticks": counts["admm_iterations"] >= ticks,
        "no_k3": counts["schulz_batch"] == 0}
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


def per_scenario_balanced_error(got, want, m):
    """Per-scenario error in balanced coordinates (X_b = S^-1 X S^-1,
    S = diag(M)^-1/2), relative to that scenario's largest balanced entry:
    every block of a balanced inverse is O(1)."""
    import torch
    s = torch.rsqrt(torch.diagonal(m, dim1=-2, dim2=-1))
    unb = s[:, :, None] * s[:, None, :]
    got_b, want_b = got / unb, want / unb
    return (got_b - want_b).abs().amax((1, 2)) / want_b.abs().amax((1, 2))


def random_balance_kkts(batch, gen, device):
    """K3's n = 12 operands: the KKT M = cost H + sigma I + C' diag(rho) C
    of seeded random balance QPs (``qp.build_balance_qp`` of random
    wrenches, yaws, foot positions and contact patterns), at rho = 0.1 and
    the 1e3 boost on equality rows, as ``admm.solve`` builds it."""
    import torch
    from go1_qp_mpc_controller_torch.ops import qp

    f32 = torch.float32
    rn = lambda *s: torch.randn(s, generator=gen, dtype=f32).to(device)
    acc = torch.tensor([0.0, 0.0, 147.0, 0.0, 0.0, 0.0], dtype=f32,
                       device=device) + 10.0 * rn(batch, 6)
    feet = torch.tensor([[0.17, 0.15, -0.3], [0.17, -0.15, -0.3],
                         [-0.17, 0.15, -0.3], [-0.17, -0.15, -0.3]],
                        dtype=f32, device=device) + 0.03 * rn(batch, 4, 3)
    from go1_qp_mpc_controller_torch.utils import rotations
    rot_z = rotations.rot_z(0.5 * rn(batch))
    contacts = (torch.rand((batch, 4), generator=gen) > 0.3).to(device)
    bqp = qp.build_balance_qp(acc, rot_z, feet, contacts)
    c = torch.tensor(qp.balance_constraint_matrix(), dtype=f32,
                     device=device)
    cost = 1.0 / bqp.hessian.abs().amax((1, 2))
    rho_vec = torch.where(torch.isclose(bqp.lb, bqp.ub), 100.0, 0.1)
    eye = torch.eye(12, dtype=f32, device=device)
    return (cost[:, None, None] * bqp.hessian + 1e-6 * eye
            + c.T @ (rho_vec[..., None] * c)).contiguous()


def schulz_products(batch, x0, coeffs, n_ok):
    """The n x n products a Schulz schedule needs for this run's data: 2 a
    step after the first; a cold schedule folds its first step (no
    product), a warm start takes the basin test's product for every
    scenario and the first step's second product for the accepted ones."""
    rest = batch * 2 * (len(coeffs) - 1)
    return rest if x0 is None else (batch + n_ok) + rest


def basin_accepted(m, x0):
    """How many scenarios' warm starts pass the basin test."""
    import torch
    s = torch.rsqrt(torch.diagonal(m, dim1=-2, dim2=-1))
    unb = s[:, :, None] * s[:, None, :]
    inner = (m * unb) @ (x0 / unb)
    ok = ((torch.diagonal(inner, dim1=-2, dim2=-1).amin(-1) > 1e-4)
          & (inner.abs().sum(-1).amax(-1) < 3.0))
    return int(ok.sum())


def k3_phase(batch, gen, device, reps):
    """K3 against its plain version: n = 120 KKTs (``kkt_build_plain`` of
    ``random_kkt_operands``) with the dense solve's 20 plain steps cold,
    the scaled l0 = 1e-6 schedule cold, and 20 steps from a warm start
    (an eighth of the batch given a start that fails the basin test);
    n = 12 balance-QP KKTs cold and warm with 20 plain steps. Gated per
    scenario in balanced coordinates. Returns (record, lines, passed)."""
    import torch
    from go1_qp_mpc_controller_torch.ops import admm, kkt_schulz, schulz_batch

    coeffs = admm._scaled_schulz_coeffs
    plain20 = (1.0,) * 20
    m120 = kkt_schulz.kkt_build_plain(*random_kkt_operands(batch, gen,
                                                           device))
    m12 = random_balance_kkts(batch, gen, device)
    bad = (torch.arange(batch, device=device) % 8 == 0)[:, None, None]

    def warm_start(m):
        good = schulz_batch.schulz_inverse_batch(m, coeffs=coeffs(1e-6))
        return torch.where(bad, -good, good).contiguous()

    x120, x12 = warm_start(m120), warm_start(m12)
    variants = {
        "n=120 cold 20 steps": (m120, None, plain20),
        "n=120 cold l0=1e-6": (m120, None, coeffs(1e-6)),
        "n=120 warm 20 steps": (m120, x120, plain20),
        "n=12 cold 20 steps": (m12, None, plain20),
        "n=12 warm 20 steps": (m12, x12, plain20),
    }
    tol = 3e-4
    lines, records = [], {}
    for name, (m, x0, sched) in variants.items():
        n = m.shape[-1]
        got = schulz_batch.schulz_inverse_batch(m, x0, sched)
        want = kkt_schulz.schulz_balanced_plain(m, x0, sched)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst_b = float(per_scenario_balanced_error(got, want, m).max())
        finite = bool(torch.isfinite(got).all())
        n_ok = basin_accepted(m, x0) if x0 is not None else 0
        kernel_ms = cuda_ms(lambda: schulz_batch.schulz_inverse_batch(
            m, x0, sched), reps)
        plain_ms = cuda_ms(lambda: kkt_schulz.schulz_balanced_plain(
            m, x0, sched), reps)
        library_ms = cuda_ms(lambda: torch.linalg.inv(m), reps)
        products = schulz_products(batch, x0, sched, n_ok)
        mats = 2 if x0 is None else 3
        bound_ms, bound_by = bound(products * 2.0 * n ** 3,
                                   mats * batch * n * n * F32)
        passed = finite and worst_b <= tol
        lines.append(
            f"K3 {name}: batch {batch}, {len(sched)} steps, basin-accepted "
            f"{n_ok}/{batch if x0 is not None else 0}, max_abs_err "
            f"{err:.3e}; worst per-scenario balanced error {worst_b:.3e} "
            f"(tolerance {tol:g}); kernel_ms {kernel_ms:.4f}, plain_ms "
            f"{plain_ms:.4f}, bound_ms {bound_ms:.4f} ({bound_by}), "
            f"library_ms {library_ms:.4f} (torch.linalg.inv of the same "
            f"matrices) {'PASS' if passed else 'FAIL'}")
        records[name] = dict(err=err, kernel_ms=kernel_ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms,
                             passed=passed)
    main = records["n=120 cold 20 steps"]
    record = {
        "name": "schulz_batch", "route": "cuda",
        "source": "go1_qp_mpc_controller_torch/csrc/schulz_batch.cu",
        "replaces": "go1_qp_mpc_controller_tpu/ops/pallas_admm.py:477",
        "max_abs_err": max(r["err"] for r in records.values()),
        "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"]}
    return record, lines, all(r["passed"] for r in records.values())


def random_scenarios(batch, seed, device):
    """Seeded random stand / trot MPC scenarios: the JAX package's
    ``parallel/sweep.random_scenarios`` distribution (mass, height,
    velocity command, friction and contact pattern randomized), made with
    numpy. Returns a dict of tensors on ``device``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    h = 10
    mass = rng.uniform(10.0, 18.0, batch)
    heights = rng.uniform(0.22, 0.32, batch)
    vel_cmd = rng.uniform([-0.5, -0.3, 0.0], [0.5, 0.3, 0.0], (batch, 3))
    mu = rng.uniform(0.25, 0.7, batch)
    contacts = rng.uniform(size=(batch, 4)) > 0.4
    contacts[contacts.sum(1) < 2] = True
    feet = np.tile(np.array([[0.17, 0.15, 0.0], [0.17, -0.15, 0.0],
                             [-0.17, 0.15, 0.0], [-0.17, -0.15, 0.0]]),
                   (batch, 1, 1))
    feet[..., 2] = -heights[:, None]
    x0 = np.zeros((batch, 13))
    x0[:, 5] = heights
    x0[:, 9:12] = vel_cmd * rng.uniform(0.5, 1.0, (batch, 1))
    x0[:, 12] = -9.8
    x_ref = np.zeros((batch, h, 13))
    x_ref[..., 5] = heights[:, None]
    x_ref[..., 9:11] = vel_cmd[:, None, :2]
    steps = 0.0025 * np.arange(1, h + 1)
    x_ref[..., 3] = vel_cmd[:, None, 0] * steps
    x_ref[..., 4] = vel_cmd[:, None, 1] * steps
    x_ref[..., 12] = -9.8
    inertia = (np.tile(np.diag([0.0168, 0.0656, 0.0743]), (batch, 1, 1))
               * (mass / 15.0)[:, None, None])
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return {"x0": t(x0), "x_ref": t(x_ref), "foot_pos": t(feet),
            "contacts": torch.tensor(contacts, device=device),
            "mass": t(mass), "inertia": t(inertia), "mu": t(mu),
            "q_weights": t([80.0, 80.0, 1.0, 0.0, 0.0, 270.0, 1.0, 1.0,
                            20.0, 20.0, 20.0, 20.0, 0.0]),
            "r_weights": t([1e-5, 1e-5, 1e-6] * 4)}


def condense(scn, x0, dense):
    """The scenarios' condensed QPs at start state ``x0`` (B, 13): lazy, or
    dense (``srb.CondensedQP``) with ``dense``. The per-scenario mass rides
    as a (B, 1, 1) tensor through ``calculate_B_c``."""
    import torch
    from go1_qp_mpc_controller_torch.models import srb

    batch = x0.shape[0]
    rot = torch.eye(3, device=x0.device).expand(batch, 3, 3)
    a_d, b_d = srb.discretize(
        srb.calculate_A_c(x0[:, 0:3]),
        srb.calculate_B_c(scn["mass"][:, None, None], scn["inertia"], rot,
                          scn["foot_pos"]), 0.0025)
    fn = srb.condense_nilpotent_const if dense else srb.condense_nilpotent_lazy
    return fn(a_d, b_d, x0, scn["x_ref"], scn["q_weights"],
              scn["r_weights"], scn["contacts"])


def _take(tree, n):
    return type(tree)(*[a[:n] for a in tree])


def warm_gap(got, want):
    """(worst per-scenario max|x_got - x_want|, worst per-scenario
    max|y_got - y_want| / (1 + max|y_want|))."""
    dx = (got.x - want.x).abs().amax(-1)
    dy = ((got.y - want.y).abs().amax(-1)
          / (1.0 + want.y.abs().amax(-1)))
    return float(dx.max()), float(dy.max())


def dense_chain_phase(batch, seed, device, reps):
    """The dense warm-tick chain (the JAX bench's solver program): fresh
    cold solves (``admm.mpc_solve_cold`` at bench.py:470-473's settings,
    K1), then ``CHAIN_TICKS`` warm ticks of ``mpc_solve_warm_batch`` (K3
    refinement + K6) with the bench.py:503-504 drift, timed; the first and
    last ticks held against ``admm.mpc_solve_warm`` on the same inputs; the
    last tick's GRFs against the tight polished reference (bench.py:91-94,
    dense ``mpc_solve``, K3) on ``TIGHT_SCENARIOS`` scenarios. Then K6
    alone against its plain version at 20 and 80 iterations on this
    chain's operands. Returns (path counts, K6 record, lines, passed)."""
    import torch
    from go1_qp_mpc_controller_torch.ops import admm, admm_iterations

    scn = random_scenarios(batch, seed, device)
    mu = scn["mu"]
    settings_cold = admm.ADMMSettings(seg_iters=40, segments=1, polish=False,
                                      schulz_l0=1e-6, schulz_hi_tail=1,
                                      schulz_impl="pallas")
    settings_warm = admm.ADMMSettings(seg_iters=15, segments=1, polish=False,
                                      schulz_refine=1, schulz_impl="pallas")
    drift = torch.zeros((batch, 13), device=device)
    drift[:, 9] = 0.001
    drift[:, 3] = 0.0005

    reset_counts()
    lazy = condense(scn, scn["x0"], dense=False)
    sol0, warm = admm.mpc_solve_cold(lazy, settings_cold, mu=mu,
                                     contacts=scn["contacts"],
                                     foot_pos=scn["foot_pos"])
    x0 = scn["x0"]
    kept = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(CHAIN_TICKS):
        x0 = x0 + drift
        qps = condense(scn, x0, dense=True)
        warm_in = warm
        sol, warm = admm_iterations.mpc_solve_warm_batch(qps, warm_in, mu,
                                                         settings_warm)
        if k in (0, CHAIN_TICKS - 1):
            kept[k] = (qps, warm_in, sol)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    rate = batch * CHAIN_TICKS / elapsed

    # mpc_solve_warm refines the same inverse and runs the same loop on K6;
    # it differs in the post-loop z and residuals
    gaps = {k: warm_gap(sol, admm.mpc_solve_warm(qps, warm_in,
                                                 settings_warm, mu=mu)[0])
            for k, (qps, warm_in, sol) in kept.items()}
    gate = {k: dx < K6_TOL and dy < 0.1 for k, (dx, dy) in gaps.items()}
    # the tight polished reference on the last tick's QPs
    qps_last, _, sol_last = kept[CHAIN_TICKS - 1]
    tight_settings = admm.ADMMSettings(seg_iters=80, segments=4,
                                       polish=True, polish_solver="inv")
    tight = admm.mpc_solve(_take(qps_last, TIGHT_SCENARIOS), tight_settings,
                           mu=mu[:TIGHT_SCENARIOS])
    grf_err = (sol_last.x[:TIGHT_SCENARIOS, :12]
               - tight.x[:, :12]).abs().amax(-1)
    p50 = float(grf_err.median())
    p90 = float(torch.quantile(grf_err, 0.9))
    finite = (bool(torch.isfinite(sol_last.x).all())
              and bool(torch.isfinite(sol0.x).all())
              and bool(torch.isfinite(tight.x).all()))
    checks = {
        "finite": finite,
        "first_tick_vs_mpc_solve_warm": gate[0],
        "last_tick_vs_mpc_solve_warm": gate[CHAIN_TICKS - 1],
        "k1_on_the_cold_solve": counts["kkt_schulz"] == 1,
        # K6: once for the cold solve, then once a tick
        "k3_k6_each_tick": (counts["schulz_batch"] == CHAIN_TICKS
                            and counts["admm_iterations"]
                            == CHAIN_TICKS + 1)}
    lines = [
        f"dense chain: batch {batch}, fresh cold solve (mpc_solve_cold) then "
        f"{CHAIN_TICKS} warm ticks of mpc_solve_warm_batch in {elapsed:.3f} "
        f"s: {rate:.1f} dense warm solves/s (condensation included); "
        f"launches {json.dumps(counts)}",
        f"dense chain vs admm.mpc_solve_warm on the same inputs: first tick "
        f"max|dx| {gaps[0][0]:.3e}, max|dy|/(1+max|y|) {gaps[0][1]:.3e}; "
        f"last tick {gaps[CHAIN_TICKS - 1][0]:.3e}, "
        f"{gaps[CHAIN_TICKS - 1][1]:.3e} (tolerances per scenario: "
        f"{K6_TOL:g} on x, 0.1 on y)",
        f"dense chain warm-vs-tight GRF on {TIGHT_SCENARIOS} scenarios at the "
        f"last tick: p50 {p50:.4f} N, p90 {p90:.4f} N (tight: mpc_solve, 4 "
        f"segments x 80 iterations, polished with inv)",
        f"dense chain checks {json.dumps(checks)} "
        f"{'PASS' if all(checks.values()) else 'FAIL'}"]

    # K6 alone on the last tick's operands
    ops, _ = admm_iterations.warm_batch_operands(qps_last, kept[
        CHAIN_TICKS - 1][1], mu, settings_warm)
    k6_lines, k6_record, k6_ok = k6_phase(ops, reps)
    return counts, k6_record, lines + k6_lines, all(checks.values()) and k6_ok


def loop_float64(ops, iters):
    """The plain ADMM loop in float64 on the same operands: the reference
    that the float32 loops (K6 and its plain version) are both held
    against. The QP's near-flat directions (r_weights ~1e-6) amplify the
    product round-off of any float32 summation order in x (the forces
    reach 180 N)."""
    from go1_qp_mpc_controller_torch.ops import admm_iterations
    return admm_iterations.admm_iterations_plain(
        **{k: v.double() for k, v in ops.items()}, iters=iters, alpha=1.6,
        sigma=1e-6)[0]


def k6_flops(batch, iters):
    """FLOPs of the ADMM loop: per iteration and scenario the 120 x 120
    matvec (2 N^2), C' w and the rhs (9 per (step, leg) pair, 3 per
    variable), the relaxation of x (3 per variable) and, per constraint
    row, z_t, the relaxation, the projection, the dual update and
    w = rho z - y (14); plus z0 = clip(C x0) once."""
    per_iter = 2 * N * N + 9 * 40 + 6 * N + 14 * 200
    return batch * (iters * per_iter + 4 * 200)


def k6_phase(ops, reps):
    """K6 against its plain version at the warm and window budgets (20 and
    80 iterations), per scenario: x within ``K6_TOL`` of the plain loop and
    within ``K6_F64_TOL`` of the loop in float64, y within
    0.1 (1 + max|y_plain|). Returns (lines, record, passed)."""
    import torch
    from go1_qp_mpc_controller_torch.ops import admm_iterations

    batch = ops["minv"].shape[0]
    lines, records = [], {}
    in_bytes = batch * (N * N + 2 * N + 4 * 200 + 1) * F32
    out_bytes = batch * (N + 2 * 200) * F32          # x, z and y
    for iters in (20, 80):
        x, y = admm_iterations.admm_iterations(**ops, iters=iters)
        xw, yw = admm_iterations.admm_iterations_plain(
            **ops, iters=iters, alpha=1.6, sigma=1e-6)
        torch.cuda.synchronize()
        dx = (x - xw).abs().amax(-1)
        dy = (y - yw).abs().amax(-1) / (1.0 + yw.abs().amax(-1))
        x64 = loop_float64(ops, iters)
        err_k = float((x.double() - x64).abs().amax(-1).max())
        err_p = float((xw.double() - x64).abs().amax(-1).max())
        finite = bool(torch.isfinite(x).all() and torch.isfinite(y).all())
        passed = (finite and float(dx.max()) < K6_TOL
                  and err_k <= K6_F64_TOL and float(dy.max()) < 0.1)
        kernel_ms = cuda_ms(lambda: admm_iterations.admm_iterations(
            **ops, iters=iters), reps)
        plain_ms = cuda_ms(lambda: admm_iterations.admm_iterations_plain(
            **ops, iters=iters, alpha=1.6, sigma=1e-6), reps)
        bound_ms, bound_by = bound(k6_flops(batch, iters),
                                   in_bytes + out_bytes)
        lines.append(
            f"K6 {iters} iterations: batch {batch}, worst per-scenario "
            f"max|x_K6 - x_plain| {float(dx.max()):.3e} (tolerance "
            f"{K6_TOL:g}; {int((dx > K6_TOL).sum())} scenarios above); "
            f"against the float64 loop: K6 worst {err_k:.3e} (tolerance "
            f"{K6_F64_TOL:g}), plain float32 worst {err_p:.3e}; "
            f"max|dy|/(1+max|y|) {float(dy.max()):.3e} (tolerance 0.1); "
            f"kernel_ms {kernel_ms:.4f}, plain_ms {plain_ms:.4f}, bound_ms "
            f"{bound_ms:.4f} ({bound_by}) {'PASS' if passed else 'FAIL'}")
        records[iters] = dict(err=float((x - xw).abs().max()),
                              kernel_ms=kernel_ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              passed=passed)
    main = records[20]
    record = {
        "name": "admm_iterations", "route": "cuda",
        "source": "go1_qp_mpc_controller_torch/csrc/admm_iterations.cu",
        "replaces": "go1_qp_mpc_controller_tpu/ops/pallas_admm.py:733",
        "max_abs_err": max(r["err"] for r in records.values()),
        "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None}
    return lines, record, all(r["passed"] for r in records.values())


def _walk_command(start, vx):
    """(global tick -> command_fn) for a one-tick rollout call."""
    import torch

    def at(tick):
        def command(_, ctrl):
            walk = tick >= start
            vel = torch.zeros_like(ctrl.root_lin_vel_d)
            vel[:, 0] = vx if walk else 0.0
            return ctrl._replace(
                movement_mode=torch.full_like(ctrl.movement_mode, int(walk)),
                root_lin_vel_d=vel)
        return command
    return at


def _robot_ticks(carry, model, params, ticks, command_at, **kw):
    """``ticks`` one-tick ``rollout.rollout`` calls, each ending in a
    synchronize (the single-robot loop must hand its torques over every
    tick). Returns (carry, stacked trace, per-tick wall seconds)."""
    import torch
    from go1_qp_mpc_controller_torch.envs import rollout

    records, walls = [], []
    for tick in range(ticks):
        t0 = time.perf_counter()
        carry, tr = rollout.rollout(
            carry, model, params, 1, 0.002,
            command_fn=command_at(tick) if command_at else None, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        records.append(tr)
    trace = type(records[0])(*[torch.cat(leaves)
                               for leaves in zip(*records)])
    return carry, trace, walls


def _pct(walls, q):
    import numpy as np
    return float(np.percentile(np.asarray(walls) * 1e3, q))


def single_robot_phase(device, card):
    """One robot (``rollout.rollout`` at batch 1, float32): the EKF on,
    polished cold settings (main.py / tests/test_walking.py) with
    ``WARM_SETTINGS``; ``ROBOT_STAND_TICKS`` standing, then trot at 0.25 m/s
    to ``ROBOT_TICKS`` (gates of test_forward_trot_with_ekf); then the
    balance-QP stand for ``QP_TICKS`` (gate of test_stand_qp_mode; K3 runs
    once per segment of each tick). Returns (counts by path, lines,
    passed)."""
    import torch
    from go1_qp_mpc_controller_torch.ctrl import controller
    from go1_qp_mpc_controller_torch.envs import rollout
    from go1_qp_mpc_controller_torch.models import types
    from go1_qp_mpc_controller_torch.ops import admm

    f32 = torch.float32
    model = types.default_robot_model(f32, device)
    params = types.default_ctrl_params(f32, device)
    settings = admm.ADMMSettings(**POLISHED)
    kw = dict(settings=settings, warm_settings=controller.WARM_SETTINGS,
              use_terrain_adapt=False)

    carry = rollout.init_carry(model, params, 1, dtype=f32, device=device)
    stats = {}
    walk = _walk_command(ROBOT_STAND_TICKS, 0.25)
    mpc_kw = dict(solver_type=controller.MPC, estimate=True, **kw)
    reset_counts()
    carry, tr, walls = _robot_ticks(carry, model, params, ROBOT_TICKS, walk,
                                    stats=stats, **mpc_kw)
    mpc_counts = read_counts()
    # where a trot tick's time goes: half a gait cycle more, profiled
    profile = profile_lines(lambda: _robot_ticks(
        carry, model, params, ROBOT_PROFILE_TICKS,
        lambda tick: walk(ROBOT_TICKS + tick), **mpc_kw),
        ROBOT_PROFILE_TICKS, _pct(walls, 50))
    pos = tr.root_pos[:, 0]
    vx = float(tr.root_lin_vel[400:, 0, 0].mean())
    z_err = float((pos[200:, 2] - 0.3).abs().max())
    finite = bool(torch.isfinite(tr.root_pos).all()
                  and torch.isfinite(tr.foot_forces_grf).all())

    carry = rollout.init_carry(model, params, 1, dtype=f32, device=device)
    reset_counts()
    _, trq, walls_q = _robot_ticks(carry, model, params, QP_TICKS, None,
                                   solver_type=controller.QP,
                                   estimate=False, **kw)
    qp_counts = read_counts()
    zq_err = float((trq.root_pos[150:, 0, 2] - 0.3).abs().max())
    finite_q = bool(torch.isfinite(trq.root_pos).all())
    checks = {
        "mpc_finite": finite,
        "mpc_vx_within_15%": abs(vx - 0.25) <= 0.15 * 0.25,
        "mpc_height_within_0.05": z_err < 0.05,
        "mpc_k1_k2_k3_launched": all(mpc_counts[k] > 0 for k in (
            "kkt_schulz", "observe_ekf", "schulz_batch")),
        # every tick ends in at least one ADMM loop on K6
        "mpc_k6_launches>=ticks": mpc_counts["admm_iterations"]
                                  >= ROBOT_TICKS,
        "mpc_k3_3_per_cold_tick": mpc_counts["schulz_batch"]
                                  == 3 * (stats.get("cold", 0)
                                          + stats.get("health", 0)),
        "qp_finite": finite_q, "qp_height_within_0.05": zq_err < 0.05,
        "qp_k3_ticks_x_segments": qp_counts["schulz_batch"]
                                  == QP_TICKS * settings.segments}
    lines = [
        f"one robot (rollout, batch 1, EKF on, polished cold solves): "
        f"{ROBOT_STAND_TICKS} standing then trot 0.25 m/s to {ROBOT_TICKS} "
        f"ticks; tick wall time p50 {_pct(walls, 50):.3f} ms, p99 "
        f"{_pct(walls, 99):.3f} ms, max {_pct(walls, 100):.3f} ms "
        f"(synchronized each tick) on {card}; routes {json.dumps(stats)}; "
        f"launches {json.dumps(mpc_counts)}; mean vx over ticks 400+ "
        f"{vx:.4f} m/s, max |z - 0.3| from tick 200 {z_err:.4f} m",
        f"one robot, balance-QP stand: {QP_TICKS} ticks, tick wall time p50 "
        f"{_pct(walls_q, 50):.3f} ms, p99 {_pct(walls_q, 99):.3f} ms; "
        f"launches {json.dumps(qp_counts)}; max |z - 0.3| from tick 150 "
        f"{zq_err:.4f} m"]
    lines += ["one robot " + line for line in profile]
    lines += [
        f"one robot checks {json.dumps(checks)} "
        f"{'PASS' if all(checks.values()) else 'FAIL'}"]
    return ({"robot_mpc": mpc_counts, "robot_qp": qp_counts}, lines,
            all(checks.values()))


def polished_batched_phase(batch, seed, device, card):
    """``rollout_batched`` at ``batch`` with the polished cold settings: the
    seeded perturbed trot start of the main path, ``POLISHED_ONSET_TICKS``
    untimed, then ``POLISHED_TIMED_TICKS`` timed (half a gait cycle, so a
    flip and its cold ticks fall inside). Cold ticks run the dense polished
    solve (K3 once per segment). Returns (counts, lines, passed)."""
    import torch
    from go1_qp_mpc_controller_torch.envs import rollout
    from go1_qp_mpc_controller_torch.models import types
    from go1_qp_mpc_controller_torch.ops import admm

    f32 = torch.float32
    settings = admm.ADMMSettings(**POLISHED)
    model = types.default_robot_model(f32, device)
    params = types.default_ctrl_params(f32, device)
    carry = rollout.init_carry(model, params, batch, dtype=f32,
                               device=device)
    gen = torch.Generator().manual_seed(seed)
    dz = 0.01 * torch.randn((batch,), generator=gen)
    dv = 0.02 * torch.randn((batch, 3), generator=gen)
    carry = carry._replace(
        sim=carry.sim._replace(
            root_pos=carry.sim.root_pos + torch.nn.functional.pad(
                dz[:, None], (2, 0)).to(device),
            root_lin_vel=carry.sim.root_lin_vel + dv.to(device)),
        ctrl=carry.ctrl._replace(
            movement_mode=torch.ones_like(carry.ctrl.movement_mode),
            root_lin_vel_d=torch.tensor([0.25, 0.0, 0.0], dtype=f32,
                                        device=device).expand(
                                            batch, 3).clone()))
    onset, timed = {}, {}
    reset_counts()
    t0 = time.perf_counter()
    carry, _ = rollout.rollout_batched(carry, model, params,
                                       POLISHED_ONSET_TICKS, 0.002,
                                       settings=settings, stats=onset)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    carry, tr = rollout.rollout_batched(carry, model, params,
                                        POLISHED_TIMED_TICKS, 0.002,
                                        settings=settings, stats=timed)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = read_counts()
    z = tr.root_pos[..., 2]
    tilt = torch.sqrt(tr.root_euler[..., 0] ** 2 + tr.root_euler[..., 1] ** 2)
    share = float(((z >= 0.25) & (z <= 0.35) & (tilt < 0.25)).all(0)
                  .float().mean())
    cold_ticks = sum(st.get(r, 0) for st in (onset, timed)
                     for r in ("cold", "compact"))
    checks = {
        "finite": bool(torch.isfinite(tr.foot_forces_grf).all()),
        "healthy_share>=0.99": share >= 0.99,
        "cold_ticks_in_timed_span": timed.get("cold", 0)
                                    + timed.get("compact", 0) > 0,
        "k3_3_per_cold_tick": counts["schulz_batch"] == 3 * cold_ticks,
        "k6_launches>=ticks": counts["admm_iterations"]
                              >= POLISHED_ONSET_TICKS + POLISHED_TIMED_TICKS}
    rate = batch * POLISHED_TIMED_TICKS / (t2 - t1)
    lines = [
        f"polished batched tick: rollout_batched batch {batch}, polished "
        f"cold settings, {POLISHED_ONSET_TICKS} onset ticks ({t1 - t0:.3f} "
        f"s) + {POLISHED_TIMED_TICKS} timed ticks ({t2 - t1:.3f} s): "
        f"{rate:.1f} scenario-ticks/s on {card}; routes onset "
        f"{json.dumps(onset)}, timed {json.dumps(timed)}; launches "
        f"{json.dumps(counts)}; healthy share {share:.4f}",
        f"polished batched checks {json.dumps(checks)} "
        f"{'PASS' if all(checks.values()) else 'FAIL'}"]
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
        ("K3", lambda: k3_phase(BATCH,
                                torch.Generator().manual_seed(args.seed + 2),
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

    # the paths, each with every launch counter set to 0 just before it
    # and read just after it
    by_path = {}

    def main_path():
        counts, lines, passed = main_path_phase(
            BATCH, ONSET_TICKS, TIMED_TICKS, args.seed, device,
            PROFILE_TICKS, card)
        return {"main": counts}, lines, passed

    def dense_chain():
        counts, k6_record, lines, passed = dense_chain_phase(
            BATCH, args.seed + 3, device, REPS)
        records.append(k6_record)
        return {"dense_chain": counts}, lines, passed

    def polished():
        counts, lines, passed = polished_batched_phase(
            BATCH, args.seed + 4, device, card)
        return {"polished_batched": counts}, lines, passed

    paths = [("main path", main_path), ("dense chain", dense_chain),
             ("one robot", lambda: single_robot_phase(device, card)),
             ("polished batched", polished)]
    for name, path in paths:
        try:
            counts, lines, passed = path()
            by_path.update(counts)
            for line in lines:
                print(line, flush=True)
            ok &= passed
        except Exception:
            traceback.print_exc()
            print(f"FAIL {name} phase raised", flush=True)
            ok = False
    for record in records:
        record["launches_by_path"] = {
            path: counts[record["name"]] for path, counts in by_path.items()
            if counts[record["name"]]}
        record["launches"] = sum(record["launches_by_path"].values())
        if record["launches"] == 0:
            print(f"FAIL {record['name']} was launched on no path",
                  flush=True)
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

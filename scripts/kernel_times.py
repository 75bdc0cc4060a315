#!/usr/bin/env python3
"""Kernel phases of ``chip_smoke.py`` for one checkout of the repository.

Imports ``chip_smoke`` and the port from ``--root`` (a checkout, e.g. one
unpacked from ``git archive``), builds that checkout's kernels into its own
``build/kernels/`` and times them at the smoke test's seeds: K1 through
its entry point ``kkt_schulz.kkt_schulz`` on the three schedules of
``chip_smoke.k1_phase`` (cold l0=1e-3, warm refine=1 and warm l0=1e-4,
the wrapper's default ``hi_tail``) at batch 4096, 128 and 1, and K2
through ``observe_ekf.observe_ekf`` at batch 4096 and 1, each with the
route its wrapper takes where it has routes; K3 at n = 12 and K4 at batch
1 (the balance QP's and the estimator's launches) through their entry
points; then the checkout's K3 to K6
phases (those its ``chip_smoke.py`` has), printing their lines: kernel,
plain and library times beside the bounds. K6 runs on the operands of a
cold solve and five warm ticks of the dense chain's scenarios (as the
card-only tests make them). Last, K6 at batch 1 and 133 and K4 at batch
1, 33 and 4096 through their entry points, each also as the kernel alone
from a profiler trace. Every time is the median of
5 spans of ``chip_smoke.REPS`` calls, one function's spans back to back,
whichever checkout's timer the phase calls (``chip_smoke.py`` itself
interleaves kernel, plain version and library call, which leaves a small
kernel's inputs out of L2 and reads slower). To compare two commits on
one card, run it in one call for parent, change, change, parent:

    python3 scripts/kernel_times.py --root build/parent [--kernels k4,k6]
"""

import argparse
import os
import statistics
import sys

SPANS = 5


def median_ms(fn, reps=5):
    """Device time of ``fn()`` in ms: the median of ``SPANS`` spans of
    ``reps`` calls (CUDA events), after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(SPANS):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def consecutive_times(fns, reps=5):
    """``chip_smoke.cuda_times`` with each function's spans back to back:
    {name: :func:`median_ms` of it}."""
    return {name: median_ms(fn, reps) for name, fn in fns.items()}


def k6_operands(chip_smoke, batch, seed, device):
    """K6's operands of a warm tick of the dense chain: a cold solve of
    ``chip_smoke.random_scenarios`` (a dict before the port had
    ``parallel/sweep.py``, an ``MpcScenario`` since; the same draws), then
    five warm ticks with the chain's drift."""
    import torch
    from go1_qp_mpc_controller_torch.ops import admm, admm_iterations

    scn = chip_smoke.random_scenarios(batch, seed, device)
    field = lambda name: (scn[name] if isinstance(scn, dict)
                          else getattr(scn, name))
    mu = field("mu")
    _, warm = admm.mpc_solve_cold(
        chip_smoke.condense(scn, field("x0"), dense=False),
        admm.ADMMSettings(seg_iters=40, segments=1, polish=False,
                          schulz_l0=1e-6, schulz_hi_tail=1),
        mu=mu, contacts=field("contacts"), foot_pos=field("foot_pos"))
    settings = admm.ADMMSettings(seg_iters=15, segments=1, polish=False,
                                 schulz_refine=1)
    drift = torch.zeros((batch, 13), device=device)
    drift[:, 9] = 0.001
    drift[:, 3] = 0.0005
    x0 = field("x0")
    for _ in range(5):
        x0 = x0 + drift
        qps = chip_smoke.condense(scn, x0, dense=True)
        ops, _ = admm_iterations.warm_batch_operands(qps, warm, mu, settings)
        _, warm = admm_iterations.mpc_solve_warm_batch(qps, warm, mu,
                                                       settings)
    return ops


def k1_k2_times(chip_smoke, seed, device):
    """Lines of K1's and K2's kernel times by schedule and batch, through
    the checkout's entry points (the same calls on any commit of the
    port)."""
    import torch
    from go1_qp_mpc_controller_torch.ops import admm, kkt_schulz, observe_ekf

    batch = chip_smoke.BATCH
    coeffs = admm._scaled_schulz_coeffs
    ops = chip_smoke.random_kkt_operands(
        batch, torch.Generator().manual_seed(seed), device)
    x_good = kkt_schulz.kkt_schulz(*ops, coeffs=coeffs(1e-4))
    bad = (torch.arange(batch, device=device) % 8 == 0)[:, None, None]
    x0 = torch.where(bad, -x_good, x_good).contiguous()
    route = getattr(kkt_schulz, "route", lambda c: "one block")
    lines = []
    for b in (batch, 128, 1):
        ops_b = [t[:b].contiguous() for t in ops]
        x0_b = x0[:b].contiguous()
        for name, xw, sched in (("cold_l0=1e-3", None, coeffs(1e-3)),
                                ("warm_refine=1", x0_b, (1.0,)),
                                ("warm_l0=1e-4", x0_b, coeffs(1e-4))):
            ms = median_ms(lambda: kkt_schulz.kkt_schulz(*ops_b, x0=xw,
                                                         coeffs=sched))
            lines.append(f"K1 {name} batch {b} route {route(sched)}: "
                         f"kernel_ms {ms:.4f}")
    args = chip_smoke.random_ekf_inputs(
        batch, torch.Generator().manual_seed(seed + 1), device)
    for b in (batch, 1):
        args_b = [t[:b].contiguous() for t in args[:9]] + args[9:]
        ms = median_ms(lambda: observe_ekf.observe_ekf(*args_b))
        lines.append(f"K2 observe+EKF batch {b}: kernel_ms {ms:.4f}")
    return lines


def batch1_times(chip_smoke, seed, device):
    """Lines of K3 at n = 12 (20 plain steps, cold) and K4 (the EKF
    innovation inverse, the estimator's schedule) at batch 1, through the
    checkout's entry points."""
    import torch
    from go1_qp_mpc_controller_torch.ops import (admm, ekf, schulz_batch,
                                                 schulz_lanes)

    gen = torch.Generator().manual_seed(seed)
    m12 = chip_smoke.random_balance_kkts(1, gen, device)
    s28 = torch.tensor(chip_smoke.spread_spd(1, 28, seed), device=device)
    c12 = (1.0,) * 20
    c28 = admm._scaled_schulz_coeffs(ekf.SINV_L0)
    lines = []
    for name, kernel, n, c, fn in (
            ("K3 n=12 cold 20 steps", "schulz_batch", 12, c12,
             lambda: schulz_batch.schulz_inverse_batch(m12, coeffs=c12)),
            ("K4 spread SPD", "schulz_lanes_kernel", 28, c28,
             lambda: schulz_lanes.schulz_inverse_lanes(s28, c28))):
        # chip_smoke.k4_phase's reckoning: two products of 2 n^3 a step
        # after the folded first one; the matrix in and the inverse out
        bound_ms, bound_by = chip_smoke.bound(
            2 * (len(c) - 1) * 2.0 * n ** 3, 2 * n * n * chip_smoke.F32)
        us, count = kernel_us(fn, kernel)
        lines.append(f"{name} batch 1: kernel_ms {median_ms(fn):.4f}, "
                     f"kernel_us {us:.2f} (median of {count} in a profiler "
                     f"trace), bound_ms {bound_ms:.7f} ({bound_by})")
    return lines


def kernel_us(fn, name, calls=20):
    """(median device time in us, count) of the kernels whose name holds
    ``name`` over ``calls`` calls of ``fn()``, from a torch.profiler trace:
    the kernel alone, where CUDA events around a small batch's calls time
    the wrapper's host pace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [ev.time_range.end - ev.time_range.start for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and name in ev.name]
    return (statistics.median(times) if times else float("nan"),
            len(times))


def small_batch_times(chip_smoke, ops, seed, device):
    """Lines of K6 (at 20 and 80 iterations, batch 1 and 133 of ``ops``)
    and K4 (the spread SPD set at batch 1, 33 and 4096) through the
    checkout's entry points: CUDA-event time of the call and, from a
    profiler trace, of the kernel alone."""
    import torch
    from go1_qp_mpc_controller_torch.ops import (admm, admm_iterations, ekf,
                                                 schulz_lanes)

    lines = []
    for b in (1, 133):
        ops_b = {k: v[:b] for k, v in ops.items()}
        for iters in (20, 80):
            fn = lambda: admm_iterations.admm_iterations(**ops_b,
                                                         iters=iters)
            us, n = kernel_us(fn, "admm_iterations_kernel")
            lines.append(f"K6 {iters} iterations batch {b}: call_ms "
                         f"{median_ms(fn):.4f}, kernel_us {us:.2f} "
                         f"(median of {n} in a profiler trace)")
    coeffs = admm._scaled_schulz_coeffs(ekf.SINV_L0)
    m = torch.tensor(chip_smoke.spread_spd(chip_smoke.BATCH, 28, seed),
                     device=device)
    for b in (1, 33, chip_smoke.BATCH):
        m_b = m[:b]
        fn = lambda: schulz_lanes.schulz_inverse_lanes(m_b, coeffs)
        us, n = kernel_us(fn, "schulz_lanes_kernel")
        lines.append(f"K4 spread SPD batch {b}: call_ms {median_ms(fn):.4f}, "
                     f"kernel_us {us:.2f} (median of {n} in a profiler "
                     f"trace)")
    return lines


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--kernels", default="k1,k2,k3,k4,k5,k6",
                        help="comma-separated phases to run")
    args = parser.parse_args(argv)
    run = set(args.kernels.split(","))
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke
    from go1_qp_mpc_controller_torch.ops import _build
    from go1_qp_mpc_controller_torch.utils.device import pin_f32_matmuls

    assert os.path.dirname(os.path.abspath(chip_smoke.__file__)) == root
    chip_smoke.cuda_ms = median_ms
    chip_smoke.cuda_times = consecutive_times
    pin_f32_matmuls()
    _build.build_all()
    device = torch.device("cuda")
    print(f"root {args.root}: card {chip_smoke.card_line()}", flush=True)
    gen = lambda k: torch.Generator().manual_seed(args.seed + k)
    out = lambda lines: [print(f"[{args.root}] {line}", flush=True)
                         for line in lines]
    if run & {"k1", "k2"}:
        out(k1_k2_times(chip_smoke, args.seed, device))
    if run & {"k3", "k4"}:
        out(batch1_times(chip_smoke, args.seed + 8, device))
    if "k3" in run:
        out(chip_smoke.k3_phase(chip_smoke.BATCH, gen(2), device,
                                chip_smoke.REPS)[1])
    if "k4" in run and hasattr(chip_smoke, "k4_phase"):
        out(chip_smoke.k4_phase(chip_smoke.BATCH, gen(5), args.seed + 5,
                                device, chip_smoke.REPS)[1])
    if "k5" in run and hasattr(chip_smoke, "k5_phase"):
        out(chip_smoke.k5_phase(device, chip_smoke.REPS)[2])
    if run & {"k4", "k6"}:
        ops = k6_operands(chip_smoke, chip_smoke.BATCH, args.seed + 3,
                          device)
        if "k6" in run:
            out(chip_smoke.k6_phase(ops, chip_smoke.REPS)[0])
        out(small_batch_times(chip_smoke, ops, args.seed + 9, device))


if __name__ == "__main__":
    main()

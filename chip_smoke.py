#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Builds the port's CUDA kernels from ``go1_qp_mpc_controller_torch/csrc``,
holds each against its plain PyTorch version on the card at the shapes
its paths give it, then drives each path through the entry points a user
calls, with every launch counter set to 0 just before the path and read
just after it:

- the main path: the batched closed-loop controller tick
  (``envs.rollout.rollout_batched``, each tick replayed from captured CUDA
  graphs) at batch 4096 with the segmented cold settings (K1, K2, K6);
- the dense warm-tick chain: fresh cold solves (``admm.mpc_solve_cold``,
  K1, K6), then 40 warm ticks of ``admm_iterations.mpc_solve_warm_batch``
  (K3, K6) at batch 4096;
- one robot (``envs.rollout.rollout``, batch 1, each tick replayed from
  captured CUDA graphs) trotting with the EKF and polished cold solves
  (K1, K2, K3, K6), then standing on the balance QP (K3);
- the captured steps: the same one-robot ticks (a health re-solve
  forced) through the eager composition of ``rollout.tick_parts`` and
  through the captured graphs, held equal bit for bit, in launches per
  kernel and route, and in route sequence;
- the batched tick with the polished cold settings (K1, K2, K3, K6),
  replayed from captured graphs too;
- K5's own entry (``ops/schulz_balanced.py``; in the JAX package only
  tests call it);
- the real-time host runtime (``main.py loop``): ``ControlLoop.run_dual``
  against the simulated 1 kHz feed on the card, with the estimator thread
  (K4 once a sensor frame) and a scripted joystick session, on
  ``hardware_qp`` (the balance QP, K3 at n = 12) and ``gazebo_mpc`` (K1,
  K3, K6), every step a graph replay;
- the scenario sweep (``parallel/sweep.py``): ``main.py sweep``'s program
  at batch 4096 (the dense polished route: K3, K6), then the fused cold
  route (K1, K6) through ``run_chunked`` over 32 chunks of 4096;
- the multi-device layer at world size 1 (``main.py sweep``'s mesh): a
  world-1 NCCL group, the mesh sweep on both routes (K1, K3, K6), the
  sharded controller step, the horizon-sharded LQR solve, and ``main.py
  rollout --trace`` (K1, K2, K3, K6), each held against its one-card
  counterpart;
- the long horizon: the stagewise solver (``ops/stagewise.py``, K3 at
  n = 12 once a stage a Riccati pass) at batch 1024 for H = 40 and 120,
  cold and warm; the JAX package's closed-loop protocol at H = 40; the
  ``rollout(horizon=40)`` entry point; five receding-horizon ticks
  (K3, K6);
- the RL stack (``main.py rl``): ``rollout.rl_rollout`` at batch 4096 and
  1 (no counted kernel: each tick is one CUDA graph replay);
- the RL host loop (``main.py rl-loop``): ``RLControlLoop`` against the
  simulated feed on rl_gazebo at time scales 0.5 and 1 (K4 once an action
  tick);
- the log replay (``envs/replay.py``): a recorded one-robot trot replayed
  through ``replay_rollout`` (K1, K2, K3, K6), and a joint signal through
  ``replay_joint_signal``;
- robustness and terrain: the NaN sensor spike, the uphill and the
  turning trot at the JAX tests' lengths (batch 1), and a poisoned
  scenario in a batch of 4096 through the fused cold route (K1, K6).

K4 (the EKF innovation inverse) is also held against its plain version at
batch 4096 on its own, like K1, K2 and K3, and at batch 1 on the live
filter's innovation matrix after each runtime and RL-loop run. K1 is also
held at batch 128 (the main path's compacted cold sub-batch) and 1, K2 at
batch 1, K3 at n = 120 at batch 16 and 1 (its cluster route); K3's routes
are timed against each other at batch 1-32, and K1's and K3's launches are
printed by route for each path. Kernel, plain version and library call
are timed in turn, as medians of interleaved spans.

Each phase prints its lines; the last line is ``{"ok": true, "device":
{...}}`` and is printed only when every phase passed. A phase that fails
also writes its name and its failing lines to standard error, and the run
ends there with the list of failed phases.

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero
                                     # when there is none or a phase fails
"""

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback

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
REPS = 5          # launches per timed span
SPANS = 5         # spans per timing; the median is kept
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
# the scenario sweep: main.py sweep's batch and settings (the dense
# polished route: K3, K6), and the fused cold route (bench.py
# settings_cold: K1, K6) through run_chunked over 32 chunks, 131,072
# scenarios (the JAX sweep's "100k+", parallel/sweep.py:239-241); rates
# over SWEEP_SPANS spans
SWEEP_BATCH = 4096
SWEEP_CHUNKS = 32
SWEEP_SPANS = 5
SWEEP_DENSE = dict(seg_iters=25, segments=3)
SWEEP_FUSED = dict(seg_iters=40, segments=1, polish=False, schulz_l0=1e-6,
                   schulz_hi_tail=1, schulz_impl="pallas")
SWEEP_F64_SCENARIOS = 64
# JAX's physical bars at the JAX test's own size and settings
# (tests/test_sharding.py:59-82)
PHYSICAL_BATCH = 32
PHYSICAL = dict(seg_iters=75, segments=5)
# float32 against float64: on the QPs' flat valleys two float32 solves of
# one scenario can sit N apart (the plain float32 sweep on the CPU: dense
# route p90 1.06 N, max 7.9 N from float64 over 256 scenarios), so the
# card's p50 and p90 are held within F64_FACTOR x the plain float32
# version's + F64_SLACK N on the same scenarios
F64_FACTOR = 2.0
F64_SLACK = 0.05
# the mesh at world size 1: ticks of the sharded controller step, spans
# of each mesh sweep, the mpc-axis member counts summed serially (they
# divide the horizon), the horizon-sharded LQR's horizon and its gate
# against the port's _lqr_solve (float32: the scan composes the stages in
# another order), the rollout --trace steps
MESH_CTRL_TICKS = 3
MESH_SPANS = 3
MESH_PARTIAL_N = (2, 5)
LQR_H = 40
LQR_TOL = 1e-4
MESH_TRACE_STEPS = 30
# the long horizon: bench.py:667-697's stagewise batch, settings and warm
# ticks at H = 40 and 120; JAX's closed-loop protocol (tests/
# test_stagewise.py:203-270, 400 ticks); the rollout(horizon=40) entry
# point; five receding-horizon ticks
LH_BATCH = 1024
LH_HORIZONS = (40, 120)
LH_WARM_TICKS = 10
LH_SPANS = 3
LH_COLD = dict(seg_iters=60, segments=3, polish=False)
LH_WARM = dict(seg_iters=25, segments=1, polish=False)
LH_F64_SCENARIOS = 32
LH_ROLLOUT_TICKS = 400
LH_WALK_AT = 50
LH_ENTRY_TICKS = 200
LH_PROFILE_TICKS = 20
RECEDING_TICKS = 5
# K6 per scenario: on x, within 1e-3 of its plain version (the tolerance
# of tests/test_pallas_admm.py:75-83) and within 1e-3 + 1e-3 of the same
# loop in float64 (the second 1e-3 for the float32 loop's own round-off on
# the QP's flat directions: the plain float32 loop is at most 7.3e-4 from
# float64 on the dense chain's operands on an H100); on y, within
# 0.1 (1 + max|y_plain|)
K6_TOL = 1e-3
K6_F64_TOL = 2e-3
# K6 is also held at these heads of the batch: one robot's batch and a
# partial wave of the persistent grid
K6_BATCHES = (133, 1)
# K3 (n = 120) and K5 against the plain version that emulates their 3xTF32
# middle products (kkt_schulz.matmul_3xtf32): K3 per scenario in balanced
# coordinates, 10x tighter than its float32 gate (3e-4); K5 half its 5e-6.
# The card sums each product in its own order and the float32 tail steps
# round as any float32 product does, so kernel and emulation differ by as
# much as kernel and the float32 plain version (K3 up to 3.7e-6, K5 up to
# 1.3e-6 in the first runs), not bit for bit
K3_EMU_TOL = 3e-5
K5_EMU_TOL = 2.5e-6
# K1 against its 3xTF32 emulation: K3's gate (the same body and products)
K1_EMU_TOL = K3_EMU_TOL
# K1's phase: the main batch and these heads of it (the main path's
# compacted cold sub-batch is compact_k = 128; one robot is batch 1)
K1_BATCHES = (128, 1)
# K3's route phase: both n = 120 routes timed at these batches
ROUTE_BATCHES = (1, 2, 4, 8, 12, 16, 32)
# K4 on innovation matrices S = C P-bar C' + R, per matrix: within
# K4_S_TOL x max|plain| of the plain version and x max|X| of the float64
# schedule, and max|S X - I| < K4_S_RES_TOL. At P near its 3 I init their
# balanced condition numbers reach ~3e4: any float32 schedule, the plain one
# included, lands ~1.3e-3 x max|X| from the float64 one and leaves
# max|S X - I| ~2e-3 (on an H100: kernel 1.322e-3 and 1.803e-3, plain
# 1.273e-3 and 2.023e-3), so two float32 orders of summation differ by
# that much and the JAX test's 5e-4 / 1e-3 (which the spread-diagonal set
# meets) cannot hold there
K4_S_TOL = 2.5e-3
K4_S_RES_TOL = 4e-3
# K4 is also held at these heads of its batch: the estimator's batch and a
# partial wave
K4_BATCHES = (33, 1)


def _fail(msg):
    print(f"FAIL {msg}", flush=True)
    return 1


def _report(name, lines, passed, failed):
    """Print a phase's lines; when it failed, also write its name and its
    failing lines to standard error and add it to ``failed``."""
    for line in lines:
        print(line, flush=True)
    if not passed:
        failed.append(name)
        print(f"FAIL phase {name}:", file=sys.stderr, flush=True)
        for line in lines:
            if "FAIL" in line or "false" in line or "host: " in line:
                print(f"  {line}", file=sys.stderr, flush=True)


def host_sample():
    """A snapshot of what the host gave this process: wall and process CPU
    seconds, the 1-minute load average, the CPU steal time (/proc/stat,
    USER_HZ ticks) and the cgroup's CPU throttling (cpu.stat), each where
    the system exposes it."""
    snap = {"wall": time.perf_counter(), "cpu": time.process_time(),
            "threads": threading.active_count()}
    try:
        snap["load1"] = os.getloadavg()[0]
    except OSError:
        pass
    try:
        with open("/proc/stat") as f:
            snap["steal"] = int(f.readline().split()[8])
    except (OSError, IndexError, ValueError):
        pass
    try:
        with open("/sys/fs/cgroup/cpu.stat") as f:
            stat = dict(line.split() for line in f if line.strip())
        snap["throttled"] = int(stat["nr_throttled"])
        snap["throttled_us"] = int(stat["throttled_usec"])
    except (OSError, KeyError, ValueError):
        pass
    return snap


def host_text(a, b):
    """What the host gave the process between two :func:`host_sample`s."""
    wall = b["wall"] - a["wall"]
    parts = [f"process CPU {b['cpu'] - a['cpu']:.2f} s over {wall:.2f} s "
             f"wall, {b['threads']} threads"]
    if "load1" in b:
        parts.append(f"load average {a['load1']:.2f} -> {b['load1']:.2f} "
                     f"({os.cpu_count()} CPUs)")
    if "steal" in a and "steal" in b:
        parts.append(f"steal {b['steal'] - a['steal']} ticks")
    if "throttled" in a and "throttled" in b:
        parts.append(f"cgroup throttled {b['throttled'] - a['throttled']} "
                     f"times, {(b['throttled_us'] - a['throttled_us']) / 1e3:.1f}"
                     f" ms")
    return "host: " + "; ".join(parts)


class GcPauses:
    """The garbage collector's collections while active (a ``with``
    block): each one's generation and pause, and the tracked objects at
    the start."""

    def __init__(self):
        self.pauses = []
        self.objects = 0
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t0))
            self._t0 = None

    def __enter__(self):
        import gc
        self.objects = len(gc.get_objects())
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self)

    def text(self):
        ms = [t * 1e3 for _, t in self.pauses]
        full = sum(1 for g, _ in self.pauses if g == 2)
        return (f"gc: {len(ms)} collections ({full} full), pause max "
                f"{max(ms, default=0.0):.3f} ms, total {sum(ms):.3f} ms; "
                f"{self.objects} tracked objects")


def kernel_modules():
    """{kernel record name: its wrapper module (launch counter)}."""
    from go1_qp_mpc_controller_torch.ops import _build
    return _build.wrappers()


def reset_counts():
    """Every launch counter, and the sums of the captures' warm-up runs
    and of the graph replays (``graphs.warmup_launches``,
    ``replayed_launches``), to 0."""
    from go1_qp_mpc_controller_torch.utils import graphs
    for module in kernel_modules().values():
        module.reset_launches()
    graphs.reset_records()


def read_counts():
    """{kernel: launches since the last reset}, and K1's and K3's launches
    by route under "kkt_schulz_routes" and "schulz_batch_routes"."""
    import torch
    torch.cuda.synchronize()
    modules = kernel_modules()
    counts = {name: module.launches for name, module in modules.items()}
    for name in ("kkt_schulz", "schulz_batch"):
        counts[f"{name}_routes"] = {
            r: c for r, c in modules[name].route_launches.items() if c}
    return counts


def replayed_counts():
    """The launches of graph replays since the last :func:`reset_counts`,
    in ``read_counts()``'s form."""
    from go1_qp_mpc_controller_torch.utils import graphs
    counts = {name: 0 for name in kernel_modules()}
    counts.update(kkt_schulz_routes={}, schulz_batch_routes={})
    for name, (n, routes) in graphs.replayed_launches.items():
        counts[name] = n
        if f"{name}_routes" in counts:
            counts[f"{name}_routes"] = {r: c for r, c in routes.items() if c}
    return counts


def tick_counts(counts):
    """``read_counts()``'s ``counts`` less the launches of the captures'
    eager warm-up runs since the last :func:`reset_counts` (a path that
    captures a step launches its kernels a few times before its first
    tick): the launches of the path's own ticks."""
    from go1_qp_mpc_controller_torch.utils import graphs
    out = {k: dict(v) if isinstance(v, dict) else v
           for k, v in counts.items()}
    for name, (n, routes) in graphs.warmup_launches.items():
        out[name] -= n
        for r, c in routes.items():
            out[f"{name}_routes"][r] -= c
            if not out[f"{name}_routes"][r]:
                del out[f"{name}_routes"][r]
    return out


def add_counts(total, counts):
    """Adds ``read_counts()``'s ``counts`` into ``total`` (the same keys)."""
    for name, n in counts.items():
        if isinstance(n, dict):
            add_counts(total.setdefault(name, {}), n)
        else:
            total[name] = total.get(name, 0) + n
    return total


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi gave no answer: " + out.stderr.strip())


def cuda_times(fns, reps=REPS, spans=SPANS):
    """Device time in ms of each function of ``fns`` ({name: fn}): the
    median over ``spans`` spans of ``reps`` calls each (CUDA events), the
    functions' spans taken in turn, after a warm-up call of each."""
    import statistics
    import torch
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(spans):
        for name, fn in fns.items():
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    return {name: statistics.median(t) for name, t in times.items()}


def cuda_ms(fn, reps=REPS):
    """Device time of ``fn()`` in ms: :func:`cuda_times` of it alone."""
    return cuda_times({"fn": fn}, reps)["fn"]


def peaks():
    """The published H100 SXM peaks (NVIDIA data sheet, 700 W), the one
    table of the repo (``utils/roofline.py``): FP32 outside the tensor
    cores, dense TF32 on them, and HBM3 bandwidth. Every kernel here runs
    FP32 FMA, but for the middle Schulz steps of K1, K3 at n = 120 and K5,
    which run three TF32 passes on the tensor cores."""
    from go1_qp_mpc_controller_torch.utils import roofline
    return roofline.H100_SXM


def bound(flops, nbytes, tf32x3_flops=0.0):
    """(bound_ms, bound_by): the larger of the operations' time (``flops``
    at the FP32 peak plus ``tf32x3_flops`` at three TF32 passes on the
    tensor cores' peak) and the byte time at the HBM peak."""
    peak = peaks()
    ops_ms = (flops / peak.fp32_flops + 3.0 * tf32x3_flops
              / peak.tf32_flops) * 1e3
    bytes_ms = nbytes / peak.hbm_bytes * 1e3
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
    fails the basin test), each at ``batch`` and on the first
    ``K1_BATCHES`` scenarios, on the route the wrapper takes
    (``kkt_schulz.route``); the two schedules with 3xTF32 steps at the
    wrapper's default ``hi_tail`` of 2 and at the main path's 1. Gated
    per scenario in balanced coordinates against the float32 plain version
    (3e-4) and, where the schedule has a 3xTF32 step, against the plain
    version with the kernel's 3xTF32 middle products (``K1_EMU_TOL``).
    Kernel, plain version and ``torch.linalg.inv`` of the built M are
    timed in turn. Returns (record for the kernels line, lines, passed)."""
    import torch
    from go1_qp_mpc_controller_torch.ops import admm, kkt_schulz

    ops = random_kkt_operands(batch, gen, device)
    coeffs = admm._scaled_schulz_coeffs
    x_good = kkt_schulz.kkt_schulz(*ops, coeffs=coeffs(1e-4))
    bad = (torch.arange(batch, device=device) % 8 == 0)[:, None, None]
    x0 = torch.where(bad, -x_good, x_good).contiguous()
    m = kkt_schulz.kkt_build_plain(*ops)
    head = lambda t, b: t[:b].contiguous()

    prod = 2.0 * N ** 3
    variants = {
        "cold_l0=1e-3": (False, coeffs(1e-3), None),
        "cold_l0=1e-3 hi_tail=1": (False, coeffs(1e-3), 1),
        "warm_refine=1": (True, (1.0,), None),
        "warm_l0=1e-4": (True, coeffs(1e-4), None),
        "warm_l0=1e-4 hi_tail=1": (True, coeffs(1e-4), 1),
    }
    tol = 3e-4
    lines, records = [], {}
    for b in (batch,) + tuple(k for k in K1_BATCHES if k < batch):
        ops_b = [head(t, b) for t in ops]
        m_b = head(m, b)
        x0_b = head(x0, b)
        s = torch.rsqrt(torch.diagonal(m_b, dim1=-2, dim2=-1))
        unb = s[:, :, None] * s[:, None, :]
        mb = m_b * unb
        eye = torch.eye(N, dtype=mb.dtype, device=device)
        # basin test as the kernel runs it, to count this run's products
        n_ok = basin_accepted(m_b, x0_b)
        in_bytes = b * (4 * 12 * N + 3 * N + 1) * F32
        mat_bytes = b * N * N * F32
        build_flops = b * N * N * 9.0
        for name, (warm, sched, hi_tail) in variants.items():
            xw = x0_b if warm else None
            tail = kkt_schulz.default_hi_tail(sched, hi_tail)
            way = kkt_schulz.route(sched, tail)
            got = kkt_schulz.kkt_schulz(*ops_b, x0=xw, coeffs=sched,
                                        hi_tail=tail)
            want = kkt_schulz.kkt_schulz_plain(*ops_b, x0=xw, coeffs=sched)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            # the gate: the error per scenario, relative to that scenario's
            # largest entry, in balanced coordinates (X_b = S^-1 X S^-1).
            # There every block of the inverse is O(1), so the small blocks
            # of the equality (swing-leg) rows weigh as much as the large
            # ones, and a low-scale scenario as much as the largest.
            worst_b = float(per_scenario_balanced_error(got, want, m_b).max())
            # balanced residual inf-norm ||M_b X_b - I|| of each, per scenario
            res = lambda xb: (mb @ xb - eye).abs().sum(-1).amax(-1)
            res_k, res_p = res(got / unb), res(want / unb)
            res_gap = float((res_k - res_p).abs().max())
            finite = bool(torch.isfinite(got).all())
            passed = finite and worst_b <= tol
            tc = (schulz_tf32_products(b, sched, tail)
                  if tail < len(sched) else 0)
            emu_line = "no 3xTF32 step (emulation gate n/a)"
            if tc:
                emu = kkt_schulz.kkt_schulz_plain(
                    *ops_b, x0=xw, coeffs=sched, hi_tail=tail,
                    middle_matmul=kkt_schulz.matmul_3xtf32)
                worst_e = float(per_scenario_balanced_error(got, emu,
                                                            m_b).max())
                passed &= worst_e <= K1_EMU_TOL
                emu_line = (f"against the 3xTF32 emulation {worst_e:.3e} "
                            f"(tolerance {K1_EMU_TOL:g})")
            t = cuda_times({
                "kernel": lambda: kkt_schulz.kkt_schulz(
                    *ops_b, x0=xw, coeffs=sched, hi_tail=tail),
                "plain": lambda: kkt_schulz.kkt_schulz_plain(
                    *ops_b, x0=xw, coeffs=sched),
                "library": lambda: torch.linalg.inv(m_b)}, reps)
            products = schulz_products(b, xw, sched, n_ok)
            nbytes = in_bytes + (2 if warm else 1) * mat_bytes
            bound_ms, bound_by = bound((products - tc) * prod + build_flops,
                                       nbytes, tc * prod)
            bound_fp32_ms, _ = bound(products * prod + build_flops, nbytes)
            lines.append(
                f"K1 {name} batch {b}: route {way}, {len(sched)} steps "
                f"({tc // max(b, 1) // 2} 3xTF32, hi_tail {tail}), "
                f"basin-accepted {n_ok if warm else 0}/{b if warm else 0}, "
                f"max_abs_err {err:.3e} (relative to max|plain| {rel:.3e});"
                f" worst per-scenario balanced error {worst_b:.3e} "
                f"(tolerance {tol:g}), {emu_line}; balanced residual max "
                f"kernel {float(res_k.max()):.3e} plain "
                f"{float(res_p.max()):.3e}, largest gap {res_gap:.3e}; "
                f"kernel_ms {t['kernel']:.4f}, plain_ms {t['plain']:.4f}, "
                f"bound_ms {bound_ms:.4f} ({bound_by}; FP32-only bound "
                f"{bound_fp32_ms:.4f}), library_ms {t['library']:.4f} "
                f"(torch.linalg.inv of the built M, the inverse only) "
                f"{'PASS' if passed else 'FAIL'}")
            records[(name, b)] = dict(
                err=err, kernel_ms=t["kernel"], plain_ms=t["plain"],
                library_ms=t["library"], bound_ms=bound_ms,
                bound_fp32_ms=bound_fp32_ms, bound_by=bound_by, route=way,
                passed=passed)
    warm = records[("warm_refine=1", batch)]
    record = {
        "name": "kkt_schulz", "route": "cuda",
        "source": "go1_qp_mpc_controller_torch/csrc/kkt_schulz.cu",
        "replaces": "go1_qp_mpc_controller_tpu/ops/pallas_admm.py:394",
        "max_abs_err": max(r["err"] for r in records.values()),
        "ms": warm["kernel_ms"], "plain_ms": warm["plain_ms"],
        "bound_ms": warm["bound_ms"], "bound_by": warm["bound_by"],
        "library_ms": warm["library_ms"],
        "by_variant": {f"{name} batch {b} ({r['route']})": {
            k: r[k] for k in ("kernel_ms", "plain_ms", "library_ms",
                              "bound_ms", "bound_fp32_ms")}
            for (name, b), r in records.items()}}
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
    """K2 against its plain version on all 11 outputs, at ``batch`` and on
    the first scenario alone."""
    import torch
    from go1_qp_mpc_controller_torch.ops import observe_ekf

    from go1_qp_mpc_controller_torch.ops import schulz_lanes

    full = random_ekf_inputs(batch, gen, device)
    lines, records, all_passed = [], {}, True
    for b in (batch, 1):
        args = [t[:b].contiguous() for t in full[:9]] + full[9:]
        got = observe_ekf.observe_ekf(*args)
        k4_before = schulz_lanes.launches
        want = observe_ekf.observe_ekf_plain(*args)
        torch.cuda.synchronize()
        # the plain version stays plain: its innovation inverse is not K4
        plain_k4 = schulz_lanes.launches - k4_before
        worst, max_err, passed = 0.0, 0.0, plain_k4 == 0
        for name, _ in observe_ekf.OUTPUTS:
            tol = 5e-4 if name in ("x", "P") else 1e-5
            w = want[name].float()
            err = float((got[name] - w).abs().max())
            atol = tol * max(1.0, float(w.abs().max()))
            passed &= bool(torch.isfinite(got[name]).all()) and err <= atol
            worst = max(worst, err / atol)
            max_err = max(max_err, err)
        t = cuda_times({
            "kernel": lambda: observe_ekf.observe_ekf(*args),
            "plain": lambda: observe_ekf.observe_ekf_plain(*args)}, reps)
        # bytes: each input read once, each output written once
        in_floats = 18 + 324 + 4 + 3 + 3 + 12 + 12 + 4 + 1
        out_floats = sum(math.prod(shape)
                         for _, shape in observe_ekf.OUTPUTS)
        nm, ns = 28, 18
        flops_per = (22 * 2 * nm ** 3            # Schulz, first step folded
                     + 2 * ns * nm * nm          # gain K = P C' S^-1
                     + 2 * 2 * ns ** 3           # (I - K C) P (I - K C)'
                     + 2 * ns * ns * nm          # K R K'
                     + 2 * ns * nm)              # K err
        bound_ms, bound_by = bound(b * flops_per,
                                   b * (in_floats + out_floats) * F32)
        lines.append(
            f"K2 observe+EKF: batch {b}, 11 outputs, max_abs_err "
            f"{max_err:.3e} (worst err/tolerance {worst:.3f}; tolerance "
            f"5e-4 on x, P and 1e-5 elsewhere, x max(1, max|plain|)), "
            f"kernel_ms {t['kernel']:.4f}, plain_ms {t['plain']:.4f}, "
            f"bound_ms {bound_ms:.4f} ({bound_by}); K4 launches in the "
            f"plain version {plain_k4} (must be 0) "
            f"{'PASS' if passed else 'FAIL'}")
        records[b] = dict(err=max_err, kernel_ms=t["kernel"],
                          plain_ms=t["plain"], bound_ms=bound_ms,
                          bound_by=bound_by)
        all_passed &= passed
    main = records[batch]
    record = {
        "name": "observe_ekf", "route": "cuda",
        "source": "go1_qp_mpc_controller_torch/csrc/observe_ekf.cu",
        "replaces": "go1_qp_mpc_controller_tpu/ops/pallas_ekf.py:280",
        "max_abs_err": max(r["err"] for r in records.values()),
        "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "batch1_ms": records[1]["kernel_ms"],
        "batch1_plain_ms": records[1]["plain_ms"],
        "batch1_bound_ms": records[1]["bound_ms"]}
    return record, lines, all_passed


def device_trace(run):
    """Run ``run()`` under torch.profiler: ([(start_us, end_us, kernel
    name)] of the device events, wall us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    events = [(ev.time_range.start, ev.time_range.end, ev.name)
              for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    return events, wall_us


def busy_us(events):
    """The union of the events' device intervals, in us."""
    busy, last = 0.0, -math.inf
    for start, end, _ in sorted(events):
        if end > last:
            busy += end - max(start, last)
            last = end
    return busy


def profile_lines(run, ticks, wall_ms_per_tick):
    """Device time by kernel over ``run()`` (``ticks`` more main-path
    ticks) from torch.profiler: device time per tick against the
    un-profiled wall time per tick ``wall_ms_per_tick`` (the profiler's own
    host overhead inflates the profiled wall time), and the kernels that
    take the most device time."""
    events, wall_us = device_trace(run)
    if not events:
        return ["profile: torch.profiler recorded no device events"]
    by_name = {}
    for start, end, name in events:
        name = name.replace("(anonymous namespace)::", "").split("(")[0]
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + end - start, cnt + 1)
    total = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    per_tick = busy_us(events) / 1e3 / ticks
    lines = [f"profile: {ticks} ticks, device busy {per_tick:.3f} ms a tick "
             f"({100 * per_tick / wall_ms_per_tick:.1f}% of the "
             f"{wall_ms_per_tick:.3f} ms un-profiled wall time a tick; "
             f"profiled wall {wall_us / 1e3 / ticks:.3f} ms a tick), "
             f"{len(events) / ticks:.0f} kernel launches a tick"]
    lines += [f"profile: {t / 1e3 / ticks:.3f} ms a tick "
              f"({100 * t / total:.1f}%) in {c / ticks:g} launches a tick: "
              f"{name[:80]}" for name, (t, c) in top]
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
    # the ticks' own launches: the captures' warm-up runs apart
    own = tick_counts(counts)

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
        "k2_launches==ticks": own["observe_ekf"] == ticks,
        "k1_launches>=ticks": own["kkt_schulz"] >= ticks,
        # every route ends in at least one ADMM loop on K6
        "k6_launches>=ticks": own["admm_iterations"] >= ticks,
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
        f"{compact_k1}); launches {json.dumps(counts)}, of them the "
        f"{ticks} ticks' {json.dumps(own)}",
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


def schulz_tf32_products(batch, coeffs, hi_tail):
    """Of :func:`schulz_products`, those the n = 120 kernels run 3xTF32:
    both products of each step after the first and before the last
    ``hi_tail``."""
    return batch * 2 * max(0, len(coeffs) - hi_tail - 1)


def basin_accepted(m, x0):
    """How many scenarios' warm starts pass the basin test."""
    import torch
    s = torch.rsqrt(torch.diagonal(m, dim1=-2, dim2=-1))
    unb = s[:, :, None] * s[:, None, :]
    inner = (m * unb) @ (x0 / unb)
    ok = ((torch.diagonal(inner, dim1=-2, dim2=-1).amin(-1) > 1e-4)
          & (inner.abs().sum(-1).amax(-1) < 3.0))
    return int(ok.sum())


def riccati_g(batch, seed, device, h=LH_HORIZONS[0]):
    """K3's operands on the stagewise path: the 12 x 12 matrices
    G = Rbar + B' S B that the first Riccati pass of ``stagewise_chain``'s
    cold solve on ``batch`` sweep scenarios hands to K3, recorded as it
    hands them. Returns them by stage, (h, batch, 12, 12)."""
    import torch
    from go1_qp_mpc_controller_torch.ops import admm

    recorded, inverse = [], admm._schulz_inverse

    def record(g, *args, **kw):
        recorded.append(g.clone())
        return inverse(g, *args, **kw)

    admm._schulz_inverse = record
    try:
        stagewise_chain(random_scenarios(batch, seed, device), h, 0)
    finally:
        admm._schulz_inverse = inverse
    return torch.stack(recorded[:h][::-1])


def k3_phase(batch, gen, device, reps):
    """K3 against its plain version: n = 120 KKTs (``kkt_build_plain`` of
    ``random_kkt_operands``) with the dense solve's 20 plain steps cold,
    the scaled l0 = 1e-6 schedule cold, and 20 steps from a warm start
    (an eighth of the batch given a start that fails the basin test), at
    ``batch`` and on the first 16 and 1 of them (each line names the route
    the wrapper took: one block a matrix above ``CROSSOVER``, a cluster of
    8 up to it); n = 12 balance-QP KKTs cold and warm with 20 plain
    steps; n = 12 stagewise Riccati matrices (``riccati_g``, the first and
    the last stage, at batch ``LH_BATCH`` and on the first 1 of them: the
    long-horizon paths hand K3 both batches) cold with the Riccati pass's
    scaled l0 = 1e-7 schedule.
    Gated per scenario in balanced coordinates against the float32
    plain version (3e-4) and, at n = 120, against the plain version with
    the kernel's 3xTF32 middle products (``K3_EMU_TOL``). Kernel, plain
    version and library call are timed in turn (``cuda_times``). Returns
    (record, lines, passed)."""
    import torch
    from go1_qp_mpc_controller_torch.ops import admm, kkt_schulz, schulz_batch

    coeffs = admm._scaled_schulz_coeffs
    plain20 = (1.0,) * 20
    m120 = kkt_schulz.kkt_build_plain(*random_kkt_operands(batch, gen,
                                                           device))
    m12 = random_balance_kkts(batch, gen, device)
    g_stages = riccati_g(LH_BATCH, int(torch.randint(1 << 30, (1,),
                                                     generator=gen)), device)
    g12, g12_last = g_stages[0], g_stages[-1].contiguous()
    bad = (torch.arange(batch, device=device) % 8 == 0)[:, None, None]

    def warm_start(m):
        good = schulz_batch.schulz_inverse_batch(m, coeffs=coeffs(1e-6))
        return torch.where(bad, -good, good).contiguous()

    x120, x12 = warm_start(m120), warm_start(m12)
    head = lambda t, b: t[:b].contiguous()
    variants = {
        "n=120 cold 20 steps": (m120, None, plain20),
        "n=120 cold l0=1e-6": (m120, None, coeffs(1e-6)),
        "n=120 warm 20 steps": (m120, x120, plain20),
        "n=120 warm 1 step": (m120, x120, (1.0,)),
        "n=120 cold 20 steps, batch 16": (head(m120, 16), None, plain20),
        "n=120 warm 20 steps, batch 16": (head(m120, 16), head(x120, 16),
                                          plain20),
        "n=120 cold 20 steps, batch 1": (head(m120, 1), None, plain20),
        "n=12 cold 20 steps": (m12, None, plain20),
        "n=12 warm 20 steps": (m12, x12, plain20),
        f"n=12 Riccati G cold l0=1e-7, batch {LH_BATCH}": (
            g12, None, coeffs(1e-7)),
        "n=12 Riccati G cold l0=1e-7, batch 1": (
            head(g12, 1), None, coeffs(1e-7)),
        f"n=12 Riccati G stage {len(g_stages) - 1} cold l0=1e-7, batch "
        f"{LH_BATCH}": (g12_last, None, coeffs(1e-7)),
        f"n=12 Riccati G stage {len(g_stages) - 1} cold l0=1e-7, batch 1": (
            head(g12_last, 1), None, coeffs(1e-7)),
    }
    tol = 3e-4
    lines, records = [], {}
    for name, (m, x0, sched) in variants.items():
        b, n = m.shape[0], m.shape[-1]
        tail = schulz_batch.default_hi_tail(sched)
        route = schulz_batch.route(n, b, sched)
        got = schulz_batch.schulz_inverse_batch(m, x0, sched)
        want = kkt_schulz.schulz_balanced_plain(m, x0, sched)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst_b = float(per_scenario_balanced_error(got, want, m).max())
        finite = bool(torch.isfinite(got).all())
        passed = finite and worst_b <= tol
        emu_line = "emulation gate n/a (n = 12 runs FP32)"
        worst_e = None
        if n == 120:
            emu = kkt_schulz.schulz_balanced_plain(
                m, x0, sched, tail, kkt_schulz.matmul_3xtf32)
            worst_e = float(per_scenario_balanced_error(got, emu, m).max())
            passed &= worst_e <= K3_EMU_TOL
            emu_line = (f"against the 3xTF32 emulation {worst_e:.3e} "
                        f"(tolerance {K3_EMU_TOL:g})")
        n_ok = basin_accepted(m, x0) if x0 is not None else 0
        t = cuda_times({
            "kernel": lambda: schulz_batch.schulz_inverse_batch(m, x0, sched),
            "plain": lambda: kkt_schulz.schulz_balanced_plain(m, x0, sched),
            "library": lambda: torch.linalg.inv(m)}, reps)
        products = schulz_products(b, x0, sched, n_ok)
        tc = schulz_tf32_products(b, sched, tail) if n == 120 else 0
        mats = 2 if x0 is None else 3
        flop = 2.0 * n ** 3
        nbytes = mats * b * n * n * F32
        bound_ms, bound_by = bound((products - tc) * flop, nbytes, tc * flop)
        bound_fp32_ms, _ = bound(products * flop, nbytes)
        lines.append(
            f"K3 {name}: route {route}, batch {b}, {len(sched)} steps "
            f"({tc // max(b, 1) // 2} 3xTF32), basin-accepted "
            f"{n_ok}/{b if x0 is not None else 0}, max_abs_err "
            f"{err:.3e}; worst per-scenario balanced error {worst_b:.3e} "
            f"(tolerance {tol:g}), {emu_line}; kernel_ms "
            f"{t['kernel']:.4f}, plain_ms {t['plain']:.4f}, bound_ms "
            f"{bound_ms:.4f} ({bound_by}; FP32-only bound "
            f"{bound_fp32_ms:.4f}), library_ms {t['library']:.4f} "
            f"(torch.linalg.inv of the same matrices; medians of {SPANS} "
            f"interleaved spans of {reps}) {'PASS' if passed else 'FAIL'}")
        records[name] = dict(err=err, kernel_ms=t["kernel"],
                             plain_ms=t["plain"], bound_ms=bound_ms,
                             bound_fp32_ms=bound_fp32_ms, bound_by=bound_by,
                             library_ms=t["library"], passed=passed)
    main = records["n=120 cold 20 steps"]
    one = records["n=120 cold 20 steps, batch 1"]
    riccati = records[f"n=12 Riccati G cold l0=1e-7, batch {LH_BATCH}"]
    record = {
        "name": "schulz_batch", "route": "cuda",
        "source": "go1_qp_mpc_controller_torch/csrc/schulz_batch.cu",
        "replaces": "go1_qp_mpc_controller_tpu/ops/pallas_admm.py:477",
        "max_abs_err": max(r["err"] for r in records.values()),
        "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "bound_fp32_ms": main["bound_fp32_ms"],
        "batch1_ms": one["kernel_ms"], "batch1_library_ms": one["library_ms"],
        "riccati_n12_ms": riccati["kernel_ms"],
        "riccati_n12_bound_ms": riccati["bound_ms"],
        "riccati_n12_plain_ms": riccati["plain_ms"],
        "riccati_n12_library_ms": riccati["library_ms"]}
    return record, lines, all(r["passed"] for r in records.values())


def k3_route_phase(gen, device, reps):
    """K3's two n = 120 routes (``schulz_batch._launch`` with 8 blocks per
    matrix, then 1) timed in turn with ``torch.linalg.inv`` on the first
    1, 2, 4, 8, 12, 16 and 32 of 32 random KKTs, 20 plain steps cold; each
    route within ``K3_EMU_TOL`` of the 3xTF32 emulation per scenario in
    balanced coordinates; the routes' gap is 0, as they give the same bits
    (tests/test_torch_kernels_cuda.py holds that). Prints the batches at
    which the cluster route is faster (``schulz_batch.CROSSOVER`` is set
    from them). Returns (None, lines, passed)."""
    import torch
    from go1_qp_mpc_controller_torch.ops import kkt_schulz, schulz_batch

    m32 = kkt_schulz.kkt_build_plain(*random_kkt_operands(32, gen, device))
    sched, tail = (1.0,) * 20, 2
    lines, passed, faster = [], True, []
    for b in ROUTE_BATCHES:
        m = m32[:b].contiguous()
        run = lambda cl: schulz_batch._launch(m, None, sched, tail, cl)
        emu = kkt_schulz.schulz_balanced_plain(m, None, sched, tail,
                                               kkt_schulz.matmul_3xtf32)
        got = {"cluster": run(schulz_batch.CLUSTER), "cta": run(1)}
        err = {k: float(per_scenario_balanced_error(v, emu, m).max())
               for k, v in got.items()}
        gap = float(per_scenario_balanced_error(got["cluster"], got["cta"],
                                                m).max())
        t = cuda_times({"cluster": lambda: run(schulz_batch.CLUSTER),
                        "cta": lambda: run(1),
                        "library": lambda: torch.linalg.inv(m)}, reps)
        ok = max(err.values()) <= K3_EMU_TOL
        passed &= ok
        if t["cluster"] < t["cta"]:
            faster.append(b)
        lines.append(
            f"K3 routes at batch {b} (n = 120, 20 steps cold): cluster_ms "
            f"{t['cluster']:.4f}, cta_ms {t['cta']:.4f}, library_ms "
            f"{t['library']:.4f}; against the 3xTF32 emulation cluster "
            f"{err['cluster']:.3e}, cta {err['cta']:.3e} (tolerance "
            f"{K3_EMU_TOL:g}), routes' gap {gap:.3e} "
            f"{'PASS' if ok else 'FAIL'}")
    lines.append(f"K3 routes: the cluster route is faster at batch "
                 f"{faster}; CROSSOVER = {schulz_batch.CROSSOVER}")
    return None, lines, passed


def random_scenarios(batch, seed, device):
    """Seeded random stand / trot MPC scenarios: the port's
    ``parallel/sweep.random_scenarios`` (the JAX package's draws, bit for
    bit), float32 on ``device``."""
    import torch
    from go1_qp_mpc_controller_torch.parallel import sweep
    return sweep.random_scenarios(seed, batch, torch.float32, device)


def condense(scn, x0, dense):
    """The scenarios' condensed QPs at start state ``x0`` (B, 13): lazy, or
    dense (``srb.CondensedQP``) with ``dense``, discretized at the sweep's
    0.0025 s as ``sweep.discretize`` does."""
    from go1_qp_mpc_controller_torch.models import srb
    from go1_qp_mpc_controller_torch.parallel import sweep

    a_d, b_d = sweep.discretize(scn, 0.0025, x0)
    fn = srb.condense_nilpotent_const if dense else srb.condense_nilpotent_lazy
    return fn(a_d, b_d, x0, scn.x_ref, scn.q_weights, scn.r_weights,
              scn.contacts)


def tight_reference(scn, x0, n):
    """First-step GRFs (n, 12) of the tight polished solve (bench.py:91-94:
    dense ``mpc_solve``, 4 segments x 80 iterations, polished with inv) of
    the first ``n`` scenarios' QPs at start state ``x0``, condensed and
    solved in float64 on the CPU by the kernels' plain versions: a
    reference that no kernel's rounding moves, the same for any checkout
    with the same scenarios."""
    import torch
    from go1_qp_mpc_controller_torch.ops import admm
    from go1_qp_mpc_controller_torch.parallel import sweep

    f64 = torch.float64
    sub = on_cpu(sweep.take(scn, slice(0, n)), f64)
    settings = admm.ADMMSettings(seg_iters=80, segments=4, polish=True,
                                 polish_solver="inv")
    sol = admm.mpc_solve(condense(sub, x0[:n].cpu().to(f64), dense=True),
                         settings, mu=sub.mu)
    return sol.x[:, :12]


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
    last tick's GRFs against the tight polished reference in float64 on the
    CPU (``tight_reference``) on ``TIGHT_SCENARIOS`` scenarios. Then K6
    alone against its plain version at 20 and 80 iterations on this
    chain's operands. Returns (path counts, K6 record, lines, passed)."""
    import torch
    from go1_qp_mpc_controller_torch.ops import admm, admm_iterations

    scn = random_scenarios(batch, seed, device)
    mu = scn.mu
    settings_cold = admm.ADMMSettings(seg_iters=40, segments=1, polish=False,
                                      schulz_l0=1e-6, schulz_hi_tail=1,
                                      schulz_impl="pallas")
    settings_warm = admm.ADMMSettings(seg_iters=15, segments=1, polish=False,
                                      schulz_refine=1, schulz_impl="pallas")
    drift = torch.zeros((batch, 13), device=device)
    drift[:, 9] = 0.001
    drift[:, 3] = 0.0005

    reset_counts()
    lazy = condense(scn, scn.x0, dense=False)
    sol0, warm = admm.mpc_solve_cold(lazy, settings_cold, mu=mu,
                                     contacts=scn.contacts,
                                     foot_pos=scn.foot_pos)
    x0 = scn.x0
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
    # the last tick's GRFs against the float64 tight reference
    qps_last, _, sol_last = kept[CHAIN_TICKS - 1]
    tight = tight_reference(scn, x0, TIGHT_SCENARIOS)
    grf_err = (sol_last.x[:TIGHT_SCENARIOS, :12].cpu().double()
               - tight).abs().amax(-1)
    p50 = float(grf_err.median())
    p90 = float(torch.quantile(grf_err, 0.9))
    finite = (bool(torch.isfinite(sol_last.x).all())
              and bool(torch.isfinite(sol0.x).all())
              and bool(torch.isfinite(tight).all()))
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
        f"segments x 80 iterations, polished with inv, float64 on the CPU)",
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
    80 iterations) on ``ops`` (the dense chain's operands at batch 4096)
    and on their first ``K6_BATCHES`` scenarios, per scenario: x within
    ``K6_TOL`` of the plain loop and within ``K6_F64_TOL`` of the loop in
    float64, y within 0.1 (1 + max|y_plain|). Then one scenario of batch
    133 poisoned with NaN in qbar: its x and y come back non-finite and
    every other scenario bit-identical to the unpoisoned run. Returns
    (lines, record, passed)."""
    import torch
    from go1_qp_mpc_controller_torch.ops import admm_iterations

    full = ops["minv"].shape[0]
    lines, records = [], {}
    for batch in (full,) + K6_BATCHES:
        ops_b = {k: v[:batch] for k, v in ops.items()}
        in_bytes = batch * (N * N + 2 * N + 4 * 200 + 1) * F32
        out_bytes = batch * (N + 2 * 200) * F32          # x, z and y
        for iters in (20, 80):
            x, y = admm_iterations.admm_iterations(**ops_b, iters=iters)
            xw, yw = admm_iterations.admm_iterations_plain(
                **ops_b, iters=iters, alpha=1.6, sigma=1e-6)
            torch.cuda.synchronize()
            dx = (x - xw).abs().amax(-1)
            dy = (y - yw).abs().amax(-1) / (1.0 + yw.abs().amax(-1))
            x64 = loop_float64(ops_b, iters)
            err_k = float((x.double() - x64).abs().amax(-1).max())
            err_p = float((xw.double() - x64).abs().amax(-1).max())
            finite = bool(torch.isfinite(x).all()
                          and torch.isfinite(y).all())
            passed = (finite and float(dx.max()) < K6_TOL
                      and err_k <= K6_F64_TOL and float(dy.max()) < 0.1)
            kernel_ms = cuda_ms(lambda: admm_iterations.admm_iterations(
                **ops_b, iters=iters), reps)
            plain_ms = cuda_ms(lambda: admm_iterations.admm_iterations_plain(
                **ops_b, iters=iters, alpha=1.6, sigma=1e-6), reps)
            bound_ms, bound_by = bound(k6_flops(batch, iters),
                                       in_bytes + out_bytes)
            lines.append(
                f"K6 {iters} iterations: batch {batch}, worst per-scenario "
                f"max|x_K6 - x_plain| {float(dx.max()):.3e} (tolerance "
                f"{K6_TOL:g}; {int((dx > K6_TOL).sum())} scenarios above); "
                f"against the float64 loop: K6 worst {err_k:.3e} (tolerance "
                f"{K6_F64_TOL:g}), plain float32 worst {err_p:.3e}; "
                f"max|dy|/(1+max|y|) {float(dy.max()):.3e} (tolerance 0.1); "
                f"kernel_ms {kernel_ms:.4f}, plain_ms {plain_ms:.4f}, "
                f"bound_ms {bound_ms:.4f} ({bound_by}) "
                f"{'PASS' if passed else 'FAIL'}")
            records[batch, iters] = dict(
                err=float((x - xw).abs().max()), kernel_ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                passed=passed)
    line, contained = k6_nan_check(ops)
    lines.append(line)
    main = records[full, 20]
    record = {
        "name": "admm_iterations", "route": "cuda",
        "source": "go1_qp_mpc_controller_torch/csrc/admm_iterations.cu",
        "replaces": "go1_qp_mpc_controller_tpu/ops/pallas_admm.py:733",
        "max_abs_err": max(r["err"] for r in records.values()),
        "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None}
    return (lines, record,
            all(r["passed"] for r in records.values()) and contained)


def k6_nan_check(ops, batch=133, poisoned=66, iters=20):
    """K6 on the first ``batch`` scenarios of ``ops`` with scenario
    ``poisoned``'s qbar set to NaN: that scenario's x and y come back
    non-finite, every other one's x, z and y bit-identical to the run
    without the poison. Returns (line, passed)."""
    import torch
    from go1_qp_mpc_controller_torch.ops import admm_iterations

    ops_b = {k: v[:batch].clone() for k, v in ops.items()}
    z0 = torch.clamp(torch.zeros_like(ops_b["lb"]), ops_b["lb"], ops_b["ub"])
    args = lambda o: (o["minv"], o["qbar"], o["lb"], o["ub"], o["rho_vec"],
                      o["mu"], o["x0"], z0, o["y0"], iters, 1.6, 1e-6)
    clean = admm_iterations.admm_loop(*args(ops_b))
    ops_b["qbar"][poisoned] = float("nan")
    dirty = admm_iterations.admm_loop(*args(ops_b))
    keep = torch.arange(batch, device=z0.device) != poisoned
    same = all(torch.equal(c[keep], d[keep]) for c, d in zip(clean, dirty))
    poisoned_out = (not bool(torch.isfinite(dirty[0][poisoned]).any())
                    and not bool(torch.isfinite(dirty[2][poisoned]).any()))
    passed = same and poisoned_out
    return (f"K6 NaN containment: batch {batch}, qbar of scenario {poisoned} "
            f"NaN, {iters} iterations from a carried z: its x and y all "
            f"non-finite {poisoned_out}; the other {batch - 1} scenarios' x, "
            f"z, y bit-identical to the clean run {same} "
            f"{'PASS' if passed else 'FAIL'}"), passed


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


def capture_cache_line():
    """What the capture cache (``rollout.cached_step``) saw in this
    process, for the one-robot and the batched steps: the static
    configurations captured, the captures (a configuration captured again
    had been evicted), the card memory the captures reserved, and how many
    steps it keeps."""
    from go1_qp_mpc_controller_torch.envs import rollout
    lines = []
    for batched, name, keep in ((False, "one-robot", rollout._KEEP),
                                (True, "batched", rollout._KEEP_BATCHED)):
        caps = [v for k, v in rollout._CAPTURES.items()
                if rollout._batched(k) == batched]
        n = sum(c for c, _ in caps)
        mib = [b / 2 ** 20 for _, b in caps]
        kept = sum(rollout._batched(k) == batched
                   for k in rollout._CAPTURED)
        lines.append(
            f"{name} capture cache: {len(caps)} configurations, {n} "
            f"captures ({n - len(caps)} after an eviction), card memory "
            f"reserved by a capture max {max(mib, default=0.0):.1f} MiB, "
            f"total {sum(mib):.1f} MiB; {kept} kept of at most {keep}")
    return "\n".join(lines)


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
    mpc_ticks = tick_counts(mpc_counts)
    mpc_replayed = replayed_counts()
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
    qp_ticks = tick_counts(qp_counts)
    qp_replayed = replayed_counts()
    zq_err = float((trq.root_pos[150:, 0, 2] - 0.3).abs().max())
    finite_q = bool(torch.isfinite(trq.root_pos).all())
    checks = {
        "mpc_finite": finite,
        "mpc_vx_within_15%": abs(vx - 0.25) <= 0.15 * 0.25,
        "mpc_height_within_0.05": z_err < 0.05,
        "mpc_k1_k2_k3_launched": all(mpc_counts[k] > 0 for k in (
            "kkt_schulz", "observe_ekf", "schulz_batch")),
        # every tick ends in at least one ADMM loop on K6
        "mpc_k6_launches>=ticks": mpc_ticks["admm_iterations"]
                                  >= ROBOT_TICKS,
        # the ticks' own launches: the captures' warm-up runs apart
        "mpc_k3_3_per_cold_tick": mpc_ticks["schulz_batch"]
                                  == 3 * (stats.get("cold", 0)
                                          + stats.get("health", 0)),
        "qp_finite": finite_q, "qp_height_within_0.05": zq_err < 0.05,
        "qp_k3_ticks_x_segments": qp_ticks["schulz_batch"]
                                  == QP_TICKS * settings.segments,
        # every tick's launch came from a graph replay
        "mpc_ticks_launch_only_in_replays": mpc_ticks == mpc_replayed,
        "qp_ticks_launch_only_in_replays": qp_ticks == qp_replayed}
    lines = [
        f"one robot (rollout, batch 1, EKF on, polished cold solves): "
        f"{ROBOT_STAND_TICKS} standing then trot 0.25 m/s to {ROBOT_TICKS} "
        f"ticks; tick wall time p50 {_pct(walls, 50):.3f} ms, p99 "
        f"{_pct(walls, 99):.3f} ms, max {_pct(walls, 100):.3f} ms "
        f"(synchronized each tick; captured steps) on {card}; routes "
        f"{json.dumps(stats)}; launches {json.dumps(mpc_counts)}, of them "
        f"the ticks' {json.dumps(mpc_ticks)}; mean vx over ticks 400+ "
        f"{vx:.4f} m/s, max |z - 0.3| from tick 200 {z_err:.4f} m",
        f"one robot, balance-QP stand: {QP_TICKS} ticks, tick wall time p50 "
        f"{_pct(walls_q, 50):.3f} ms, p99 {_pct(walls_q, 99):.3f} ms; "
        f"launches {json.dumps(qp_counts)}, of them the ticks' "
        f"{json.dumps(qp_ticks)}; max |z - 0.3| from tick 150 "
        f"{zq_err:.4f} m"]
    lines += ["one robot " + line for line in profile]
    lines += [
        f"one robot checks {json.dumps(checks)} "
        f"{'PASS' if all(checks.values()) else 'FAIL'}"]
    return ({"robot_mpc": mpc_counts, "robot_qp": qp_counts}, lines,
            all(checks.values()))


# the captured steps: one robot's ticks two ways from one batch-1 carry,
# the eager composition of ``rollout.tick_parts`` (the functions the card
# captures, called directly) and ``rollout.rollout`` (the captured steps):
# CAPTURED_TICKS MPC ticks, standing to CAPTURED_WALK_AT and then trotting
# (the warm, window and cold routes), the carried KKT inverse negated at
# the standing warm tick CAPTURED_POISON_AT (the health re-solve), and
# CAPTURED_TICKS balance-QP ticks; then CAPTURED_PROFILE_TICKS more
# captured MPC ticks under the profiler
CAPTURED_TICKS = 400
CAPTURED_WALK_AT = 100
CAPTURED_POISON_AT = 90
CAPTURED_PROFILE_TICKS = 60


def captured_steps_phase(device, card):
    """One robot (batch 1, float32, polished cold settings, the EKF on for
    the MPC) through the eager composition of ``rollout.tick_parts`` and
    through ``rollout.rollout``'s captured steps, tick by tick (a sync
    each tick). Gates, per solver: every trace record and the final carry
    (torques, GRFs, the warm carry) equal bit for bit, the launches equal
    per kernel and per route (the captures' warm-up runs apart) and all
    of the captured ticks' launches made by graph replays, the route
    sequences equal, the MPC's visiting warm, window, cold and the health
    re-solve, and the captured tick's p50 below the eager one.
    Returns (counts by path, lines, passed)."""
    import statistics
    import torch
    from go1_qp_mpc_controller_torch.ctrl import controller
    from go1_qp_mpc_controller_torch.envs import rollout
    from go1_qp_mpc_controller_torch.models import types
    from go1_qp_mpc_controller_torch.ops import admm
    from go1_qp_mpc_controller_torch.utils import graphs
    from torch.utils import _pytree as pytree

    f32 = torch.float32
    model = types.default_robot_model(f32, device)
    params = types.default_ctrl_params(f32, device)
    settings = admm.ADMMSettings(**POLISHED)
    walk = _walk_command(CAPTURED_WALK_AT, 0.25)

    def mpc_command(tick, ctrl):
        ctrl = walk(tick)(tick, ctrl)
        if tick == CAPTURED_POISON_AT:
            ctrl = ctrl._replace(qp_warm_minv=-ctrl.qp_warm_minv)
        return ctrl

    def eager(parts, command):
        carry = rollout.init_carry(model, params, 1, dtype=f32,
                                   device=device)
        records, routes, walls = [], [], []
        for tick in range(CAPTURED_TICKS):
            t0 = time.perf_counter()
            if command is not None:
                carry = carry._replace(ctrl=command(tick, carry.ctrl))
            taken, (carry, record) = graphs.compose_stages(
                parts, carry, model, params)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            records.append(record)
            routes.append(list(taken) or ["qp"])
        trace = type(records[0])(*[torch.stack(leaves)
                                   for leaves in zip(*records)])
        return carry, trace, routes, walls

    def captured(kw, command):
        carry = rollout.init_carry(model, params, 1, dtype=f32,
                                   device=device)
        records, routes, walls = [], [], []
        for tick in range(CAPTURED_TICKS):
            stats = {}
            t0 = time.perf_counter()
            carry, tr = rollout.rollout(
                carry, model, params, 1, 0.002, stats=stats,
                command_fn=None if command is None else (
                    lambda _, c, t=tick: command(t, c)), **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            records.append(tr)
            routes.append(list(stats) or ["qp"])
        trace = type(records[0])(*[torch.cat(leaves)
                                   for leaves in zip(*records)])
        return carry, trace, routes, walls

    counts_by_path, lines, checks = {}, [], {}
    for name, solver, estimate, command in (
            ("mpc", controller.MPC, True, mpc_command),
            ("qp", controller.QP, False, None)):
        kw = dict(solver_type=solver, settings=settings, estimate=estimate,
                  use_terrain_adapt=False,
                  warm_settings=controller.WARM_SETTINGS)
        parts = rollout.tick_parts(0.002, solver, settings, estimate, False,
                                   controller.WARM_SETTINGS)
        reset_counts()
        e_carry, e_trace, e_routes, e_walls = eager(parts, command)
        e_counts = read_counts()
        reset_counts()
        replays0 = graphs.replays
        c_carry, c_trace, c_routes, c_walls = captured(kw, command)
        replays = graphs.replays - replays0
        c_all = read_counts()
        c_counts = tick_counts(c_all)
        replayed = replayed_counts()
        counts_by_path[f"captured_{name}"] = c_all
        unequal = [i for i, (a, b) in enumerate(zip(
            pytree.tree_leaves((e_trace, e_carry)),
            pytree.tree_leaves((c_trace, c_carry)))) if not same_bits(a, b)]
        seen = sorted({r for taken in c_routes for r in taken})
        # the route read, and the health read where the routing rechecks
        recheck = controller.grf_routing(controller.WARM_SETTINGS)[2]
        reads = sum(0 if solver == controller.QP
                    else 1 + (taken[0] in recheck) for taken in c_routes)
        med = {w: statistics.median(t) * 1e3 for w, t in (
            ("eager", e_walls), ("captured", c_walls))}
        checks.update({
            f"{name}_bits_equal": not unequal,
            f"{name}_launches_equal": e_counts == c_counts,
            # no counted kernel of a captured tick ran outside a replay
            f"{name}_every_tick_launch_replayed": c_counts == replayed,
            f"{name}_routes_equal": e_routes == c_routes,
            f"{name}_captured_p50<eager_p50": med["captured"] < med["eager"]})
        if solver == controller.MPC:
            checks["mpc_routes_warm_window_cold_health"] = {
                "warm", "window", "cold", "health"} <= set(seen)
        lines.append(
            f"captured steps {name}: {CAPTURED_TICKS} ticks each way on "
            f"{card}; tick wall time eager p50 {_pct(e_walls, 50):.3f} ms, "
            f"p99 {_pct(e_walls, 99):.3f} ms; captured p50 "
            f"{_pct(c_walls, 50):.3f} ms, p99 {_pct(c_walls, 99):.3f} ms; "
            f"{replays / CAPTURED_TICKS:.3f} replays and "
            f"{reads / CAPTURED_TICKS:.3f} host reads a tick (route + "
            f"health); routes seen {seen}; trace and carry leaves that "
            f"differ {unequal}; launches eager {json.dumps(e_counts)}, "
            f"captured {json.dumps(c_all)} (ticks "
            f"{json.dumps(c_counts)})")
        if solver == controller.MPC:
            carry = c_carry
            profile = profile_lines(lambda: _robot_ticks(
                carry, model, params, CAPTURED_PROFILE_TICKS,
                lambda tick: walk(CAPTURED_TICKS + tick), **kw),
                CAPTURED_PROFILE_TICKS, _pct(c_walls, 50))
            lines += ["captured steps mpc " + line for line in profile]
    lines.append(f"captured steps checks {json.dumps(checks)} "
                 f"{'PASS' if all(checks.values()) else 'FAIL'}")
    return counts_by_path, lines, all(checks.values())


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
    own = tick_counts(counts)
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
        # the ticks' own launches: the captures' warm-up runs apart
        "k3_3_per_cold_tick": own["schulz_batch"] == 3 * cold_ticks,
        "k6_launches>=ticks": own["admm_iterations"]
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


def grf_gap(got, want):
    """Per-scenario max |got - want| (N) over each scenario's forces:
    {"p50", "p90", "max"}."""
    import torch
    err = (got.cpu().double() - want.cpu().double()).abs().flatten(1).amax(1)
    return {"p50": float(err.median()),
            "p90": float(torch.quantile(err, 0.9)), "max": float(err.max())}


def f64_gate(card, plain):
    """The card's float32 result against the float64 one is within
    ``F64_FACTOR`` x the plain float32 version's distance + ``F64_SLACK``
    N, at p50 and p90 (the max is printed: a lone flat-valley scenario
    moves it by N in either float32 run)."""
    return all(card[q] <= F64_FACTOR * plain[q] + F64_SLACK
               for q in ("p50", "p90"))


def gap_text(card, plain):
    return (f"p50 {card['p50']:.4f} / p90 {card['p90']:.4f} / max "
            f"{card['max']:.4f} N (plain float32 on the CPU {plain['p50']:.4f}"
            f" / {plain['p90']:.4f} / {plain['max']:.4f})")


def on_cpu(tree, dtype):
    """A copy of ``tree`` (a NamedTuple of tensors) on the CPU, its
    floating leaves in ``dtype``."""
    return type(tree)(*[v.cpu().to(dtype) if v.is_floating_point()
                        else v.cpu() for v in tree])


def wall_spans(fn, spans):
    """Wall seconds of ``spans`` synchronized calls of ``fn``."""
    import torch
    walls = []
    for _ in range(spans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def rate_text(n, walls):
    """``n`` solves a span: the median rate over the spans, with the
    slowest and fastest span's."""
    import statistics
    return (f"{n / statistics.median(walls):.1f} solves/s (spans "
            f"{n / max(walls):.1f}-{n / min(walls):.1f}, {len(walls)} "
            f"spans)")


def physical_bars(scn, grf):
    """tests/test_sharding.py:59-82's checks on a sweep's GRFs: swing legs
    carry no force (0.1 N), fz > -0.05, the friction cones hold (0.1 N)
    and the stance legs carry a fifth of the weight."""
    grf = grf.cpu().double()
    contacts = scn.contacts.cpu()
    mu = scn.mu.cpu().double()[:, None]
    fz = grf[..., 2]
    return {"swing<0.1": float(grf[~contacts].abs().max()) < 0.1,
            "fz>-0.05": bool((fz > -0.05).all()),
            "cone_x": bool((grf[..., 0].abs() <= mu * fz + 0.1).all()),
            "cone_y": bool((grf[..., 1].abs() <= mu * fz + 0.1).all()),
            "support>0.2mg": bool((fz.sum(-1) > 0.2 * scn.mass.cpu().double()
                                   * 9.8).all())}


def sweep_phase(seed, device, card, batch=SWEEP_BATCH, chunks=SWEEP_CHUNKS):
    """The scenario sweep (``parallel/sweep.py``): ``main.py sweep``'s
    program (``make_sweep_fn`` with main.py's settings and the preset's
    time step, the dense polished route: K3, K6) at ``batch``, then the
    fused cold route (``SWEEP_FUSED``: K1, K6) through ``run_chunked`` over
    ``chunks`` chunks of ``batch``, each counted in its first run and then
    timed over ``SWEEP_SPANS`` spans. Gates: finite outputs, one solve a
    scenario, the launches, the first ``SWEEP_F64_SCENARIOS`` scenarios'
    GRFs against the same solve in float64 on the CPU (``f64_gate``) and
    JAX's physical bars at its own size and settings. Returns (counts by
    path, lines, passed)."""
    import statistics

    import torch
    from go1_qp_mpc_controller_torch.config import presets
    from go1_qp_mpc_controller_torch.ops import admm
    from go1_qp_mpc_controller_torch.parallel import sweep
    from go1_qp_mpc_controller_torch.utils import roofline

    f32, f64 = torch.float32, torch.float64
    _, params, _ = presets.load_preset("gazebo_mpc", f32, device=device)
    dt = float(params.mpc_dt)
    routes = {"dense": admm.ADMMSettings(**SWEEP_DENSE),
              "fused": admm.ADMMSettings(**SWEEP_FUSED)}
    fns = {k: sweep.make_sweep_fn(device, dt, s) for k, s in routes.items()}
    scns = {"dense": sweep.random_scenarios(seed, batch, f32, device),
            "fused": sweep.random_scenarios(seed + 1, batch * chunks, f32,
                                            device)}
    runs = {"dense": lambda: fns["dense"](scns["dense"]),
            "fused": lambda: sweep.run_chunked(fns["fused"], scns["fused"],
                                               batch)}
    counts, outs, walls = {}, {}, {}
    for name, run in runs.items():
        reset_counts()
        outs[name] = run()
        counts[f"sweep_{name}"] = read_counts()
    for name, run in runs.items():
        walls[name] = wall_spans(run, SWEEP_SPANS)

    n = SWEEP_F64_SCENARIOS
    gaps = {}
    for name, settings in routes.items():
        head = sweep.take(scns[name], slice(0, n))
        ref = {dtype: sweep.make_sweep_fn("cpu", dt, settings)(
            on_cpu(head, dtype)).grf for dtype in (f64, f32)}
        gaps[name] = (grf_gap(outs[name].grf[:n], ref[f64]),
                      grf_gap(ref[f32], ref[f64]))
    phys_scn = sweep.random_scenarios(0, PHYSICAL_BATCH, f32, device)
    phys = sweep.make_sweep_fn(device, 0.0025, admm.ADMMSettings(**PHYSICAL))(
        phys_scn)
    bars = physical_bars(phys_scn, phys.grf)
    peak = roofline.device_peaks(device)
    solved = {"dense": batch, "fused": batch * chunks}
    fields = {k: roofline.summarize(roofline.cold_solve_stages(routes[k]),
                                    solved[k] / statistics.median(walls[k]),
                                    peak) for k in routes}
    dense_c, fused_c = counts["sweep_dense"], counts["sweep_fused"]
    segments = routes["dense"].segments
    checks = {
        "finite": all(bool(torch.isfinite(o.forces_all).all())
                      for o in outs.values()),
        "one_solve_a_scenario": (outs["dense"].stats["num_solves"] == batch
                                 and outs["fused"].stats["num_solves"]
                                 == batch * chunks),
        "dense_k3_k6_a_segment": (dense_c["schulz_batch"] == segments
                                  and dense_c["admm_iterations"] == segments
                                  and dense_c["kkt_schulz"] == 0),
        "fused_k1_k6_a_chunk": (fused_c["kkt_schulz"] == chunks
                                and fused_c["admm_iterations"] == chunks
                                and fused_c["schulz_batch"] == 0),
        "dense_vs_float64": f64_gate(*gaps["dense"]),
        "fused_vs_float64": f64_gate(*gaps["fused"]),
        "physical_bars": all(bars.values())}
    lines = [
        f"sweep: main.py sweep's program (make_sweep_fn, {SWEEP_DENSE}, "
        f"mpc_dt {dt}) at batch {batch}: "
        f"{rate_text(batch, walls['dense'])}; max primal / dual residual "
        f"{float(outs['dense'].stats['max_primal_res']):.4g} / "
        f"{float(outs['dense'].stats['max_dual_res']):.4g}; launches "
        f"{json.dumps(dense_c)}; on {card}",
        f"sweep: the fused cold route ({SWEEP_FUSED}) through run_chunked, "
        f"{chunks} chunks of {batch} ({batch * chunks} scenarios): "
        f"{rate_text(batch * chunks, walls['fused'])}; max primal / dual "
        f"residual {outs['fused'].stats['max_primal_res']:.4g} / "
        f"{outs['fused'].stats['max_dual_res']:.4g}; launches "
        f"{json.dumps(fused_c)}",
        f"sweep against the same solve in float64 on the CPU, first {n} "
        f"scenarios, per-scenario max |GRF error|: dense "
        f"{gap_text(*gaps['dense'])}; fused {gap_text(*gaps['fused'])}; "
        f"gate p50 and p90 <= {F64_FACTOR:g} x plain + {F64_SLACK:g} N",
        f"sweep roofline against {peak.name} (known {peak.known}) at the "
        f"median rates: dense {json.dumps(fields['dense'])}; fused "
        f"{json.dumps(fields['fused'])}",
        f"sweep physical bars (tests/test_sharding.py:59-82: seed 0, batch "
        f"{PHYSICAL_BATCH}, {PHYSICAL}, mpc_dt 0.0025) {json.dumps(bars)}",
        f"sweep checks {json.dumps(checks)} "
        f"{'PASS' if all(checks.values()) else 'FAIL'}"]
    return counts, lines, all(checks.values())


def same_bits(a, b):
    """Whether two tensors hold the same bits (NaN payloads included)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        as_int = {torch.float32: torch.int32, torch.float64: torch.int64}
        a, b = (t.contiguous().view(as_int[t.dtype]) for t in (a, b))
    return torch.equal(a, b)


def mesh_tick(carry, model, step, dt=0.002):
    """One closed-loop tick of ``carry`` with the controller step
    ``step``: sensors, the EKF, ``step``, the plant."""
    from go1_qp_mpc_controller_torch.ctrl import controller
    from go1_qp_mpc_controller_torch.envs import rollout, srb_sim

    sensors = srb_sim.read_sensors(carry.sim, model, carry.ctrl.contacts,
                                   carry.stance_forces_z, dt)
    ctrl = step(controller.sensor_update(carry.ctrl, model, sensors, dt))
    sim, fz = srb_sim.step(carry.sim, model, ctrl.joint_torques,
                           ctrl.contacts, ctrl.foot_pos_target_last_time, dt)
    return rollout.RolloutCarry(ctrl=ctrl, sim=sim, stance_forces_z=fz)


def lqr_operands(batch, h, seed, device):
    """A stable random closed-loop system in the stagewise shapes
    (tests/test_torch_mesh.py's distribution), float32 on ``device``."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    t = lambda *shape: torch.randn(shape, generator=gen, dtype=torch.float64)
    ops = {"a_d": torch.eye(13) + 0.01 * t(batch, 13, 13),
           "b_d": 0.02 * t(batch, h, 13, 12),
           "qs": 0.1 + 1.9 * torch.rand((batch, 13), generator=gen,
                                         dtype=torch.float64),
           "rbar": torch.diag_embed(0.5 + 1.5 * torch.rand(
               (batch, 12), generator=gen, dtype=torch.float64)),
           "g": t(batch, h, 12), "c_lin": t(batch, h, 13)}
    return {k: v.to(device=device, dtype=f32) for k, v in ops.items()}


def mesh_phase(seed, device, card, batch=SWEEP_BATCH):
    """The multi-device layer at world size 1 on this card
    (``parallel/mesh.py``, ``parallel/horizon.py``, the mesh form of
    ``parallel/sweep.py``), then ``rollout --trace``.

    The path, counted: ``init_distributed`` (a world-1 NCCL group), the
    mesh sweep at ``batch`` on both mpc = 1 routes (dense polished: K3,
    K6; fused cold: K1, K6), ``MESH_CTRL_TICKS`` ticks of the sharded
    controller step at ``batch``, ``lqr_solve_sharded`` at H =
    ``LQR_H`` and ``main.py rollout --trace`` (``MESH_TRACE_STEPS``
    steps, batch 1). Then, uncounted, what it is held against: the
    one-card ``make_sweep_fn`` and ``control_step_batched`` (equal bits),
    the port's ``_lqr_solve`` (``LQR_TOL`` x max |u|), and the mpc-axis
    partials summed serially (n = 2 and 5) solved on the card against the
    dense condensation's float64 solve on the CPU (``f64_gate``). Prints
    each route's rate and its roofline fields against the card's peaks;
    destroys the group. Returns (counts by path, lines, passed)."""
    import contextlib
    import io
    import statistics
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from go1_qp_mpc_controller_torch import main as port_main
    from go1_qp_mpc_controller_torch.config import presets
    from go1_qp_mpc_controller_torch.ctrl import controller
    from go1_qp_mpc_controller_torch.envs import rollout
    from go1_qp_mpc_controller_torch.models import types
    from go1_qp_mpc_controller_torch.ops import admm, stagewise
    from go1_qp_mpc_controller_torch.parallel import horizon
    from go1_qp_mpc_controller_torch.parallel import mesh as mesh_lib
    from go1_qp_mpc_controller_torch.parallel import sweep
    from go1_qp_mpc_controller_torch.utils import graphs, roofline, viz

    f32, f64 = torch.float32, torch.float64
    _, params, _ = presets.load_preset("gazebo_mpc", f32, device=device)
    dt = float(params.mpc_dt)
    routes = {"dense": admm.ADMMSettings(**SWEEP_DENSE),
              "fused": admm.ADMMSettings(**SWEEP_FUSED)}
    scn = sweep.random_scenarios(seed, batch, f32, device)
    model = types.default_robot_model(f32, device)
    ctrl_params = types.default_ctrl_params(f32, device)
    start = rollout.init_carry(model, ctrl_params, batch, dtype=f32,
                               device=device)
    gen = torch.Generator().manual_seed(seed)
    pos = start.sim.root_pos.clone()
    pos[:, 2] += (0.005 * torch.randn((batch,), generator=gen)).to(device)
    start = start._replace(sim=start.sim._replace(
        root_pos=pos, root_lin_vel=start.sim.root_lin_vel
        + (0.01 * torch.randn((batch, 3), generator=gen)).to(device)))
    ref = graphs.clone(start)
    lq = lqr_operands(batch // 4, LQR_H, seed, device)
    trace_dir = tempfile.TemporaryDirectory()
    npz = os.path.join(trace_dir.name, "rollout.npz")

    reset_counts()
    mesh_device = mesh_lib.init_distributed(device)
    try:
        mesh = mesh_lib.make_mesh(1)
        fns = {k: sweep.make_sweep_fn(mesh, dt, st)
               for k, st in routes.items()}
        outs = {k: fn(scn) for k, fn in fns.items()}
        step = mesh_lib.make_sharded_control_step(
            mesh, model, ctrl_params, 0.002, settings=routes["dense"],
            use_terrain_adapt=False)
        shard = mesh_lib.scenario_sharding(mesh, start)
        for _ in range(MESH_CTRL_TICKS):
            shard = mesh_tick(shard, model, step)
        fac = stagewise._riccati_factor(lq["a_d"], lq["b_d"], lq["qs"],
                                        lq["rbar"])
        u_mesh = horizon.lqr_solve_sharded(fac, lq["a_d"], lq["b_d"],
                                           lq["g"], lq["c_lin"],
                                           mesh.group(mesh_lib.MPC_AXIS))
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            port_main.main(["--device", str(device), "--preset",
                            "gazebo_mpc", "rollout", "--steps",
                            str(MESH_TRACE_STEPS), "--trace", npz])
        counts = read_counts()
        # the mesh sweep and the one-card sweep timed in turns
        one_fns = {k: sweep.make_sweep_fn(device, dt, st)
                   for k, st in routes.items()}
        walls = {}
        for _ in range(MESH_SPANS):
            for k in routes:
                for tag, fn in (("mesh", fns[k]), ("one", one_fns[k])):
                    walls.setdefault((tag, k), []).extend(
                        wall_spans(lambda fn=fn: fn(scn), 1))
        world, backend = dist.get_world_size(), dist.get_backend()
    finally:
        dist.destroy_process_group()

    # what the path is held against, uncounted
    one = {k: fn(scn) for k, fn in one_fns.items()}
    sweep_equal = {
        k: all(same_bits(getattr(outs[k], f), getattr(one[k], f))
               for f in ("grf", "forces_all", "primal_res", "dual_res"))
        and outs[k].stats["num_solves"] == one[k].stats["num_solves"]
        and all(same_bits(outs[k].stats[f], one[k].stats[f])
                for f in ("max_primal_res", "max_dual_res"))
        for k in routes}
    single = lambda s: controller.control_step_batched(
        s, model, ctrl_params, 0.002, settings=routes["dense"],
        use_terrain_adapt=False, compact_k=256)
    for _ in range(MESH_CTRL_TICKS):
        ref = mesh_tick(ref, model, single)
    ctrl_equal = all(same_bits(getattr(shard.ctrl, f), getattr(ref.ctrl, f))
                     for f in ("foot_forces_grf", "joint_torques",
                               "qp_warm_minv", "qp_warm_x"))
    # the carried inverses the dense cold route leaves NaN (a warm tick
    # then flags those scenarios cold again)
    nan_minv = int(torch.isnan(shard.ctrl.qp_warm_minv).flatten(1).any(1)
                   .sum())
    fac["c_lin"] = lq["c_lin"]
    f_c = torch.einsum('bhyx,bhy->bhx', fac["acl"], lq["c_lin"])
    u_seq = stagewise._lqr_solve(fac, lq["b_d"], f_c, lq["g"])
    u_par = stagewise._lqr_solve(fac, lq["b_d"], f_c, lq["g"], parallel=True)
    scale = float(u_seq.abs().max())
    lqr_err = {name: float((u_mesh - u).abs().max()) / scale
               for name, u in (("sequential", u_seq), ("parallel", u_par))}

    n = SWEEP_F64_SCENARIOS
    head = sweep.take(scn, slice(0, n))
    a_d, b_d = sweep.discretize(head, dt)
    b_list = b_d[:, None].expand(-1, 10, -1, -1)
    dense_qp = sweep.srb.condense_nilpotent_const(
        a_d, b_d, head.x0, head.x_ref, head.q_weights, head.r_weights,
        head.contacts)
    ref_grf = {dtype: sweep.make_sweep_fn("cpu", dt, routes["dense"])(
        on_cpu(head, dtype)).grf for dtype in (f64, f32)}
    partial_gaps, qp_err = {}, {}
    for members in MESH_PARTIAL_N:
        parts = [sweep._condense_mpc_partial(a_d, b_list, head, k, members)
                 for k in range(members)]
        qp = sweep._mpc_qp(sum(p[0] for p in parts),
                           sum(p[1] for p in parts), head)
        qp_err[members] = max(
            float((getattr(qp, f) - getattr(dense_qp, f)).abs().max()
                  / getattr(dense_qp, f).abs().max())
            for f in ("hessian", "gradient"))
        grf = admm.mpc_solve(qp, routes["dense"], mu=head.mu).x[:, :12]
        partial_gaps[members] = (grf_gap(grf.reshape(-1, 4, 3), ref_grf[f64]),
                                 grf_gap(ref_grf[f32], ref_grf[f64]))

    loaded = viz.load_trace(npz)
    trace_dir.cleanup()
    trace_ok = (set(loaded) == set(rollout.RolloutTrace._fields) | {"dt"}
                and loaded["root_pos"].shape == (MESH_TRACE_STEPS, 3)
                and all(np.isfinite(v).all() for v in loaded.values()
                        if v.dtype.kind == "f"))
    peak = roofline.device_peaks(device)
    fields = {
        k: roofline.summarize(roofline.cold_solve_stages(routes[k]),
                              batch / statistics.median(walls["mesh", k]),
                              peak)
        for k in routes}
    checks = {
        "world_1_nccl": world == 1 and backend == "nccl"
        and mesh.shape == {"data": 1, "mpc": 1}
        and mesh.device == mesh_device,
        "finite": all(bool(torch.isfinite(o.forces_all).all())
                      for o in outs.values()),
        "sweep_equals_one_card_bits": all(sweep_equal.values()),
        "ctrl_tick_equals_control_step_batched_bits": ctrl_equal,
        "lqr_sharded_vs_lqr_solve": max(lqr_err.values()) <= LQR_TOL,
        "mpc_partials_vs_float64": all(f64_gate(*g)
                                       for g in partial_gaps.values()),
        "rollout_trace": trace_ok,
        "k1_k3_k6_launched": all(counts[k] > 0 for k in (
            "kkt_schulz", "schulz_batch", "admm_iterations"))}
    lines = [
        f"mesh: world {world} ({backend}), mesh {json.dumps(mesh.shape)}; "
        f"the mesh sweep at batch {batch}, a call a span: dense "
        f"{rate_text(batch, walls['mesh', 'dense'])}, fused "
        f"{rate_text(batch, walls['mesh', 'fused'])}; the one-card "
        f"make_sweep_fn in turns with it: dense "
        f"{rate_text(batch, walls['one', 'dense'])}, fused "
        f"{rate_text(batch, walls['one', 'fused'])}; equal bits to it "
        f"{json.dumps(sweep_equal)}; on {card}",
        f"mesh roofline against {peak.name} (known {peak.known}): dense "
        f"{json.dumps(fields['dense'])}; fused {json.dumps(fields['fused'])}",
        f"mesh: sharded control step, {MESH_CTRL_TICKS} ticks at batch "
        f"{batch}, equal bits to control_step_batched: {ctrl_equal} "
        f"(carried inverses holding NaN: {nan_minv}); "
        f"lqr_solve_sharded (H = {LQR_H}, batch {batch // 4}) max |u - "
        f"_lqr_solve| / max |u|: {json.dumps(lqr_err)} (gate {LQR_TOL:g})",
        f"mesh: mpc partials summed serially, first {n} scenarios: max "
        f"relative H / g error against the dense condensation "
        f"{json.dumps(qp_err)}; solved GRF against float64 on the CPU "
        + "; ".join(f"n = {m}: {gap_text(*g)}"
                    for m, g in partial_gaps.items()),
        f"mesh: rollout --trace ({MESH_TRACE_STEPS} steps) "
        f"{printed.getvalue().strip()} -> keys {sorted(loaded)}; launches "
        f"{json.dumps(counts)}",
        f"mesh checks {json.dumps(checks)} "
        f"{'PASS' if all(checks.values()) else 'FAIL'}"]
    return {"mesh": counts}, lines, all(checks.values())


def stagewise_chain(scn, h, ticks):
    """bench.py:198-240's stagewise program on ``scn``: the reference held
    at its last row over ``h`` stages, a cold ``stagewise.mpc_solve``
    (``LH_COLD``), then ``ticks`` warm ticks (``LH_WARM``) with the start
    state drifting as in bench.py:503-504. Returns (cold solution, last
    warm solution or None)."""
    import torch
    from go1_qp_mpc_controller_torch.ops import admm, stagewise
    from go1_qp_mpc_controller_torch.parallel import sweep

    a_d, b_d = sweep.discretize(scn, 0.0025)
    x_ref = scn.x_ref[:, -1:].expand(-1, h, -1).contiguous()
    common = (scn.q_weights, scn.r_weights, scn.contacts)
    sol, warm = stagewise.mpc_solve(
        a_d, b_d, scn.x0, x_ref, *common, mu=scn.mu,
        settings=admm.ADMMSettings(**LH_COLD), return_warm=True)
    drift = torch.zeros_like(scn.x0)
    drift[:, 9], drift[:, 3] = 0.001, 0.0005
    x0, sol_w = scn.x0, None
    for _ in range(ticks):
        x0 = x0 + drift
        sol_w, warm = stagewise.mpc_solve_warm(
            a_d, b_d, x0, x_ref, *common, warm, mu=scn.mu,
            settings=admm.ADMMSettings(**LH_WARM))
    return sol, sol_w


def kernel_count(run):
    """(CUDA kernels launched, device-busy ms, wall ms) of ``run()`` from
    a torch.profiler trace."""
    events, wall_us = device_trace(run)
    return len(events), busy_us(events) / 1e3, wall_us / 1e3


def stagewise_batch_lines(seed, device, h, batch):
    """One horizon of the stagewise batch: the chain counted, then timed
    (cold and warm spans) replayed and eager, launches a solve from the
    profiler, and the first ``LH_F64_SCENARIOS`` scenarios' first-stage
    forces against float64 on the CPU. Returns (counts, lines, checks)."""
    import statistics

    import torch
    from go1_qp_mpc_controller_torch.ops import stagewise
    from go1_qp_mpc_controller_torch.parallel import sweep

    scn = sweep.random_scenarios(seed, batch, torch.float32, device)
    reset_counts()
    cold, warm = stagewise_chain(scn, h, LH_WARM_TICKS)
    counts = read_counts()
    times, launches = {}, {}
    for replay in (True, False):
        stagewise.REPLAY = replay
        try:
            key = "replayed" if replay else "eager"
            spans = LH_SPANS if replay else 1
            times[key] = (
                wall_spans(lambda: stagewise_chain(scn, h, 0), spans),
                wall_spans(lambda: stagewise_chain(scn, h, LH_WARM_TICKS),
                           spans))
            launches[key] = kernel_count(lambda: stagewise_chain(scn, h, 0))
        finally:
            stagewise.REPLAY = True
    n = LH_F64_SCENARIOS
    head = sweep.take(scn, slice(0, n))
    ref = {dtype: stagewise_chain(on_cpu(head, dtype), h, LH_WARM_TICKS)
           for dtype in (torch.float64, torch.float32)}
    gaps = {}
    for i, name in enumerate(("cold", "warm")):
        u0 = lambda sols: sols[i].u[:, 0]
        gaps[name] = (grf_gap(u0((cold, warm))[:n], u0(ref[torch.float64])),
                      grf_gap(u0(ref[torch.float32]),
                              u0(ref[torch.float64])))
    checks = {
        f"h{h}_finite": bool(torch.isfinite(cold.u).all()
                             and torch.isfinite(warm.u).all()),
        # K3 at n = 12 once a stage a Riccati pass: 3 segments cold, one a
        # warm tick
        f"h{h}_k3_n12_a_stage": (
            counts["schulz_batch"] == h * (3 + LH_WARM_TICKS)
            and counts["schulz_batch_routes"] == {
                "n12": h * (3 + LH_WARM_TICKS)}),
        f"h{h}_cold_vs_float64": f64_gate(*gaps["cold"]),
        f"h{h}_warm_vs_float64": f64_gate(*gaps["warm"])}
    cold_w, warm_w = times["replayed"]
    ecold_w, ewarm_w = times["eager"]
    warm_only = [w - statistics.median(cold_w) for w in warm_w]
    lines = [
        f"stagewise H = {h}, batch {batch} (bench.py:667-697 settings): cold "
        f"{rate_text(batch, cold_w)}; {LH_WARM_TICKS} warm ticks "
        f"{rate_text(batch * LH_WARM_TICKS, warm_only)} (a chain span less "
        f"the median cold span); eager: cold {batch / ecold_w[0]:.1f} "
        f"solves/s, warm "
        f"{batch * LH_WARM_TICKS / (ewarm_w[0] - ecold_w[0]):.1f} solves/s;"
        f" launches {json.dumps(counts)}",
        f"stagewise H = {h} kernels a cold solve (profiler): replayed "
        f"{launches['replayed'][0]} launches, device busy "
        f"{launches['replayed'][1]:.3f} ms of "
        f"{launches['replayed'][2]:.3f} ms; eager "
        f"{launches['eager'][0]} launches, device busy "
        f"{launches['eager'][1]:.3f} ms of {launches['eager'][2]:.3f} ms",
        f"stagewise H = {h} first-stage forces against float64 on the CPU, "
        f"first {n} scenarios: cold {gap_text(*gaps['cold'])}; after "
        f"{LH_WARM_TICKS} warm ticks {gap_text(*gaps['warm'])}"]
    return counts, lines, checks


def stagewise_protocol(device, card):
    """tests/test_stagewise.py:203-270 on the card: one robot at H = 40,
    standing then walking at 0.3 m/s from tick ``LH_WALK_AT``, plant
    ground truth in place of the EKF; each tick the production program
    (``control_step(horizon=40)``: warm carry, routed) and a cold solve
    every tick from the same state, the plant stepped with the
    production torques. The launch counts are the production ticks' alone
    (set to 0 before each and read after it, the comparator left out).
    Returns (counts, lines, checks)."""
    import numpy as np
    import torch
    from go1_qp_mpc_controller_torch.ctrl import controller
    from go1_qp_mpc_controller_torch.envs import rollout, srb_sim
    from go1_qp_mpc_controller_torch.models import types
    from go1_qp_mpc_controller_torch.ops import admm

    f32, h, dt = torch.float32, 40, 0.002
    model = types.default_robot_model(f32, device)
    params = types.default_ctrl_params(f32, device)
    carry = rollout.init_carry(model, params, 1, dtype=f32, device=device,
                               horizon=h)
    kw = dict(settings=admm.ADMMSettings(**LH_COLD),
              warm_settings=admm.ADMMSettings(**LH_WARM),
              use_terrain_adapt=False, horizon=h)
    walk = _walk_command(LH_WALK_AT, 0.3)
    sim, fz, ctrl = carry.sim, carry.stance_forces_z, carry.ctrl
    stats, diffs, walls, counts = {}, [], [], {}
    for tick in range(LH_ROLLOUT_TICKS):
        ctrl = walk(tick)(tick, ctrl)
        sensors = srb_sim.read_sensors(sim, model, ctrl.contacts, fz, dt)
        ctrl = controller.sensor_update(ctrl, model, sensors, dt,
                                        estimate=False)
        ctrl = ctrl._replace(root_pos=sim.root_pos,
                             root_lin_vel=sim.root_lin_vel)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        warm = controller.control_step(ctrl, model, params, dt, stats=stats,
                                       **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        add_counts(counts, read_counts())
        cold = controller.control_step(ctrl, model, params, dt,
                                       warm_mode="cold", **kw)
        sim, fz = srb_sim.step(sim, model, warm.joint_torques, warm.contacts,
                               warm.foot_pos_target_last_time, dt)
        diffs.append((warm.foot_forces_grf
                      - cold.foot_forces_grf).abs().amax())
        ctrl = warm
    diffs = torch.stack(diffs).cpu().double().numpy()
    z = float(sim.root_pos[0, 2])
    tilt = float(ctrl.root_euler.abs().max())
    vx = float(sim.root_lin_vel[0, 0])
    p50, p95 = float(np.median(diffs)), float(np.percentile(diffs, 95))
    checks = {"protocol_finite": bool(np.isfinite(diffs).all()),
              "protocol_p50<3": p50 < 3.0, "protocol_p95<20": p95 < 20.0,
              "protocol_max<40": float(diffs.max()) < 40.0,
              "protocol_height": 0.25 < z < 0.35,
              "protocol_tilt<0.3": tilt < 0.3, "protocol_vx>0.1": vx > 0.1,
              "protocol_k3_n12": counts["schulz_batch_routes"] == {
                  "n12": counts["schulz_batch"]}}
    lines = [
        f"stagewise closed loop (tests/test_stagewise.py:203-270 on the "
        f"card, float32): {LH_ROLLOUT_TICKS} ticks at H = {h}, routes "
        f"{json.dumps(stats)}; production tick wall time p50 "
        f"{_pct(walls, 50):.3f} ms, p99 {_pct(walls, 99):.3f} ms "
        f"(synchronized, the cold comparator not timed) on {card}; warm-vs-"
        f"cold GRF p50 {p50:.4f} / p95 {p95:.4f} / max {diffs.max():.4f} N "
        f"(bars 3 / 20 / 40); final z {z:.4f} m, max |euler| {tilt:.4f} "
        f"rad, vx {vx:.4f} m/s; launches of the production ticks "
        f"{json.dumps(counts)}"]
    return counts, lines, checks


def rollout_horizon_lines(device, card):
    """``rollout(horizon=40)`` through the entry point, ``main.py rollout
    --horizon 40``'s settings, the EKF on: one robot standing then
    trotting, a synchronized one-tick call a tick; then
    ``LH_PROFILE_TICKS`` more under the profiler. Returns (counts, lines,
    checks)."""
    import torch
    from go1_qp_mpc_controller_torch.envs import rollout
    from go1_qp_mpc_controller_torch.models import types
    from go1_qp_mpc_controller_torch.ops import admm

    f32, h = torch.float32, 40
    model = types.default_robot_model(f32, device)
    params = types.default_ctrl_params(f32, device)
    carry = rollout.init_carry(model, params, 1, dtype=f32, device=device,
                               horizon=h)
    kw = dict(settings=admm.ADMMSettings(**LH_COLD),
              warm_settings=admm.ADMMSettings(**LH_WARM), horizon=h)
    walk = _walk_command(LH_WALK_AT, 0.3)
    stats = {}
    reset_counts()
    carry, tr, walls = _robot_ticks(carry, model, params, LH_ENTRY_TICKS,
                                    walk, stats=stats, **kw)
    counts = read_counts()
    profile = profile_lines(lambda: _robot_ticks(
        carry, model, params, LH_PROFILE_TICKS,
        lambda t: walk(LH_ENTRY_TICKS + t), **kw), LH_PROFILE_TICKS,
        _pct(walls, 50))
    z = tr.root_pos[:, 0, 2]
    checks = {"entry_finite": bool(torch.isfinite(tr.foot_forces_grf).all()),
              "entry_height": bool(((z > 0.25) & (z < 0.35)).all())}
    lines = [
        f"rollout(horizon={h}) entry point, EKF on, {LH_ENTRY_TICKS} ticks "
        f"(trot 0.3 m/s from tick {LH_WALK_AT}), routes {json.dumps(stats)}:"
        f" tick wall time p50 {_pct(walls, 50):.3f} ms, p99 "
        f"{_pct(walls, 99):.3f} ms (synchronized each tick) on {card}; "
        f"launches {json.dumps(counts)}"]
    lines += [f"rollout(horizon={h}) {line}" for line in profile]
    return counts, lines, checks


def receding_lines(device):
    """``RECEDING_TICKS`` ticks of ``control_step(receding_horizon=True)``
    from tests/test_srb_condensation.py:280-302's walking diagonal stance
    (the default polished settings: K3, K6), the same ticks in float64 on
    the CPU. Returns (counts, lines, checks)."""
    import torch
    from go1_qp_mpc_controller_torch.ctrl import controller
    from go1_qp_mpc_controller_torch.models import types

    def ticks(dtype, dev, count):
        model = types.default_robot_model(dtype, dev)
        params = types.default_ctrl_params(dtype, dev)
        s = types.init_ctrl_state(model, 1, dtype, dev)
        s = s._replace(
            movement_mode=torch.ones_like(s.movement_mode),
            root_lin_vel_d=torch.tensor([[0.4, 0.0, 0.0]], dtype=dtype,
                                        device=dev),
            contacts=torch.tensor([[True, False, False, True]], device=dev))
        grfs = []
        if count:
            reset_counts()
        for _ in range(RECEDING_TICKS):
            s = controller.control_step(s, model, params, 0.002,
                                        receding_horizon=True)
            grfs.append(s.foot_forces_grf)
        return torch.cat(grfs), (read_counts() if count else None)

    got, counts = ticks(torch.float32, device, True)
    want, _ = ticks(torch.float64, torch.device("cpu"), False)
    gap = grf_gap(got, want)
    grf = got.cpu().double()
    segments = 4                 # ADMMSettings(): 4 segments, polished
    checks = {"receding_finite": bool(torch.isfinite(grf).all()),
              "receding_stance_fz>10": bool((grf[:, [0, 3], 2] > 10).all()),
              "receding_swing<1e-3": float(grf[:, 1:3].abs().max()) < 1e-3,
              "receding_vs_float64<0.05": gap["max"] < 0.05,
              "receding_k3_k6_a_segment": (
                  counts["schulz_batch"] == segments * RECEDING_TICKS
                  and counts["admm_iterations"] == segments * RECEDING_TICKS)}
    lines = [
        f"receding horizon: {RECEDING_TICKS} ticks of control_step("
        f"receding_horizon=True), batch 1: stance fz "
        f"{grf[-1, [0, 3], 2].tolist()} N, max swing |f| "
        f"{float(grf[:, 1:3].abs().max()):.3e} N, GRFs against float64 on "
        f"the CPU max {gap['max']:.4e} N (gate 0.05); launches "
        f"{json.dumps(counts)}"]
    return counts, lines, checks


def long_horizon_phase(seed, device, card, batch=LH_BATCH):
    """The long-horizon paths: the stagewise batch at each of
    ``LH_HORIZONS`` (``stagewise_batch_lines``), JAX's closed-loop
    protocol (``stagewise_protocol``), the ``rollout(horizon=40)`` entry
    point (``rollout_horizon_lines``) and the receding-horizon variant
    (``receding_lines``), each with the launch counters set to 0 just
    before it and read just after (the protocol's around each production
    tick). Returns (counts by path, lines, passed)."""
    counts, lines, checks = {}, [], {}
    for h in LH_HORIZONS:
        c, l, k = stagewise_batch_lines(seed, device, h, batch)
        counts[f"stagewise_h{h}"] = c
        lines += l
        checks.update(k)
    for name, part in (("protocol_h40", stagewise_protocol),
                       ("rollout_h40", rollout_horizon_lines)):
        c, l, k = part(device, card)
        counts[name] = c
        lines += l
        checks.update(k)
    c, l, k = receding_lines(device)
    counts["receding"] = c
    lines += l
    checks.update(k)
    lines.append(f"long horizon checks {json.dumps(checks)} "
                 f"{'PASS' if all(checks.values()) else 'FAIL'}")
    return counts, lines, all(checks.values())


def spread_spd(batch, n, seed):
    """Seeded random SPD matrices with diagonals spread over e^-4..e^4, so
    the Jacobi balance does real work (tests/test_pallas_admm.py:198-204),
    made with numpy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(batch, n, n)).astype(np.float32)
    spd = a @ np.swapaxes(a, -1, -2) / n + 0.2 * np.eye(n, dtype=np.float32)
    d = np.exp(rng.uniform(-2, 2, size=(batch, n))).astype(np.float32)
    return spd * d[:, :, None] * d[:, None, :]


def k4_check(m, coeffs, tol, res_tol):
    """K4 against its plain version on the (B, 28, 28) matrices ``m``: per
    matrix within ``tol`` x max|plain| of the plain version and within
    ``tol`` x max|X| of the same schedule in float64, and max|S X - I| <
    ``res_tol``. Returns (readings, passed)."""
    import torch
    from go1_qp_mpc_controller_torch.ops import schulz_lanes

    got = schulz_lanes.schulz_inverse_lanes(m, coeffs)
    want = schulz_lanes.schulz_inverse_lanes_plain(m, coeffs)
    ref = schulz_lanes.schulz_inverse_lanes_plain(m.double(), coeffs)
    torch.cuda.synchronize()
    eye = torch.eye(m.shape[-1], dtype=torch.float64, device=m.device)
    resid = lambda x: (m.double() @ x.double() - eye).abs()
    per_matrix = lambda x, r: float(((x.double() - r).abs().amax((1, 2))
                                     / r.abs().amax((1, 2))).max())
    s = torch.rsqrt(torch.diagonal(m.double(), dim1=-2, dim2=-1))
    cond = torch.linalg.cond(m.double() * s[:, :, None] * s[:, None, :])
    r = dict(err=float((got - want).abs().max()),
             rel_plain=per_matrix(got, want.double()),
             rel_f64=per_matrix(got, ref), plain_rel_f64=per_matrix(want, ref),
             res=float(resid(got).max()), res_plain=float(resid(want).max()),
             res_f64=float(resid(ref).max()),
             res_inf=float(resid(got).sum(-1).amax()),
             cond_median=float(cond.median()), cond_max=float(cond.max()))
    passed = (bool(torch.isfinite(got).all()) and r["rel_plain"] <= tol
              and r["rel_f64"] <= tol and r["res"] < res_tol)
    return r, passed


def k4_line(name, r, tol, res_tol):
    return (f"K4 {name}: max_abs_err {r['err']:.3e}, worst per-matrix error "
            f"{r['rel_plain']:.3e} x max|plain|, against the float64 schedule "
            f"{r['rel_f64']:.3e} x max|X| (plain {r['plain_rel_f64']:.3e}; "
            f"tolerance {tol:g} on both); max|S X - I| {r['res']:.3e} (plain "
            f"{r['res_plain']:.3e}, float64 schedule {r['res_f64']:.3e}; "
            f"tolerance {res_tol:g}), ||S X - I||_inf {r['res_inf']:.3e}; "
            f"balanced condition number median {r['cond_median']:.3e}, max "
            f"{r['cond_max']:.3e}")


def k4_phase(batch, gen, seed, device, reps):
    """K4 against its plain version at ``batch`` and at its first
    ``K4_BATCHES`` matrices on two input sets: the innovation matrices
    S = C P-bar C' + R of the K2 phase's EKF input distribution, and
    spread-diagonal random SPD matrices. Gates per
    matrix (``k4_check``): on the spread set the tolerances of
    tests/test_pallas_admm.py:217-219 (5e-4 x max|plain|, max|S X - I| <
    1e-3); on the innovation set ``K4_S_TOL`` and ``K4_S_RES_TOL``. Returns
    (record, lines, passed)."""
    import torch
    from go1_qp_mpc_controller_torch.models import types
    from go1_qp_mpc_controller_torch.ops import admm, ekf, schulz_lanes
    from go1_qp_mpc_controller_torch.runtime import estimator

    # the innovation matrices the estimator's frame hands K4
    predict = estimator.make_estimator_predict(
        types.default_robot_model(torch.float32, device))
    pred = predict(*random_ekf_inputs(batch, gen, device)[:10])
    sets = {
        "innovation": (pred.s_mat.contiguous(), K4_S_TOL, K4_S_RES_TOL),
        "spread_spd": (torch.tensor(spread_spd(batch, 28, seed),
                                    device=device), 5e-4, 1e-3)}
    coeffs = admm._scaled_schulz_coeffs(ekf.SINV_L0)
    # 2 products of 2 n^3 a step after the folded first one; the matrix
    # read and the inverse written once
    n = 28
    lines, records = [], {}
    for name, (m_full, tol, res_tol) in sets.items():
        for b in (batch,) + K4_BATCHES:
            m = m_full[:b]
            r, passed = k4_check(m, coeffs, tol, res_tol)
            t = cuda_times({
                "kernel": lambda: schulz_lanes.schulz_inverse_lanes(m,
                                                                    coeffs),
                "plain": lambda: schulz_lanes.schulz_inverse_lanes_plain(
                    m, coeffs),
                "library": lambda: torch.linalg.inv(m)}, reps)
            bound_ms, bound_by = bound(
                b * 2 * (len(coeffs) - 1) * 2.0 * n ** 3, 2 * b * n * n * F32)
            lines.append(
                f"{k4_line(name, r, tol, res_tol)}; batch {b}, n {n}, "
                f"{len(coeffs)} steps (the first folded); kernel_ms "
                f"{t['kernel']:.4f}, plain_ms {t['plain']:.4f}, bound_ms "
                f"{bound_ms:.4f} ({bound_by}), library_ms "
                f"{t['library']:.4f} (torch.linalg.inv of the same "
                f"matrices) {'PASS' if passed else 'FAIL'}")
            records[name, b] = dict(err=r["err"], kernel_ms=t["kernel"],
                                    plain_ms=t["plain"],
                                    library_ms=t["library"],
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    passed=passed)
    main = records["innovation", batch]
    record = {
        "name": "schulz_lanes", "route": "cuda",
        "source": "go1_qp_mpc_controller_torch/csrc/schulz_lanes.cu",
        "replaces": "go1_qp_mpc_controller_tpu/ops/pallas_admm.py:603",
        "max_abs_err": max(r["err"] for r in records.values()),
        "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"]}
    return record, lines, all(r["passed"] for r in records.values())


def k4_live_line(s_mat):
    """K4 against its plain version at the shape a runtime gives it: a live
    filter's (1, 28, 28) innovation matrix ``s_mat``, with the innovation
    set's tolerances. Returns (line, passed)."""
    from go1_qp_mpc_controller_torch.ops import admm, ekf

    r, passed = k4_check(s_mat.clone(), admm._scaled_schulz_coeffs(
        ekf.SINV_L0), K4_S_TOL, K4_S_RES_TOL)
    return (f"{k4_line('live frame (1, 28, 28)', r, K4_S_TOL, K4_S_RES_TOL)} "
            f"{'PASS' if passed else 'FAIL'}"), passed


def k4_live_check(est, bridge):
    """:func:`k4_live_line` on the estimator thread's live filter: its
    last estimate and the feed's last frame, through the estimator's
    predict half (run eagerly: it launches no counted kernel)."""
    import numpy as np

    _, s = bridge.read_sensors()
    x, p, _ = est.snapshot()
    frame = est._frame(np.concatenate([
        s["quat"], s["acc"], s["gyro"], s["joint_pos"], s["joint_vel"],
        s["foot_force"]]), est.period)
    return k4_live_line(est.predict(
        x, p, *est._split(frame), est._mode(est.movement_mode),
        est.period).s_mat)


def k5_phase(device, reps):
    """K5 through its own entry, ``schulz_balanced.schulz_balanced``, at
    n = 120 on the cases of tests/test_pallas_admm.py:126-156 (cold 20
    steps, warm accept with 4 steps, warm reject with 20, on the balanced
    a a' / n + 3 I), the empty schedule from the accepted start, and cold
    20 steps on three more seeded random balanced SPD matrices. K5 has no
    path in the JAX package (only its tests call it), so the launches of
    these entry calls are its path, "k5_entry" (the launch counters are
    zeroed before them and read after; the plain versions and the timing
    launches come after the read). Gates: within 5e-6 of the float32 plain
    version (the JAX test's tolerance), max|M_b X - I| < 1e-5 on the cold
    case, and within ``K5_EMU_TOL`` of the plain version with the kernel's
    3xTF32 middle products. Returns (counts, record, lines, passed)."""
    import numpy as np
    import torch
    from go1_qp_mpc_controller_torch.ops import kkt_schulz, schulz_balanced

    n = 120

    def balanced(seed):
        a = np.random.default_rng(seed).normal(size=(n, n))
        m = a @ a.T / n + 3.0 * np.eye(n)
        s = 1.0 / np.sqrt(np.diag(m))
        return torch.tensor(m * s[:, None] * s[None, :], dtype=torch.float32,
                            device=device)

    mb = balanced(0)
    reset_counts()
    cold = schulz_balanced.schulz_balanced(mb, 20)
    x0 = (cold * (1.0 + 1e-3)).contiguous()
    garbage = torch.full((n, n), 5.0, device=device)
    cases = {"cold 20 steps": (mb, 20, None),
             "warm accept 4 steps": (mb, 4, x0),
             "warm reject 20 steps": (mb, 20, garbage),
             "warm accept 0 steps": (mb, 0, x0)}
    cases.update({f"cold 20 steps, seed {s}": (balanced(s), 20, None)
                  for s in (1, 2, 3)})
    got = {"cold 20 steps": cold}
    got.update({name: schulz_balanced.schulz_balanced(m, it, x)
                for name, (m, it, x) in cases.items()
                if name != "cold 20 steps"})
    counts = read_counts()

    eye = torch.eye(n, device=device)
    lines, errs, passed = [], {}, counts["schulz_balanced"] == len(cases)
    for name, (m, it, x) in cases.items():
        want = schulz_balanced.schulz_balanced_plain(m, it, x)
        emu = schulz_balanced.schulz_balanced_plain(
            m, it, x, middle_matmul=kkt_schulz.matmul_3xtf32)
        torch.cuda.synchronize()
        err = float((got[name] - want).abs().max())
        err_e = float((got[name] - emu).abs().max())
        ok = (bool(torch.isfinite(got[name]).all()) and err <= 5e-6
              and err_e <= K5_EMU_TOL)
        line = (f"K5 {name}: max_abs_err {err:.3e} (tolerance 5e-6), "
                f"against the 3xTF32 emulation {err_e:.3e} (tolerance "
                f"{K5_EMU_TOL:g})")
        if name == "cold 20 steps":
            resid = float((m @ got[name] - eye).abs().max())
            ok &= resid < 1e-5
            line += f", max|M_b X - I| {resid:.3e} (tolerance 1e-5)"
        lines.append(f"{line} {'PASS' if ok else 'FAIL'}")
        errs[name] = err
        passed &= ok
    t = cuda_times({
        "kernel": lambda: schulz_balanced.schulz_balanced(mb, 20),
        "plain": lambda: schulz_balanced.schulz_balanced_plain(mb, 20),
        "library": lambda: torch.linalg.inv(mb)}, reps)
    # cold 20 steps: 38 products of 2 n^3 (the first step folded), 36 of
    # them 3xTF32; M_b read and X written once. One matrix: the chain of
    # 38 dependent products and the cluster's exchanges, not this bound,
    # set its time
    flop = 2.0 * n ** 3
    tc = schulz_tf32_products(1, (1.0,) * 20, 2)
    bound_ms, bound_by = bound((38 - tc) * flop, 2 * n * n * F32, tc * flop)
    bound_fp32_ms, _ = bound(38 * flop, 2 * n * n * F32)
    lines.append(
        f"K5 timing (cold 20 steps, one matrix on one cluster of 8 blocks, "
        f"latency bound): kernel_ms {t['kernel']:.4f}, plain_ms "
        f"{t['plain']:.4f}, bound_ms {bound_ms:.6f} ({bound_by}; FP32-only "
        f"bound {bound_fp32_ms:.6f}), library_ms {t['library']:.4f} "
        f"(torch.linalg.inv of M_b; medians of {SPANS} interleaved spans of "
        f"{reps}); entry launches {counts['schulz_balanced']} for "
        f"{len(cases)} calls {'PASS' if passed else 'FAIL'}")
    record = {
        "name": "schulz_balanced", "route": "cuda",
        "source": "go1_qp_mpc_controller_torch/csrc/schulz_balanced.cu",
        "replaces": "go1_qp_mpc_controller_tpu/ops/pallas_admm.py:694",
        "max_abs_err": max(errs.values()), "ms": t["kernel"],
        "plain_ms": t["plain"], "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": t["library"], "bound_fp32_ms": bound_fp32_ms}
    return counts, record, lines, passed


# the runtime path: main.py loop's dual-cadence loop against the simulated
# feed with the estimator thread and a scripted joystick session, per preset
# {preset: time scale}: wall period = sim period / time scale. Each is the
# largest scale of scripts/runtime_ladder.py --scales 1,0.5,0.25,0.1,0.05
# at which the preset, its GRF solve replayed from graphs, passed every
# gate in every run on an H100 with grf_ms p99 under half the wall period
# in all runs but one. hardware_qp 0.05: at 0.1 its p99 went over 10 ms in
# four of ten ladders (the replayed balance QP is device-bound, ~7 ms for
# the 4 x 50 iterations of its plain ADMM loop); at 0.05 it went over its
# 20 ms once, 21.528 ms in a run of this script on a slow host (every loop
# stalled ~20 ms). gazebo_mpc 0.05: at 0.1 it stayed under its 10 ms in
# eight of nine ladders, but went over in two runs of this script (p99
# 10.996 and 14.756 ms) and in two of eight runs of
# scripts/runtime_tail_probe.py, sporadic tails that neither the garbage
# collector's pauses, the heap's size nor a profiler session explain. The
# fast loop's, the estimator's and the feeder's host work under one GIL
# hold both below scale 1
RUNTIME = {"hardware_qp": 0.05, "gazebo_mpc": 0.05}
# the session's length in fast ticks at any scale (~75 GRF solves before
# the LB exit at three quarters; the gates ask for more than 50). The
# simulated feed holds an all-stance plant (feet pinned, runtime/feeder.py,
# as the JAX package's): a walk of ~75-100 ticks in it diverges, on the
# eager loop too, so the session keeps its quarter of walking short
RUNTIME_TICKS = 100
# the GRF loop keeps up: at most this share of its ticks overran
GRF_OVERRUN_SHARE = 0.1
RUNTIME_DT = 0.002            # the fast and GRF loops' sim period
# the joystick session of main.py --joy-demo (stand -> walk -> stand -> LB
# exit), as fractions of the fast ticks the run can hold: A + stick
# forward, A again, LB
JOY_EVENTS = (0.25, 0.5, 0.75)
TAU_CEILING = 35.55           # the bridge's largest joint-class ceiling


def runtime_phase(preset, device, card, time_scale=None, duration=None):
    """``ControlLoop.run_dual`` on ``preset`` against a ``SimFeeder`` on
    the card, with the estimator thread (``estimate_in_feed``) and a
    scripted joystick session, at ``time_scale`` (default
    ``RUNTIME[preset]``) for at most ``duration`` wall seconds (default:
    ``RUNTIME_TICKS`` fast periods).
    The launch counters are zeroed after the warm-up (which makes every
    first launch and the estimator's first frame) and read after the loop.
    Gates: the JAX tests' invariants (tests/test_joystick_loop.py,
    test_dual_loop.py, test_estimator_cadence.py), the GRF loop keeping up
    (``GRF_OVERRUN_SHARE``), and K4 against its plain version on the live
    filter's innovation matrix (``k4_live_check``, after the counts were
    read). Returns (counts, lines, passed)."""
    import numpy as np
    import torch
    from go1_qp_mpc_controller_torch.config import presets
    from go1_qp_mpc_controller_torch.models import types
    from go1_qp_mpc_controller_torch.runtime import feeder as feeder_lib
    from go1_qp_mpc_controller_torch.runtime import joystick
    from go1_qp_mpc_controller_torch.runtime import loop as loop_lib

    model, params, static = presets.load_preset(preset, torch.float32,
                                                device=device)
    time_scale = time_scale or RUNTIME[preset]
    duration = duration or RUNTIME_TICKS * RUNTIME_DT / time_scale
    ticks = int(duration * time_scale / RUNTIME_DT)

    def sample(velx=0.0, a=False, lb=False):
        ax = np.zeros(8, np.float32)
        ax[4] = velx
        bt = np.zeros(5, np.int32)
        bt[0], bt[4] = int(a), int(lb)
        return ax, bt

    walk, stand, leave = (int(f * ticks) for f in JOY_EVENTS)
    source = joystick.ScriptedJoySource([
        (walk,) + sample(velx=0.3, a=True), (stand,) + sample(a=True),
        (leave,) + sample(lb=True)])
    cl = loop_lib.ControlLoop(
        model, params, static, types.init_ctrl_state(model, 1, device=device),
        main_period_s=RUNTIME_DT, grf_period_s=RUNTIME_DT,
        power_level=static.power_level, time_scale=time_scale,
        command_source=source, estimate_in_feed=True, sensor_period_s=0.001)
    feeder = feeder_lib.SimFeeder(cl.bridge, model, params, height=0.3,
                                  period_s=0.001, time_scale=time_scale,
                                  device=device)
    try:
        cl.state = feeder.initial_ctrl_state()
        cl.warmup(dual=True)
        reset_counts()
        host0 = host_sample()
        with GcPauses() as pauses:
            feeder.start(duration_s=duration + 30.0)
            t0 = time.perf_counter()
            n = cl.run_dual(duration_s=duration)
            wall = time.perf_counter() - t0
            feeder.stop()
        host1 = host_sample()
        counts = read_counts()
        replayed = replayed_counts()
        if feeder.error is not None:
            raise RuntimeError("the sensor feed failed") from feeder.error
        # after the path's counts were read: K4 on the live filter
        live_line, live_ok = k4_live_check(cl.est_thread, cl.bridge)
        root = feeder.sim_root_pos
        est_root = cl.state.root_pos[0].cpu().double().numpy()
        _, cmd = cl.bridge.read_command()
    finally:
        feeder.stop()
        cl.close()
    est = cl.est_thread
    modes = [r["value"] for r in cl.metrics.records("movement_mode")]
    tau = float(np.abs(cmd["tau"]).max())
    ceiling = (static.power_level / 10.0 if static.environment == "hardware"
               else 1.0) * TAU_CEILING
    summ = lambda name: cl.metrics.summary(name)
    pct = lambda name: ("p50 {p50:.3f} ms, p99 {p99:.3f} ms".format(
        **summ(name)) if summ(name) else "none")
    overruns = {k: summ(k).get("max") for k in ("overruns", "grf_overruns")}
    grf_overruns = overruns["grf_overruns"]
    walked = 1.0 in modes
    checks = {
        "k4_launches==estimator_frames": counts["schulz_lanes"] == est.frames,
        "estimator_frames>=0.5*fast_ticks": est.frames >= 0.5 * cl.fast_ticks,
        "plant_z_within_0.06": bool(abs(root[2] - 0.3) < 0.06),
        "est_root_within_0.05": bool(np.linalg.norm(est_root - root) < 0.05),
        "finite": bool(np.isfinite(cmd["tau"]).all()
                       and np.isfinite(root).all()),
        "tau_in_(0.5,ceiling]": 0.5 < tau <= ceiling + 1e-9,
        "grf_ticks>50": cl.grf_ticks > 50,
        f"grf_overruns<={GRF_OVERRUN_SHARE}*grf_ticks":
            grf_overruns is not None
            and grf_overruns <= GRF_OVERRUN_SHARE * cl.grf_ticks,
        "k4_live_frame": live_ok,
        "walked": walked,
        "stood_after_walking": walked and 0.0 in modes[modes.index(1.0):],
        "lb_exit_ended_the_loop": wall < duration,
        "no_k2": counts["observe_ekf"] == 0,
        # no counted kernel of the running loops ran outside a replay
        "every_launch_replayed": counts == replayed}
    lines = [
        f"runtime {preset}: ControlLoop.run_dual + SimFeeder + estimator "
        f"thread + joystick session (walk at fast tick {walk}, stand at "
        f"{stand}, LB at {leave} of ~{ticks}) at time_scale "
        f"{time_scale} on {card}: {wall:.3f} s wall, {n} "
        f"iterations, fast ticks {cl.fast_ticks}, GRF ticks {cl.grf_ticks}, "
        f"estimator frames {est.frames}, feeder ticks {feeder.ticks}; "
        f"cycle_ms {pct('cycle_ms')}; grf_ms {pct('grf_ms')}; estimator "
        f"frame {pct('est_frame_ms')}; overruns {json.dumps(overruns)}",
        f"runtime {preset}: plant root {np.round(root, 4).tolist()}, "
        f"estimated root {np.round(est_root, 4).tolist()}, final max|tau| "
        f"{tau:.3f} (ceiling {ceiling:.3f}); launches {json.dumps(counts)}",
        f"runtime {preset}: {live_line}",
        f"runtime {preset} {host_text(host0, host1)}; {pauses.text()}",
        f"runtime {preset} checks {json.dumps(checks)} "
        f"{'PASS' if all(checks.values()) else 'FAIL'}"]
    return counts, lines, all(checks.values())


# The RL stack (main.py rl's defaults: RL_TICKS ticks at RL_DT, the
# A-button press to the walk policy at RL_SWITCH, vx RL_VX), at batch
# RL_BATCH and 1, each scenario's start velocity moved by a seeded draw
RL_BATCH = 4096
RL_TICKS = 800
RL_SWITCH = 400
RL_DT = 0.004
RL_VX = 0.3
RL_SPANS = 5
RL_DV = 0.02                  # m/s, the start velocities' spread
# the card's first scenarios held against the same actor in float64 on
# the CPU over the servo phase and the first walk ticks: within
# RL_F64_FACTOR x the CPU float32 run's distance + RL_F64_FLOOR (on the
# CPU, float32 sits 3.2e-4 / 8.1e-5 / 6.7e-7 from float64 on obs /
# target_q / root_pos over these ticks; summation order moves the card's
# float32 by as much again)
RL_F64_SCENARIOS = 4
RL_F64_WALK_TICKS = 20
RL_F64_FACTOR = 4.0
RL_F64_FLOOR = 1e-5
RL_PROFILE_TICKS = (20, 80)
# the RL host loop (main.py rl-loop) on rl_gazebo (4 ms actions, 2 ms
# feed): RL_LOOP_SECONDS of wall time a scale, the press at half time;
# at the JAX test's scale 0.5 it must keep up (tests/test_rl_loop.py)
RL_LOOP_SCALES = (0.5, 1.0)
RL_LOOP_SECONDS = 4.0
RL_LOOP_OVERRUN_SHARE = 0.2
# replay: a one-robot gazebo_mpc trot recorded from rollout and replayed;
# each tick replays the same operations on the same inputs, so the
# replayed torques and GRFs are the recorded ones to REPLAY_TOL (N, N m)
REPLAY_TICKS = 400
REPLAY_WALK_AT = 100
REPLAY_VX = 0.3
REPLAY_TOL = 1e-3
# the joint-signal replay at tests/test_replay_checkpoint.py's length:
# past ~200 ticks the plant, its stance feet pinned, stops following the
# sine (both packages: correlation 0.75 at 200 ticks, -0.04 at 400)
SIGNAL_TICKS = 120
# robustness and terrain, at tests/test_robustness.py's and
# tests/test_terrain_turning.py's lengths, batch 1, float32
SPIKE_SETTLE_TICKS = 100
SPIKE_RESUME_TICKS = 400
TERRAIN_TICKS = 1200
POISON_BATCH = 4096
POISONED = 1234


def rl_carry(model, batch, dv):
    """``rollout.init_rl_carry`` with the start velocities moved by
    ``dv`` (batch, 3)."""
    from go1_qp_mpc_controller_torch.envs import rollout

    carry = rollout.init_rl_carry(model, batch, dtype=model.mass.dtype,
                                  device=model.mass.device)
    return carry._replace(sim=carry.sim._replace(
        root_lin_vel=carry.sim.root_lin_vel + dv.to(carry.sim.root_pos)))


def rl_run(carry, model, actor, ticks, on_command=None):
    """``rollout.rl_rollout`` with main.py rl's commands; ``on_command``
    is called on the host at each tick's command."""
    from go1_qp_mpc_controller_torch.envs import rollout

    def command(i):
        if on_command is not None:
            on_command(i)
        return [RL_VX, 0.0, 0.0] if i >= RL_SWITCH else [0.0] * 3

    return rollout.rl_rollout(carry, model, actor, ticks, RL_DT,
                              command_fn=command,
                              toggle_fn=lambda i: i == RL_SWITCH)


def rl_criteria(tr):
    """tests/test_rl.py's criteria on every scenario of the trace."""
    import torch
    from go1_qp_mpc_controller_torch.ctrl import rl

    row = lambda v: torch.tensor(v, dtype=tr.kp.dtype, device=tr.kp.device)
    q = tr.target_q
    return {
        "finite": bool(torch.isfinite(tr.obs).all()
                       and torch.isfinite(q).all()),
        "obs_clipped": float(tr.obs[..., :36].abs().max()) <= rl.CLIP_OBS,
        "targets_in_pose_clip": bool(
            (q >= row(rl.CLIP_POSE_LOWER) - 1e-5).all()
            and (q <= row(rl.CLIP_POSE_UPPER) + 1e-5).all()),
        "servo_gains_before_press": bool(
            (tr.kp[RL_SWITCH - 1] == row(rl.SERVO_P_GAINS)).all()),
        "walk_gains_at_end": bool((tr.kp[-1] == row(rl.WALK_P_GAINS)).all()),
        "mode_switched": bool((tr.movement_mode[RL_SWITCH - 1] == 0).all()
                              and (tr.movement_mode[-1] == 1).all()),
        "root_z>0.1": bool((tr.root_pos[-1, :, 2] > 0.1).all())}


def rl_phase(seed, device, card):
    """``rollout.rl_rollout`` (main.py rl) at full actor width with random
    weights from a seeded ``torch.Generator``: ``RL_BATCH`` scenarios (one
    run gated, then ``RL_SPANS`` timed spans) and one robot (tick wall
    times, each tick synchronized; launches and device-busy share a tick
    from two profiled runs). Gates: tests/test_rl.py's criteria on every
    scenario, no counted kernel launched, and the first
    ``RL_F64_SCENARIOS`` held against the same actor in float64 on the CPU
    over the servo phase and ``RL_F64_WALK_TICKS`` walk ticks. Returns
    (counts by path, lines, passed)."""
    import copy
    import statistics
    import torch
    from go1_qp_mpc_controller_torch.models import policy, types

    f32, f64 = torch.float32, torch.float64
    model = types.default_robot_model(f32, device)
    actor = policy.init_mlp(torch.Generator().manual_seed(seed),
                            device=device)
    dv = RL_DV * torch.randn((RL_BATCH, 3), dtype=f64,
                             generator=torch.Generator().manual_seed(seed))
    reset_counts()
    _, tr = rl_run(rl_carry(model, RL_BATCH, dv), model, actor, RL_TICKS)
    counts = read_counts()
    checks = {f"batch_{k}": v for k, v in rl_criteria(tr).items()}
    checks["no_counted_kernel"] = not any(
        n for k, n in counts.items() if not isinstance(n, dict))

    # the first scenarios against float64 (and float32) on the CPU
    n_ref = RL_SWITCH + RL_F64_WALK_TICKS
    head = {f: getattr(tr, f)[:n_ref, :RL_F64_SCENARIOS].cpu().double()
            for f in ("obs", "target_q", "root_pos")}
    del tr
    cpu = {}
    for dtype in (f64, f32):
        m = types.default_robot_model(dtype, "cpu")
        a = copy.deepcopy(actor).to("cpu", dtype)
        _, t = rl_run(rl_carry(m, RL_F64_SCENARIOS, dv[:RL_F64_SCENARIOS]),
                      m, a, n_ref)
        cpu[dtype] = {f: getattr(t, f).double() for f in head}
    gaps = {f: (float((head[f] - cpu[f64][f]).abs().max()),
                float((cpu[f32][f] - cpu[f64][f]).abs().max()))
            for f in head}
    for f, (card_gap, cpu_gap) in gaps.items():
        checks[f"{f}_f64"] = card_gap <= RL_F64_FACTOR * cpu_gap + RL_F64_FLOOR

    span = lambda: rl_run(rl_carry(model, RL_BATCH, dv), model, actor,
                          RL_TICKS)
    walls = wall_spans(span, RL_SPANS)
    n = RL_BATCH * RL_TICKS
    rate = (f"{n / statistics.median(walls):.1f} scenario-ticks/s (spans "
            f"{n / max(walls):.1f}-{n / min(walls):.1f})")

    # one robot: each tick's wall time, the device synchronized at each
    # tick's command (the host reads it first thing in a tick)
    stamps = []

    def stamp(_):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    one = rl_carry(model, 1, dv[:1])
    _, tr1 = rl_run(one, model, actor, RL_TICKS, on_command=stamp)
    # from the second tick on: the first replay follows the capture
    walls1 = [b - a for a, b in zip(stamps[1:], stamps[2:])]
    crit1 = rl_criteria(tr1)
    checks.update({f"robot_{k}": v for k, v in crit1.items()})
    (k0, b0, _), (k1, b1, _) = (
        kernel_count(lambda t=t: rl_run(one, model, actor, t))
        for t in RL_PROFILE_TICKS)
    ticks = RL_PROFILE_TICKS[1] - RL_PROFILE_TICKS[0]
    busy = (b1 - b0) / ticks
    lines = [
        f"rl (rl_rollout, actor 48-512-256-128-12, {RL_TICKS} ticks at "
        f"{RL_DT} s, press at {RL_SWITCH}, vx {RL_VX}): batch {RL_BATCH} "
        f"{rate}, median of {RL_SPANS} spans on {card}; launches "
        f"{json.dumps(counts)}",
        f"rl one robot: tick wall time p50 {_pct(walls1, 50):.4f} ms, p99 "
        f"{_pct(walls1, 99):.4f} ms (synchronized each tick) on {card}; "
        f"{(k1 - k0) / ticks:.1f} kernel launches a tick, device busy "
        f"{busy:.4f} ms a tick ({100 * busy / _pct(walls1, 50):.1f}% of the "
        f"p50 tick)",
        f"rl first {RL_F64_SCENARIOS} scenarios against float64 on the CPU "
        f"over {n_ref} ticks (card / CPU float32 max abs distance; gate "
        f"card <= {RL_F64_FACTOR:g} x CPU float32 + {RL_F64_FLOOR:g}): "
        + ", ".join(f"{f} {c:.3e} / {p:.3e}" for f, (c, p) in gaps.items()),
        f"rl checks {json.dumps(checks)} "
        f"{'PASS' if all(checks.values()) else 'FAIL'}"]
    return {"rl": counts}, lines, all(checks.values())


def rl_loop_s_mat(loop):
    """The RL loop's live innovation matrix: its last estimate and the
    feed's last frame through the loop's predict step."""
    _, s = loop.bridge.read_sensors()
    x, p = loop._est
    frame = loop._frame(s, loop.command, False)
    return loop._pre(x, p, frame, loop.rl_state)[1].s_mat


def rl_loop_phase(seed, device, card, time_scale):
    """``RLControlLoop`` + ``SimFeeder`` (main.py rl-loop) on rl_gazebo at
    ``time_scale`` for ``RL_LOOP_SECONDS`` of wall time, the A-button
    press at half time. The launch counters are zeroed after the warm-up
    and read after the loop. Gates (tests/test_rl_loop.py): servo gains
    and 0.15 < z < 0.35 through the servo phase, walk gains and mode 1
    after the press, targets inside the pose clip, a finite plant, one K4
    launch an action tick, K4 on the live filter's matrix against its
    plain version; at scale 0.5 more than 100 ticks with fewer than
    ``RL_LOOP_OVERRUN_SHARE`` overruns. Returns (counts, lines, passed)."""
    import numpy as np
    import torch
    from go1_qp_mpc_controller_torch.config import presets
    from go1_qp_mpc_controller_torch.ctrl import rl
    from go1_qp_mpc_controller_torch.models import policy
    from go1_qp_mpc_controller_torch.runtime import feeder as feeder_lib
    from go1_qp_mpc_controller_torch.runtime import rl_loop as rl_loop_lib

    model, params, _ = presets.load_preset("gazebo_mpc", torch.float32,
                                           device=device)
    cfg = presets.load_rl_preset("rl_gazebo")
    actor = policy.init_mlp(torch.Generator().manual_seed(seed),
                            device=device)
    loop = rl_loop_lib.RLControlLoop(
        model, actor, action_period_s=cfg.action_period,
        power_level=cfg.power_level, hardware=not cfg.use_sim_time,
        contact_force_norm=cfg.contact_force_norm, time_scale=time_scale)
    feeder = None
    try:
        loop.warmup()
        feeder = feeder_lib.SimFeeder(loop.bridge, model, params, height=0.3,
                                      period_s=cfg.deploy_period,
                                      time_scale=time_scale, device=device)
        reset_counts()
        host0 = host_sample()
        feeder.start(duration_s=RL_LOOP_SECONDS + 30.0)
        t0 = time.perf_counter()
        loop.start(duration_s=RL_LOOP_SECONDS)
        servo_z = []
        while time.perf_counter() - t0 < RL_LOOP_SECONDS / 2:
            servo_z.append(float(feeder.sim_root_pos[2]))
            time.sleep(0.05)
        servo_mode = int(loop.rl_state.movement_mode[0])
        _, servo_cmd = loop.bridge.read_command()
        press_tick = loop.ticks
        loop.toggle = True
        loop._thread.join(timeout=RL_LOOP_SECONDS + 30.0)
        ended = not loop._thread.is_alive()
        feeder.stop()
        host1 = host_sample()
        counts = read_counts()
        if loop.error is not None:
            raise RuntimeError("the RL loop failed") from loop.error
        if feeder.error is not None:
            raise RuntimeError("the sensor feed failed") from feeder.error
        # after the path's counts were read: K4 on the live filter
        live_line, live_ok = k4_live_line(rl_loop_s_mat(loop))
        _, cmd = loop.bridge.read_command()
        root = feeder.sim_root_pos
        mode = int(loop.rl_state.movement_mode[0])
    finally:
        if feeder is not None:
            feeder.stop()
        loop.close()
    step = loop.metrics.summary("step_ms")
    ticks, overruns = loop.ticks, loop.overruns
    checks = {
        "loop_ended": ended,
        "servo_mode_and_gains": servo_mode == 0 and bool(np.array_equal(
            servo_cmd["kp"], np.asarray(rl.SERVO_P_GAINS))),
        "servo_z_in_(0.15,0.35)": bool(servo_z)
                                  and 0.15 < min(servo_z)
                                  and max(servo_z) < 0.35,
        "walk_mode_and_gains": mode == 1 and bool(np.array_equal(
            cmd["kp"], np.asarray(rl.WALK_P_GAINS))),
        "targets_in_pose_clip": bool(
            np.all(cmd["q"] >= np.asarray(rl.CLIP_POSE_LOWER) - 1e-6)
            and np.all(cmd["q"] <= np.asarray(rl.CLIP_POSE_UPPER) + 1e-6)),
        "finite_root": bool(np.isfinite(root).all()),
        "k4_launches==ticks": counts["schulz_lanes"] == ticks,
        "k4_live_frame": live_ok}
    if time_scale == RL_LOOP_SCALES[0]:
        checks["ticks>100"] = ticks > 100
        checks[f"overruns<{RL_LOOP_OVERRUN_SHARE}*ticks"] = (
            overruns < RL_LOOP_OVERRUN_SHARE * ticks)
    pct = (f"p50 {step['p50']:.4f} ms, p99 {step['p99']:.4f} ms, max "
           f"{step['max']:.4f} ms" if step else "none")
    name = f"rl-loop scale {time_scale:g}"
    lines = [
        f"{name}: RLControlLoop + SimFeeder on rl_gazebo "
        f"({cfg.action_period} s actions, {cfg.deploy_period} s feed) for "
        f"{RL_LOOP_SECONDS} s wall on {card}: {ticks} action ticks (press "
        f"at tick {press_tick}), {overruns} overruns, feeder ticks "
        f"{feeder.ticks} ({feeder.overruns} overruns); step {pct}; servo "
        f"z {min(servo_z, default=float('nan')):.4f}-"
        f"{max(servo_z, default=float('nan')):.4f} m; plant root "
        f"{np.round(root, 4).tolist()}; launches {json.dumps(counts)}",
        f"{name}: {live_line}",
        f"{name} {host_text(host0, host1)}",
        f"{name} checks {json.dumps(checks)} "
        f"{'PASS' if all(checks.values()) else 'FAIL'}"]
    return counts, lines, all(checks.values())


def replay_phase(device, card):
    """``envs/replay.py`` on the card. A one-robot gazebo_mpc trot
    (``rollout.rollout``, batch 1, the EKF and polished cold solves,
    ``REPLAY_TICKS`` ticks, walking at ``REPLAY_VX`` from tick
    ``REPLAY_WALK_AT``; one-tick calls) is recorded, its sensor stream
    read off the carry before each tick with ``srb_sim.read_sensors``;
    ``replay_rollout`` replays the stream from
    the same initial state (the command applied at the walk tick, as the
    rollout's ``command_fn`` does), with the launch counters zeroed before
    and read after. Then ``replay_joint_signal`` on a
    ``sine_joint_signal``. Gates: the replayed torques and GRFs within
    ``REPLAY_TOL`` of the recorded ones, K1, K2, K3 and K6 launched; the
    realized joints finite and tracking the signal (correlation > 0.5,
    tests/test_replay_checkpoint.py). Returns (counts, lines, passed)."""
    import numpy as np
    import torch
    from go1_qp_mpc_controller_torch.config import presets
    from go1_qp_mpc_controller_torch.ctrl import controller
    from go1_qp_mpc_controller_torch.envs import replay, rollout, srb_sim
    from go1_qp_mpc_controller_torch.ops import admm
    from go1_qp_mpc_controller_torch.utils import graphs

    model, params, static = presets.load_preset("gazebo_mpc", torch.float32,
                                                device=device)
    settings = admm.ADMMSettings(**POLISHED)
    kw = dict(settings=settings, use_terrain_adapt=static.use_terrain_adapt)
    carry = rollout.init_carry(model, params, 1, device=device)
    ctrl0 = graphs.clone(carry.ctrl)

    def walking(ctrl, walk):
        vel = torch.zeros_like(ctrl.root_lin_vel_d)
        vel[:, 0] = REPLAY_VX if walk else 0.0
        return ctrl._replace(
            movement_mode=torch.full_like(ctrl.movement_mode, int(walk)),
            root_lin_vel_d=vel)

    # the rollout's sensor read is inside its captured tick: the stream is
    # read off the carry before each one-tick call, with the tick's command
    # applied first, as the rollout's command_fn would
    recorded, records = [], []
    for i in range(REPLAY_TICKS):
        carry = carry._replace(ctrl=walking(carry.ctrl, i >= REPLAY_WALK_AT))
        recorded.append(srb_sim.read_sensors(
            carry.sim, model, carry.ctrl.contacts, carry.stance_forces_z,
            0.002))
        carry, tr_i = rollout.rollout(
            carry, model, params, 1, 0.002,
            warm_settings=controller.WARM_SETTINGS, **kw)
        records.append(tr_i)
    tr = type(records[0])(*[torch.cat(leaves) for leaves in zip(*records)])
    log = replay.SensorLog(*[torch.stack(leaves)
                             for leaves in zip(*recorded)])
    part = lambda a, b: replay.SensorLog(*[leaf[a:b] for leaf in log])
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stand = replay.replay_rollout(ctrl0, model, params,
                                         part(0, REPLAY_WALK_AT), 0.002, **kw)
    _, walk = replay.replay_rollout(walking(state, True), model, params,
                                    part(REPLAY_WALK_AT, REPLAY_TICKS),
                                    0.002, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    gap = {name: float((torch.cat([stand[name], walk[name]])
                        - getattr(tr, name)).abs().max())
           for name in ("joint_torques", "foot_forces_grf")}

    q = replay.sine_joint_signal(SIGNAL_TICKS, 0.002, amplitude=0.1)
    sig = replay.replay_joint_signal(q, model, 0.002)
    realized = sig["joint_pos"][:, 0].cpu().double().numpy()
    corr = float(np.corrcoef(realized[:, 1], q[:, 1])[0, 1])
    checks = {
        "replay_finite": bool(torch.isfinite(walk["joint_torques"]).all()),
        **{f"{k}_within_{REPLAY_TOL:g}": v <= REPLAY_TOL
           for k, v in gap.items()},
        "k1_k2_k3_k6_launched": all(counts[k] > 0 for k in (
            "kkt_schulz", "observe_ekf", "schulz_batch", "admm_iterations")),
        "signal_finite": bool(np.isfinite(realized).all()),
        "signal_tracked_corr>0.5": corr > 0.5}
    lines = [
        f"replay: gazebo_mpc trot recorded from rollout (batch 1, EKF on, "
        f"{REPLAY_TICKS} ticks, walk from {REPLAY_WALK_AT}) and replayed by "
        f"replay_rollout in {wall:.3f} s ({1e3 * wall / REPLAY_TICKS:.3f} ms "
        f"a tick) on {card}; replayed minus recorded max abs: "
        f"{json.dumps(gap)}; launches {json.dumps(counts)}",
        f"replay: replay_joint_signal on a {SIGNAL_TICKS}-tick sine signal: "
        f"joint 1 correlation {corr:.4f}",
        f"replay checks {json.dumps(checks)} "
        f"{'PASS' if all(checks.values()) else 'FAIL'}"]
    return counts, lines, all(checks.values())


def robust_command(walk_from, vx, yaw_rate=0.0, slope=None):
    """tests/test_terrain_turning.py's command: stand, then trot at ``vx``
    (and ``yaw_rate``) from ``walk_from``; on a ``slope`` (z = slope x)
    the height target rides the terrain under the robot."""
    import torch

    def command(i, ctrl):
        walk = i >= walk_from
        vel = torch.zeros_like(ctrl.root_lin_vel_d)
        ang = torch.zeros_like(ctrl.root_ang_vel_d)
        if walk:
            vel[:, 0], ang[:, 2] = vx, yaw_rate
        out = ctrl._replace(
            movement_mode=torch.full_like(ctrl.movement_mode, int(walk)),
            root_lin_vel_d=vel, root_ang_vel_d=ang)
        if slope is not None:
            pos_d = ctrl.root_pos_d.clone()
            pos_d[:, 2] = 0.3 + slope * ctrl.root_pos[:, 0]
            out = out._replace(root_pos_d=pos_d)
        return out
    return command


def robustness_phase(seed, device, card):
    """tests/test_robustness.py and tests/test_terrain_turning.py at their
    full lengths on the card, batch 1, float32, with their criteria: the
    NaN foot-force spike (``SPIKE_SETTLE_TICKS`` standing, one corrupted
    tick, ``SPIKE_RESUME_TICKS`` more), the uphill trot on a 10% grade
    with terrain adaptation and the turning trot (``TERRAIN_TICKS`` each);
    then a poisoned scenario (NaN gradient) among ``POISON_BATCH`` random
    scenarios through the fused cold route (``admm.mpc_solve_cold``, K1 +
    K6): flagged (primal_res >= 1e6), every x finite, every other
    scenario's x, y and residuals bit-identical to the clean run. Returns
    (counts by path, lines, passed)."""
    import torch
    from go1_qp_mpc_controller_torch.ctrl import controller
    from go1_qp_mpc_controller_torch.envs import rollout, srb_sim
    from go1_qp_mpc_controller_torch.models import types
    from go1_qp_mpc_controller_torch.ops import admm

    f32 = torch.float32
    model = types.default_robot_model(f32, device)
    params = types.default_ctrl_params(f32, device)
    settings = admm.ADMMSettings(**POLISHED)
    kw = dict(solver_type=controller.MPC, settings=settings, estimate=False)
    dt = 0.002
    nan = float("nan")
    reset_counts()
    t0 = time.perf_counter()
    carry = rollout.init_carry(model, params, 1, device=device)
    carry, _ = rollout.rollout(carry, model, params, SPIKE_SETTLE_TICKS, dt,
                               use_terrain_adapt=False, **kw)
    bad = carry._replace(stance_forces_z=torch.full_like(
        carry.stance_forces_z, nan))
    sensors = srb_sim.read_sensors(bad.sim, model, bad.ctrl.contacts,
                                   bad.stance_forces_z, dt)
    ctrl = controller.sensor_update(bad.ctrl, model, sensors, dt,
                                    estimate=False)._replace(
        root_pos=bad.sim.root_pos, root_lin_vel=bad.sim.root_lin_vel)
    ctrl = controller.control_step(ctrl, model, params, dt,
                                   solver_type=controller.MPC,
                                   settings=settings, use_terrain_adapt=False)
    spike_tau_finite = bool(torch.isfinite(ctrl.joint_torques).all())
    carry = rollout.RolloutCarry(ctrl=ctrl, sim=bad.sim,
                                 stance_forces_z=torch.full_like(
                                     carry.stance_forces_z, 36.75))
    _, tr = rollout.rollout(carry, model, params, SPIKE_RESUME_TICKS, dt,
                            use_terrain_adapt=False, **kw)
    z = tr.root_pos[:, 0, 2]
    spike_z = float(z[-1])

    slope = 0.1
    ground = torch.tensor([0.0, slope, 0.0], dtype=f32, device=device)
    carry = rollout.init_carry(model, params, 1, device=device,
                               ground_coef=ground)
    _, up = rollout.rollout(carry, model, params, TERRAIN_TICKS, dt,
                            command_fn=robust_command(100, 0.25, slope=slope),
                            use_terrain_adapt=True, ground_coef=ground, **kw)
    pos = up.root_pos[:, 0]
    tp = float(up.terrain_pitch[-200:, 0].abs().mean())
    roll = float(up.root_euler[200:, 0, 0].abs().max())

    carry = rollout.init_carry(model, params, 1, device=device)
    _, turn = rollout.rollout(carry, model, params, TERRAIN_TICKS, dt,
                              command_fn=robust_command(100, 0.2, 0.4),
                              use_terrain_adapt=False, **kw)
    tpos = turn.root_pos[:, 0]
    yaw = float(turn.root_euler[-1, 0, 2])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()

    scn = random_scenarios(POISON_BATCH, seed, device)
    lazy = condense(scn, scn.x0, dense=False)
    fused = admm.ADMMSettings(**SWEEP_FUSED)
    solve = lambda qp: admm.mpc_solve_cold(
        qp, fused, mu=scn.mu, contacts=scn.contacts, foot_pos=scn.foot_pos)[0]
    reset_counts()
    clean = solve(lazy)
    grad = lazy.gradient.clone()
    grad[POISONED] = nan
    dirty = solve(lazy._replace(gradient=grad))
    poison_counts = read_counts()
    keep = torch.arange(POISON_BATCH, device=device) != POISONED
    same = all(torch.equal(getattr(clean, f)[keep], getattr(dirty, f)[keep])
               for f in ("x", "y", "primal_res", "dual_res"))
    flag = float(dirty.primal_res[POISONED])
    checks = {
        "spike_torques_finite": spike_tau_finite,
        "spike_z_finite": bool(torch.isfinite(z).all()),
        "spike_|z_end-0.3|<0.05": abs(spike_z - 0.3) < 0.05,
        "uphill_finite": bool(torch.isfinite(pos).all()),
        "uphill_x_end>0.15": float(pos[-1, 0]) > 0.15,
        "uphill_climbed": float(pos[-1, 2])
                          > 0.3 + slope * float(pos[-1, 0]) - 0.06,
        "uphill_pitch_in_(0.03,0.2)": 0.03 < tp < 0.2,
        "uphill_roll<0.1": roll < 0.1,
        "turn_finite": bool(torch.isfinite(turn.root_euler).all()),
        "turn_yaw_end>0.5": yaw > 0.5,
        "turn_y_end>0.02": float(tpos[-1, 1]) > 0.02,
        "turn_height_within_0.04": bool(
            ((tpos[200:, 2] - 0.3).abs() < 0.04).all()),
        "poisoned_flagged": flag >= 1e6,
        "poisoned_batch_x_finite": bool(torch.isfinite(dirty.x).all()),
        "neighbours_bit_identical": same,
        "poison_route_k1_k6": poison_counts["kkt_schulz"] > 0
                              and poison_counts["admm_iterations"] > 0}
    lines = [
        f"robustness: NaN foot-force spike after {SPIKE_SETTLE_TICKS} ticks, "
        f"{SPIKE_RESUME_TICKS} clean ticks after: torques finite "
        f"{spike_tau_finite}, final z {spike_z:.4f} m; uphill trot (z = "
        f"{slope} x, {TERRAIN_TICKS} ticks): final x {float(pos[-1, 0]):.4f},"
        f" z {float(pos[-1, 2]):.4f} m, mean |terrain pitch| over the last "
        f"200 ticks {tp:.4f} rad, max |roll| from tick 200 {roll:.4f}; "
        f"turning trot: final yaw {yaw:.4f} rad, y {float(tpos[-1, 1]):.4f} "
        f"m; batch 1 float32, {wall:.3f} s on {card}; launches "
        f"{json.dumps(counts)}",
        f"robustness: poisoned scenario {POISONED} of {POISON_BATCH} "
        f"(mpc_solve_cold, K1 + K6): primal_res {flag:g}, the other "
        f"scenarios bit-identical to the clean run {same}; launches "
        f"{json.dumps(poison_counts)}",
        f"robustness checks {json.dumps(checks)} "
        f"{'PASS' if all(checks.values()) else 'FAIL'}"]
    return ({"robustness": counts, "poisoned_batch": poison_counts}, lines,
            all(checks.values()))


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
    failed = []
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
        ("K3 routes", lambda: k3_route_phase(
            torch.Generator().manual_seed(args.seed + 6), device, REPS)),
        ("K4", lambda: k4_phase(BATCH,
                                torch.Generator().manual_seed(args.seed + 5),
                                args.seed + 5, device, REPS)),
    ]
    for name, phase in phases:
        try:
            record, lines, passed = phase()
            if record is not None:
                records.append(record)
            _report(name, lines, passed, failed)
            ok &= passed
        except Exception:     # report the phase and go on to the next
            traceback.print_exc()
            print(f"FAIL {name} phase raised", flush=True)
            failed.append(f"{name} (raised)")
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

    def k5_entry():
        counts, k5_record, lines, passed = k5_phase(device, REPS)
        records.append(k5_record)
        return {"k5_entry": counts}, lines, passed

    def runtime(preset):
        counts, lines, passed = runtime_phase(preset, device, card)
        return {f"runtime_{preset}": counts}, lines, passed

    paths = [("main path", main_path), ("dense chain", dense_chain),
             ("one robot", lambda: single_robot_phase(device, card)),
             ("captured steps", lambda: captured_steps_phase(device, card)),
             ("polished batched", polished), ("K5", k5_entry),
             ("sweep", lambda: sweep_phase(args.seed + 8, device, card)),
             ("mesh", lambda: mesh_phase(args.seed + 12, device, card)),
             ("long horizon", lambda: long_horizon_phase(args.seed + 9,
                                                         device, card))]
    paths += [(f"runtime {preset}", lambda p=preset: runtime(p))
              for preset in RUNTIME]

    def rl_loop(scale):
        counts, lines, passed = rl_loop_phase(args.seed + 10, device, card,
                                              scale)
        return {f"rl_loop_{scale:g}": counts}, lines, passed

    def replay():
        counts, lines, passed = replay_phase(device, card)
        return {"replay": counts}, lines, passed

    paths += [("rl", lambda: rl_phase(args.seed + 10, device, card))]
    paths += [(f"rl-loop {scale:g}", lambda s=scale: rl_loop(s))
              for scale in RL_LOOP_SCALES]
    paths += [("replay", replay),
              ("robustness", lambda: robustness_phase(args.seed + 11, device,
                                                      card))]
    for name, path in paths:
        try:
            counts, lines, passed = path()
            by_path.update(counts)
            _report(name, lines, passed, failed)
            ok &= passed
        except Exception:
            traceback.print_exc()
            print(f"FAIL {name} phase raised", flush=True)
            failed.append(f"{name} (raised)")
            ok = False
    print(capture_cache_line(), flush=True)
    routes = {}
    for name, label in (("kkt_schulz", "K1"), ("schulz_batch", "K3")):
        routes[name] = {path: counts[f"{name}_routes"]
                        for path, counts in by_path.items() if counts[name]}
        print(f"{label} routes by path: {json.dumps(routes[name])}",
              flush=True)
    for record in records:
        if record["name"] in routes:
            record["routes_by_path"] = routes[record["name"]]
        record["launches_by_path"] = {
            path: counts[record["name"]] for path, counts in by_path.items()
            if counts[record["name"]]}
        record["launches"] = sum(record["launches_by_path"].values())
        if record["launches"] == 0:
            print(f"FAIL {record['name']} was launched on no path",
                  flush=True)
            failed.append(f"{record['name']} launched on no path")
            ok = False
    if not ok:
        print("FAIL at least one phase failed; no result", flush=True)
        print(f"FAIL failed: {json.dumps(failed)}", file=sys.stderr,
              flush=True)
        return 1
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

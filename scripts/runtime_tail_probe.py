#!/usr/bin/env python3
"""What lengthens the runtime's GRF solve tail inside a long process.

Runs ``chip_smoke.runtime_phase`` (``ControlLoop.run_dual`` against the
simulated feed, estimator thread, scripted joystick session) on one preset
at one time scale, ``--repeats`` times in each of these states of the
process, in this order:

- ``fresh``: nothing but the kernels' build before it;
- ``profiled``: after a ``torch.profiler`` session over a few hundred
  small device operations (``chip_smoke.device_trace``, as the profiled
  phases of ``chip_smoke.py`` run it);
- ``heap``: with ``--objects`` more small objects tracked by the garbage
  collector, kept alive;
- ``frozen``: the same heap after ``gc.freeze()`` (the collector no longer
  scans it), undone afterwards.

Before each run it times one ``gc.collect()`` (the earlier runs'
garbage). Prints each run's runtime line and host line (process CPU, the
collector's pauses inside the run and tracked objects), then one summary
line a run: grf_ms p50 / p99 against half the wall period. Needs a CUDA
card.

    python3 scripts/runtime_tail_probe.py --preset gazebo_mpc --scale 0.1
"""

import argparse
import gc
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", default="gazebo_mpc")
    parser.add_argument("--scale", type=float, default=0.1)
    parser.add_argument("--repeats", type=int, default=2)
    parser.add_argument("--objects", type=int, default=3_000_000)
    args = parser.parse_args(argv)

    import torch
    from go1_qp_mpc_controller_torch.ops import _build
    from go1_qp_mpc_controller_torch.utils.device import pin_f32_matmuls

    pin_f32_matmuls()
    _build.build_all()
    card = chip_smoke.card_line()
    device = torch.device("cuda")
    half = 0.5 * chip_smoke.RUNTIME_DT / args.scale * 1e3
    heap = []

    def profiled():
        x = torch.ones(64, 64, device=device)
        chip_smoke.device_trace(lambda: [x @ x for _ in range(300)])

    def grow():
        heap.extend([i] for i in range(args.objects))

    for state, before in (("fresh", None), ("profiled", profiled),
                          ("heap", grow), ("frozen", gc.freeze)):
        if before is not None:
            before()
        for k in range(args.repeats):
            t0 = time.perf_counter()
            found = gc.collect()
            print(f"[{state} {k}] gc.collect() before the run: {found} "
                  f"objects in {(time.perf_counter() - t0) * 1e3:.3f} ms",
                  flush=True)
            _, lines, passed = chip_smoke.runtime_phase(
                args.preset, device, card, time_scale=args.scale)
            print(f"[{state} {k}] {lines[0]}", flush=True)
            print(f"[{state} {k}] {lines[3]}", flush=True)
            found = re.search(r"grf_ms p50 ([0-9.]+) ms, p99 ([0-9.]+) ms",
                              lines[0])
            p50, p99 = (float(v) for v in found.groups())
            print(f"tail {state} {k} {args.preset} scale {args.scale:g}: "
                  f"gates {'PASS' if passed else 'FAIL'}, grf_ms p50 "
                  f"{p50:.3f} p99 {p99:.3f} against half the period "
                  f"{half:.3f} ms: {'under' if p99 < half else 'over'}",
                  flush=True)
    gc.unfreeze()


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The runtime path of ``chip_smoke.py`` at several time scales.

Runs ``chip_smoke.runtime_phase`` (``ControlLoop.run_dual`` against the
simulated feed on the card, estimator thread, scripted joystick session)
for each preset at each time scale given, and prints its lines: the loops'
tick counts, cycle / GRF / estimator-frame times, overruns and gates at
each rung, then one summary line a rung: whether its gates passed and
whether grf_ms p99 stayed under half the wall period. A rung lasts
``chip_smoke.RUNTIME_TICKS`` fast periods unless ``--duration`` sets its
wall seconds. Needs a CUDA card; builds the kernels first.

    python3 scripts/runtime_ladder.py --scales 1,0.5,0.25,0.1,0.05
"""

import argparse
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--presets", default="hardware_qp,gazebo_mpc")
    parser.add_argument("--scales", default="0.05,0.02,0.01")
    parser.add_argument("--duration", type=float, default=None)
    args = parser.parse_args(argv)

    import torch
    from go1_qp_mpc_controller_torch.ops import _build
    from go1_qp_mpc_controller_torch.utils.device import pin_f32_matmuls

    pin_f32_matmuls()
    _build.build_all()
    card = chip_smoke.card_line()
    device = torch.device("cuda")
    for preset in args.presets.split(","):
        for scale in (float(s) for s in args.scales.split(",")):
            _, lines, passed = chip_smoke.runtime_phase(
                preset, device, card, time_scale=scale,
                duration=args.duration)
            for line in lines:
                print(line, flush=True)
            found = re.search(r"grf_ms p50 [0-9.]+ ms, p99 ([0-9.]+) ms",
                              lines[0])
            p99 = float(found.group(1)) if found else float("inf")
            half = 0.5 * chip_smoke.RUNTIME_DT / scale * 1e3
            print(f"ladder {preset} scale {scale:g}: gates "
                  f"{'PASS' if passed else 'FAIL'}, grf_ms p99 {p99:.3f} "
                  f"against half the period {half:.3f} ms: "
                  f"{'under' if p99 < half else 'over'}", flush=True)


if __name__ == "__main__":
    main()

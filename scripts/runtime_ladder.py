#!/usr/bin/env python3
"""The runtime path of ``chip_smoke.py`` at several time scales.

Runs ``chip_smoke.runtime_phase`` (``ControlLoop.run_dual`` against the
simulated feed on the card, estimator thread, scripted joystick session)
for each preset at each time scale given, and prints its lines: the loops'
tick counts, cycle / GRF / estimator-frame times, overruns and gates at
each rung. Needs a CUDA card; builds the kernels first.

    python3 scripts/runtime_ladder.py --scales 0.05,0.02,0.01
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--presets", default="hardware_qp,gazebo_mpc")
    parser.add_argument("--scales", default="0.05,0.02,0.01")
    parser.add_argument("--duration", type=float, default=8.0)
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


if __name__ == "__main__":
    main()

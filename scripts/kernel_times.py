#!/usr/bin/env python3
"""Kernel phases of ``chip_smoke.py`` for one checkout of the repository.

Imports ``chip_smoke`` and the port from ``--root`` (a checkout, e.g. one
unpacked from ``git archive``), builds that checkout's kernels into its own
``build/kernels/`` and runs its kernel phases (K1, K2, K3 and K4, those its
``chip_smoke.py`` has) at the smoke test's batch and seeds, printing their
lines: kernel, plain and library times beside the bounds. To compare two
commits on one card, run it in one call for parent, change, change,
parent:

    python3 scripts/kernel_times.py --root build/parent
"""

import argparse
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke
    from go1_qp_mpc_controller_torch.ops import _build
    from go1_qp_mpc_controller_torch.utils.device import pin_f32_matmuls

    assert os.path.dirname(os.path.abspath(chip_smoke.__file__)) == root
    pin_f32_matmuls()
    _build.build_all()
    device = torch.device("cuda")
    print(f"root {args.root}: card {chip_smoke.card_line()}", flush=True)
    gen = lambda k: torch.Generator().manual_seed(args.seed + k)
    phases = [("k1_phase", 0), ("k2_phase", 1), ("k3_phase", 2)]
    for name, k in phases:
        _, lines, passed = getattr(chip_smoke, name)(
            chip_smoke.BATCH, gen(k), device, chip_smoke.REPS)
        for line in lines:
            print(f"[{args.root}] {line}", flush=True)
    if hasattr(chip_smoke, "k4_phase"):
        _, lines, _ = chip_smoke.k4_phase(chip_smoke.BATCH, gen(5),
                                          args.seed + 5, device,
                                          chip_smoke.REPS)
        for line in lines:
            print(f"[{args.root}] {line}", flush=True)


if __name__ == "__main__":
    main()

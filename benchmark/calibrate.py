"""The readings that a cell's limits for ``correct`` are set from, in one
process: for each seed, the cell's set-up and a short window at its own
size and load, then the reference's verdict on what the program produced
(the lower readings) and, on the first ``--control-seeds`` seeds, on what
the control produced in the program's place (the reference in float32 with
TF32 products: the upper readings).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        --seconds 6 --control-seeds 3 [--out chiprun_out/cal.jsonl]

Prints one JSON line a seed and side. Needs the card the cell needs.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    root = HERE.parent
    sys.path.insert(1, str(root))
    import importlib

    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    _, _, config, mix, limits = harness.load_cell(root, HERE, args.workload)
    entry = importlib.import_module(f"entries.{mix['entry']}")
    from go1_qp_mpc_controller_torch.ops import _build
    _build.build_all()
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        cell = entry.Cell(config, mix, seed, device)
        cell.setup()
        cell.window(args.seconds, harness.Tracer(None, device))
        sides = ["program"] + (["control"] if i < args.control_seeds else [])
        for side in sides:
            compared, readings, correct = cell.check(
                limits, control=side == "control")
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "side": side, "correct": correct,
                               "failed_in_window": sum(
                                   cell.tally.counts()),
                               "readings": readings,
                               "compared": compared})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        del cell
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Failed robot-ticks of each whole episode of the benchmark's fleet cell.

The fleet cell (``benchmark/entries/fleet.py``) reports its failed share
over a window that ends wherever the clock stops, so a partial last
episode weighs in it. This runs the cell of the checkout at ``--root``
(set-up included, as ``benchmark/run.py`` runs it) for ``--episodes``
whole episodes from ``--seed`` and prints one JSON line: the failed
robot-ticks of each episode (the cell's own health test), its ticks and
routes, and the seconds the episodes took. Two checkouts whose ticks give
the same bits print the same failures; compare them on one card:

    python3 scripts/fleet_episode_failures.py --root build/parent --seed 7
    python3 scripts/fleet_episode_failures.py --root . --seed 7
"""

import argparse
import json
import os
import sys
import time


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=".")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--episodes", type=int, default=3)
    p.add_argument("--workload", default="mpc-fleet-trot-4096")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "benchmark"), root]
    from pathlib import Path

    import torch

    import harness
    from entries import common, fleet
    from go1_qp_mpc_controller_torch.ops import _build

    _, _, config, mix, _ = harness.load_cell(Path(root),
                                             Path(root) / "benchmark",
                                             args.workload)
    torch.set_num_threads(1)
    _build.build_all()
    device = torch.device("cuda", 0)
    cell = fleet.Cell(config, mix, args.seed, device)
    cell.setup()
    episode_ticks = int(mix["episode_ticks"])
    failed, routes = [], {}
    t0 = time.perf_counter()
    for episode in range(args.episodes):
        carry = cell.fresh(episode)
        bad = torch.zeros((), dtype=torch.int64, device=device)
        for _ in range(episode_ticks):
            stats = {}
            carry, rec = cell.tick(carry, stats)
            (route,) = stats
            routes[route] = routes.get(route, 0) + 1
            bad += common.unhealthy(carry.sim, rec).sum()
        failed.append(int(bad))
    common.sync(device)
    print(json.dumps({
        "root": args.root, "seed": args.seed, "batch": cell.batch,
        "episode_ticks": episode_ticks, "failed_by_episode": failed,
        "routes": routes, "seconds": time.perf_counter() - t0,
        "card": torch.cuda.get_device_name(device)}))


if __name__ == "__main__":
    main()

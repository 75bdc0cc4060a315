#!/usr/bin/env python3
"""Path phases of ``chip_smoke.py`` for one checkout of the repository.

Imports ``chip_smoke`` and the port from ``--root`` (a checkout, e.g. one
unpacked from ``git archive``), builds that checkout's kernels into its own
``build/kernels/`` and runs the chosen path phases of its
``chip_smoke.py`` at the smoke test's batch, ticks and seeds, printing
their lines (throughput or tick wall time, device busy time a tick,
routes, launches, health): the batched paths (main, polished, chain), one
robot (``single_robot_phase``: the trot and the balance-QP stand at batch
1), the same ticks eager beside captured (``captured_steps_phase``, in
checkouts that have it), the balance-QP stand alone with a profile of its
device time (qp) and
the real-time runtime (``runtime_phase`` on each of the checkout's
``RUNTIME`` presets), the scenario sweep (``sweep_phase``), the mesh at
world size 1 (``mesh_phase``), the long
horizon (``long_horizon_phase``), the RL rollout (``rl_phase``), the RL
host loop (``rl_loop_phase`` at each of ``RL_LOOP_SCALES``), the log
replay (``replay_phase``) and robustness / terrain
(``robustness_phase``). The host sets the pace of these paths
and its speed varies from run to run, so compare two commits on one card
by running this in one call for parent, change, change, parent (each run
a fresh process):

    python3 scripts/path_times.py --root build/parent --paths main,polished
    python3 scripts/path_times.py --root build/parent --paths robot,runtime
"""

import argparse
import os
import sys

PATHS = ("main", "polished", "chain", "robot", "captured", "qp", "runtime",
         "sweep", "mesh", "long", "rl", "rl_loop", "replay", "robust")


def qp_stand(cs, device):
    """The one-robot balance-QP stand of ``cs.single_robot_phase`` alone:
    ``cs.QP_TICKS`` synchronized ticks (tick wall time), then
    ``cs.ROBOT_PROFILE_TICKS`` more under the profiler (device busy time
    and launches a tick, the kernels that take the most)."""
    import torch
    from go1_qp_mpc_controller_torch.ctrl import controller
    from go1_qp_mpc_controller_torch.envs import rollout
    from go1_qp_mpc_controller_torch.models import types
    from go1_qp_mpc_controller_torch.ops import admm

    f32 = torch.float32
    model = types.default_robot_model(f32, device)
    params = types.default_ctrl_params(f32, device)
    kw = dict(settings=admm.ADMMSettings(**cs.POLISHED),
              warm_settings=controller.WARM_SETTINGS,
              use_terrain_adapt=False, solver_type=controller.QP,
              estimate=False)
    carry = rollout.init_carry(model, params, 1, dtype=f32, device=device)
    carry, _, walls = cs._robot_ticks(carry, model, params, cs.QP_TICKS,
                                      None, **kw)
    p50 = cs._pct(walls, 50)
    lines = [f"balance-QP stand: {cs.QP_TICKS} ticks, tick wall time p50 "
             f"{p50:.3f} ms, p99 {cs._pct(walls, 99):.3f} ms"]
    return lines + ["balance-QP stand " + line for line in cs.profile_lines(
        lambda: cs._robot_ticks(carry, model, params, cs.ROBOT_PROFILE_TICKS,
                                None, **kw), cs.ROBOT_PROFILE_TICKS, p50)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True)
    parser.add_argument("--paths", default="main,polished",
                        help=f"comma-separated, of {', '.join(PATHS)}")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    paths = args.paths.split(",")
    for path in paths:
        if path not in PATHS:
            parser.error(f"unknown path {path!r}")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke
    from go1_qp_mpc_controller_torch.ops import _build
    from go1_qp_mpc_controller_torch.utils.device import pin_f32_matmuls

    assert os.path.dirname(os.path.abspath(chip_smoke.__file__)) == root
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the paths run only on a GPU")
    pin_f32_matmuls()
    _build.build_all()
    device = torch.device("cuda")
    card = chip_smoke.card_line()
    cs = chip_smoke
    phases = {
        "main": lambda: cs.main_path_phase(
            cs.BATCH, cs.ONSET_TICKS, cs.TIMED_TICKS, args.seed, device,
            cs.PROFILE_TICKS, card)[1],
        "polished": lambda: cs.polished_batched_phase(
            cs.BATCH, args.seed + 4, device, card)[1],
        "chain": lambda: cs.dense_chain_phase(
            cs.BATCH, args.seed + 3, device, cs.REPS)[2],
        "robot": lambda: cs.single_robot_phase(device, card)[1],
        "captured": lambda: cs.captured_steps_phase(device, card)[1],
        "qp": lambda: qp_stand(cs, device),
        "runtime": lambda: [line for preset in cs.RUNTIME for line in
                            cs.runtime_phase(preset, device, card)[1]],
        "sweep": lambda: cs.sweep_phase(args.seed + 8, device, card)[1],
        "mesh": lambda: cs.mesh_phase(args.seed + 12, device, card)[1],
        "long": lambda: cs.long_horizon_phase(args.seed + 9, device,
                                              card)[1],
        "rl": lambda: cs.rl_phase(args.seed + 10, device, card)[1],
        "rl_loop": lambda: [line for scale in cs.RL_LOOP_SCALES for line in
                            cs.rl_loop_phase(args.seed + 10, device, card,
                                             scale)[1]],
        "replay": lambda: cs.replay_phase(device, card)[1],
        "robust": lambda: cs.robustness_phase(args.seed + 11, device,
                                              card)[1],
    }
    print(f"root {args.root}: card {card}", flush=True)
    for path in paths:
        for line in phases[path]():
            print(f"[{args.root}] {line}", flush=True)


if __name__ == "__main__":
    main()

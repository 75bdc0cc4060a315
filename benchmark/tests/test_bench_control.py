"""The control of ``correct`` on the card: the reference in float32 with
TF32 products, put in the program's place, comes out not correct on three
seeds, at the cells' own sizes and a short window."""

import pytest


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mpc-fleet-trot-4096",
                                      "mpc-one-robot-joystick",
                                      "mpc-sweep-4096"])
def test_the_control_is_not_correct(workload):
    import sys
    from pathlib import Path

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is read on the card")
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root / "benchmark"))
    sys.path.insert(1, str(root))
    import importlib

    import harness
    _, _, config, mix, limits = harness.load_cell(root, root / "benchmark",
                                                  workload)
    entry = importlib.import_module(f"entries.{mix['entry']}")
    device = torch.device("cuda", 0)
    for seed in (3_000_000_001, 3_000_000_002, 3_000_000_003):
        cell = entry.Cell(config, mix, seed, device)
        cell.setup()
        cell.window(4.0, harness.Tracer(None, device))
        _, _, program_ok = cell.check(limits)
        _, _, control_ok = cell.check(limits, control=True)
        assert program_ok and not control_ok, seed

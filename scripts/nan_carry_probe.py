#!/usr/bin/env python3
"""Which scenarios' carried KKT inverse the dense cold route leaves NaN,
and whether the plain version leaves it too.

Runs ``chip_smoke.mesh_phase``'s start (batch ``--batch``, its seeded
perturbations) for ``--ticks`` ticks of ``control_step_batched`` with the
polished cold settings, recording every ``admm.mpc_solve(...,
return_warm=True)`` call (the controller's dense cold route). For each
call whose carried inverse holds NaN in some scenarios, the same solve of
those scenarios alone is repeated on the device (the kernels, at their own
batch) and on the CPU in float32 and float64 (the plain versions), and
the script reports, for each, whether the carried inverse, x and rho are
finite. Prints one JSON line. With ``--save PATH`` it also writes those
scenarios' recorded operands (the QP, the warm start, the settings) to
an npz, for the same solve in the JAX package.

    python3 scripts/nan_carry_probe.py                 # the card, 4096
    python3 scripts/nan_carry_probe.py --device cpu --batch 64
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from go1_qp_mpc_controller_torch.ctrl import controller  # noqa: E402
from go1_qp_mpc_controller_torch.envs import rollout  # noqa: E402
from go1_qp_mpc_controller_torch.models import types  # noqa: E402
from go1_qp_mpc_controller_torch.ops import admm  # noqa: E402
from go1_qp_mpc_controller_torch.utils import graphs  # noqa: E402
from go1_qp_mpc_controller_torch.utils.device import (  # noqa: E402
    resolve_device)


def _finite(sol, warm):
    """Per-scenario finiteness of the carried inverse, x and rho."""
    return {"minv": torch.isfinite(warm.minv).flatten(1).all(1),
            "x": torch.isfinite(sol.x).all(1),
            "rho": torch.isfinite(warm.rho) & (warm.rho > 0)}


def _resolve(call, rows, device, dtype):
    """The recorded solve of ``rows`` alone on ``device`` in ``dtype``:
    {field: finite in every row}."""
    qp, settings, warm_x, warm_y, warm_rho = call
    move = lambda t: None if t is None else t[rows].to(device=device,
                                                        dtype=dtype)
    sol, warm = admm.mpc_solve(
        type(qp)(*[move(t) for t in qp]), settings, warm_x=move(warm_x),
        warm_y=move(warm_y), warm_rho=move(warm_rho), return_warm=True)
    return {k: bool(v.all()) for k, v in _finite(sol, warm).items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None)
    parser.add_argument("--batch", type=int, default=chip_smoke.SWEEP_BATCH)
    parser.add_argument("--ticks", type=int,
                        default=chip_smoke.MESH_CTRL_TICKS)
    parser.add_argument("--seed", type=int, default=12)
    parser.add_argument("--save", default=None, metavar="OUT.npz")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        from go1_qp_mpc_controller_torch.ops import _build
        _build.build_all()
    f32, batch = torch.float32, args.batch
    model = types.default_robot_model(f32, device)
    params = types.default_ctrl_params(f32, device)
    carry = rollout.init_carry(model, params, batch, dtype=f32,
                               device=device)
    gen = torch.Generator().manual_seed(args.seed)
    pos = carry.sim.root_pos.clone()
    pos[:, 2] += (0.005 * torch.randn((batch,), generator=gen)).to(device)
    carry = carry._replace(sim=carry.sim._replace(
        root_pos=pos, root_lin_vel=carry.sim.root_lin_vel
        + (0.01 * torch.randn((batch, 3), generator=gen)).to(device)))

    calls = []
    solve = admm.mpc_solve

    def recording(qp, settings=admm.ADMMSettings(), warm_x=None,
                  warm_y=None, warm_rho=None, mu=None, return_warm=False):
        out = solve(qp, settings, warm_x, warm_y, warm_rho, mu, return_warm)
        if return_warm:
            keep = lambda t: None if t is None else t.clone()
            calls.append(((graphs.clone(qp), settings, keep(warm_x),
                           keep(warm_y), keep(warm_rho)), out))
        return out

    dense = admm.ADMMSettings(**chip_smoke.POLISHED)
    step = lambda s: controller.control_step_batched(
        s, model, params, 0.002, settings=dense, use_terrain_adapt=False,
        compact_k=256)
    admm.mpc_solve = recording
    try:
        for _ in range(args.ticks):
            carry = chip_smoke.mesh_tick(carry, model, step)
    finally:
        admm.mpc_solve = solve

    report = {"device": str(device), "batch": batch, "ticks": args.ticks,
              "calls": []}
    if device.type == "cuda":
        report["card"] = torch.cuda.get_device_name(device)
    saved = {}
    for i, (call, (sol, warm)) in enumerate(calls):
        finite = _finite(sol, warm)
        bad = ~(finite["minv"] & finite["x"] & finite["rho"])
        rows = torch.nonzero(bad).flatten()
        entry = {"batch": int(bad.numel()),
                 "rows": rows.tolist()[:16],
                 "nonfinite": {k: int((~v).sum()) for k, v in
                               finite.items()}}
        if len(rows):
            entry["rho"] = warm.rho[rows].tolist()[:16]
            if call[4] is not None:
                entry["warm_rho_in"] = call[4][rows].tolist()[:16]
            entry["primal_res"] = sol.primal_res[rows].tolist()[:16]
            entry["alone_on_device"] = _resolve(call, rows, device, f32)
            cpu = torch.device("cpu")
            entry["plain_float32"] = _resolve(call, rows, cpu, f32)
            entry["plain_float64"] = _resolve(call, rows, cpu,
                                              torch.float64)
            qp, settings, warm_x, warm_y, warm_rho = call
            ops = dict(zip(qp._fields, qp), warm_x=warm_x, warm_y=warm_y,
                       warm_rho=warm_rho)
            saved.update({f"call{i}_{k}": v[rows].cpu().numpy()
                          for k, v in ops.items() if v is not None})
            saved[f"call{i}_settings"] = json.dumps(settings._asdict())
        report["calls"].append(entry)
    if args.save:
        import numpy as np
        np.savez(args.save, **saved)
    print(json.dumps(report))


if __name__ == "__main__":
    main()

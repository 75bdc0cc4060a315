#!/usr/bin/env python3
"""The JAX package's dense solve on the operands ``nan_carry_probe.py
--save`` wrote: for each recorded call, JAX's ``admm.mpc_solve(...,
return_warm=True)`` of each saved scenario in float64 and float32 on the
CPU, and whether its carried inverse, x and rho are finite, beside the
port's plain version on the same operands. Prints one JSON line.

    python3 scripts/nan_carry_jax.py rows.npz
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from go1_qp_mpc_controller_torch.models import srb as t_srb
    from go1_qp_mpc_controller_torch.ops import admm as t_admm
    from go1_qp_mpc_controller_tpu.models import srb as j_srb
    from go1_qp_mpc_controller_tpu.ops import admm as j_admm

    with np.load(argv[0]) as z:
        ops = {k: z[k] for k in z.files}
    calls = sorted({k.split("_")[0] for k in ops})
    report = {}
    for call in calls:
        get = lambda name: ops[f"{call}_{name}"]
        fields = json.loads(str(get("settings")))
        out = {}
        for dtype in ("float64", "float32"):
            jd, td = getattr(jnp, dtype), getattr(torch, dtype)
            solve = jax.jit(jax.vmap(lambda h, g, lb, ub, x, y, r:
                j_admm.mpc_solve(
                    j_srb.CondensedQP(hessian=h, gradient=g, lb=lb, ub=ub),
                    j_admm.ADMMSettings(**fields), warm_x=x, warm_y=y,
                    warm_rho=r, return_warm=True)))
            j_sol, j_warm = solve(*[jnp.asarray(get(k), jd) for k in (
                "hessian", "gradient", "lb", "ub", "warm_x", "warm_y",
                "warm_rho")])
            t = lambda k: torch.as_tensor(get(k)).to(td)
            t_sol, t_warm = t_admm.mpc_solve(
                t_srb.CondensedQP(*[t(k) for k in ("hessian", "gradient",
                                                   "lb", "ub")]),
                t_admm.ADMMSettings(**fields), warm_x=t("warm_x"),
                warm_y=t("warm_y"), warm_rho=t("warm_rho"),
                return_warm=True)
            minv_j = np.asarray(j_warm.minv).reshape(len(get("gradient")),
                                                     -1)
            out[dtype] = {
                "jax_minv_finite": np.isfinite(minv_j).all(1).tolist(),
                "jax_x_finite": np.isfinite(np.asarray(j_sol.x)).all(1)
                .tolist(),
                "jax_rho": np.asarray(j_warm.rho).tolist(),
                "port_minv_finite": torch.isfinite(t_warm.minv).flatten(1)
                .all(1).tolist(),
                "port_rho": t_warm.rho.tolist()}
        report[call] = out
    print(json.dumps(report))


if __name__ == "__main__":
    main()

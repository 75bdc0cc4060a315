"""PyTorch port, the fused lazy warm tick: the port's counterpart of
tests/test_warm_ticks.py::test_fused_lazy_warm_tick_matches_regular, in
float64 on the CPU.

Inside the port, with the JAX test's tolerances: the lazy condensation
materializes to the dense one (1e-12), its unmaterialized matvec is
``H @ v`` (1e-10), and six drifting warm ticks of ``mpc_solve_warm_fused``
match ``mpc_solve_warm`` on the dense QP (1e-8 on x, dual residual below
5e-4). Against the JAX package: each tick's fused solution within 1e-8 of
the JAX ``mpc_solve_warm_fused`` on the same QP and warm state (both run
the same float64 arithmetic; summation order only).

The slow cases of tests/test_warm_ticks.py and tests/test_warm_accuracy.py
(20-tick and closed-loop warm-vs-cold tracking) are read on the card by
``chip_smoke.py``'s dense chain (its warm-vs-tight GRF line) and not
repeated here.
"""

import jax.numpy as jnp
import numpy as np
import torch

from go1_qp_mpc_controller_torch.models import srb as t_srb
from go1_qp_mpc_controller_torch.ops import admm as t_admm
from go1_qp_mpc_controller_tpu.compat import oracle
from go1_qp_mpc_controller_tpu.models import srb as j_srb
from go1_qp_mpc_controller_tpu.ops import admm as j_admm

torch.set_num_threads(1)
F64 = torch.float64
WARM = dict(seg_iters=60, segments=1, polish=False, schulz_refine=4)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol, err_msg=what)


def test_fused_lazy_warm_tick_matches_regular():
    f = oracle.test_mpc_fixture()
    inputs = dict(a_d=f["a_d"], b_d=f["b_d_list"][0],
                  x_ref=f["x_ref"].reshape(10, 13), qw=f["q_weights"],
                  rw=f["r_weights"], contacts=f["contacts"])
    t = {k: torch.as_tensor(np.asarray(v), dtype=F64)[None]
         for k, v in inputs.items()}
    j = {k: jnp.asarray(v, jnp.float64) for k, v in inputs.items()}
    x0 = np.asarray(f["x0"], np.float64)

    def t_qps(x):
        args = (t["a_d"], t["b_d"], torch.as_tensor(x, dtype=F64)[None],
                t["x_ref"], t["qw"], t["rw"], t["contacts"])
        return (t_srb.condense_nilpotent_const(*args),
                t_srb.condense_nilpotent_lazy(*args))

    def j_lazy(x):
        return j_srb.condense_nilpotent_lazy(
            j["a_d"], j["b_d"], jnp.asarray(x), j["x_ref"], j["qw"],
            j["rw"], j["contacts"])

    qp0, lz0 = t_qps(x0)
    _, warm = t_admm.mpc_solve(qp0, t_admm.ADMMSettings(), return_warm=True)
    _, j_warm = j_admm.mpc_solve(j_srb.condense_nilpotent_const(
        j["a_d"], j["b_d"], jnp.asarray(x0), j["x_ref"], j["qw"], j["rw"],
        j["contacts"]), j_admm.ADMMSettings(), return_warm=True)
    # the lazy form materializes to the identical QP
    _close(t_srb.lazy_hessian(lz0), qp0.hessian.numpy(), 1e-12)
    _close(t_srb.lazy_hessian_diag(lz0),
           torch.diagonal(qp0.hessian, dim1=-2, dim2=-1).numpy(), 1e-12)
    v = torch.as_tensor(np.random.default_rng(7).normal(size=(1, 120)),
                        dtype=F64)
    _close(t_srb.lazy_hessian_matvec(lz0, v),
           (qp0.hessian @ v[..., None])[..., 0].numpy(), 1e-10)

    drift = np.zeros(13)
    drift[9], drift[5] = 0.002, -0.0005
    settings = t_admm.ADMMSettings(**WARM)
    warm_a = warm_b = warm
    for k in range(6):
        x0 = x0 + drift
        qp_k, lz_k = t_qps(x0)
        sol_a, warm_a = t_admm.mpc_solve_warm(qp_k, warm_a, settings)
        sol_b, warm_b = t_admm.mpc_solve_warm_fused(lz_k, warm_b, settings)
        _close(sol_b.x, sol_a.x.numpy(), 1e-8, f"tick {k}")
        assert float(sol_b.dual_res[0]) < 5e-4
        j_sol, j_warm = j_admm.mpc_solve_warm_fused(
            j_lazy(x0), j_warm, j_admm.ADMMSettings(**WARM))
        _close(sol_b.x[0], j_sol.x, 1e-8, f"tick {k} against JAX")

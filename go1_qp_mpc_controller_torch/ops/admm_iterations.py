"""K6: the fixed-iteration ADMM loop with the KKT inverse kept on chip,
and the dense batched warm tick built on it.

Port of the JAX package's Pallas kernel ``ops/pallas_admm.py::
admm_iterations`` (``_kernel``) and of its entry ``mpc_solve_warm_batch``.
The TPU kernel's (5, 64) constraint "planes" and 0/1 selection matmuls
were artifacts of its matrix unit; here the loop works on the flat
(B, 120) / (B, 200) layout of the rest of the port, and the friction
pyramid acts per (step, leg) pair as in ``srb.constraint_matvec``.

``admm_iterations`` (the JAX entry's signature: z starts at clip(C x0))
and ``admm_loop`` (from a carried z: the ADMM segments of ``admm.solve``
and ``solve_segmented_fused`` and every warm tick's loop) are the entry
points: float32 CUDA inputs launch the hand-written Hopper kernel
``csrc/admm_iterations.cu``; CPU inputs take the plain version (the
port's ADMM loop, ``admm._admm_iterations``;
:func:`admm_iterations_plain`). Any other input raises.
"""

import ctypes
import functools

import torch

from go1_qp_mpc_controller_torch.models import srb
from go1_qp_mpc_controller_torch.ops import _build, admm, kkt_schulz

NV = srb.H * srb.NU          # 120 variables
NC = srb.H * srb.NC1         # 200 constraint rows

# launches of the CUDA kernel since the last reset (CPU calls do not count)
launches = 0


def reset_launches():
    global launches
    launches = 0


def admm_iterations_plain(minv, qbar, lb, ub, rho_vec, mu, x0, y0, iters,
                          alpha, sigma):
    """Plain PyTorch version of K6 (same signature as
    :func:`admm_iterations`): z0 = clip(C x0, lb, ub), then ``iters``
    iterations of ``admm._admm_iterations``."""
    mu = admm._mu_col(mu)
    matvec = functools.partial(srb.constraint_matvec, mu=mu)
    rmatvec = functools.partial(srb.constraint_rmatvec, mu=mu)
    z0 = torch.clamp(matvec(x0), lb, ub)
    x, _, y = admm._admm_iterations(admm._minv_solve(minv), x0, z0, y0,
                                    qbar, lb, ub, rho_vec, iters, alpha,
                                    sigma, matvec, rmatvec)
    return x, y


def persistent_grid(batch, sms, blocks_per_sm):
    """Blocks of the kernel's persistent grid for ``batch`` scenarios:
    every block the card holds at once (``blocks_per_sm`` on each of its
    ``sms`` SMs), never more than one a scenario. Each block loops over
    the scenarios b, b + grid, ..., staging the next one's inverse while
    the current one iterates."""
    return min(batch, sms * blocks_per_sm)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("admm_iterations")
    ptr = ctypes.c_void_p
    lib.admm_iterations_launch.argtypes = [ptr] * 12 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ptr]
    lib.admm_iterations_launch.restype = ctypes.c_int
    lib.admm_iterations_blocks_per_sm.argtypes = []
    lib.admm_iterations_blocks_per_sm.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _resident(device_index):
    """(SMs, resident blocks a SM) of the card, asked once: the launch
    then needs no query, so it can be captured in a CUDA graph."""
    per_sm = _lib().admm_iterations_blocks_per_sm()
    if per_sm < 1:
        raise RuntimeError(f"admm_iterations: occupancy query failed "
                           f"({per_sm})")
    return (torch.cuda.get_device_properties(device_index)
            .multi_processor_count, per_sm)


def _launch(minv, qbar, lb, ub, rho_vec, mu, x0, z0, y0, iters, alpha,
            sigma):
    """Check the CUDA operands and launch the kernel (z0 None: start from
    clip(C x0)). Returns (x, z, y)."""
    batch = minv.shape[0]
    check = kkt_schulz.check_cuda_f32
    check("admm_iterations", "minv", minv, (batch, NV, NV))
    vectors = [("qbar", qbar, NV), ("x0", x0, NV), ("lb", lb, NC),
               ("ub", ub, NC), ("rho_vec", rho_vec, NC), ("y0", y0, NC)]
    if z0 is not None:
        vectors.append(("z0", z0, NC))
    for name, t, n in vectors:
        check("admm_iterations", name, t, (batch, n))
    check("admm_iterations", "mu", mu, (batch,))
    if iters < 0:
        raise ValueError(f"admm_iterations: {iters} iterations")
    if minv.data_ptr() % 16:
        raise ValueError("admm_iterations: minv must be 16-byte aligned "
                         "(its slabs are bulk-copied)")
    out = dict(device=minv.device, dtype=torch.float32)
    x = torch.empty((batch, NV), **out)
    z = torch.empty((batch, NC), **out)
    y = torch.empty((batch, NC), **out)
    if batch == 0:
        return x, z, y
    rc = _lib().admm_iterations_launch(
        minv.data_ptr(), qbar.data_ptr(), lb.data_ptr(), ub.data_ptr(),
        rho_vec.data_ptr(), mu.data_ptr(), x0.data_ptr(),
        None if z0 is None else z0.data_ptr(), y0.data_ptr(), x.data_ptr(),
        z.data_ptr(), y.data_ptr(), int(iters), float(alpha), float(sigma),
        batch, persistent_grid(batch, *_resident(minv.device.index)),
        torch.cuda.current_stream(minv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"admm_iterations: CUDA launch failed with error "
                           f"{rc}")
    global launches
    launches += 1
    return x, z, y


def admm_iterations(minv, qbar, lb, ub, rho_vec, mu, x0, y0, iters=40,
                    alpha=1.6, sigma=1e-6):
    """K6 entry point: ``iters`` ADMM iterations on the carried inverses
    from z0 = clip(C x0) (the JAX entry's signature).

    Args:
      minv: (B, 120, 120) scaled KKT inverses.
      qbar: (B, 120) scaled gradients.
      lb, ub, rho_vec: (B, 200) finite bounds and per-row rho.
      mu: (B,) friction coefficients.
      x0, y0: (B, 120), (B, 200) warm starts (y in scaled units).

    Returns:
      (x, y): (B, 120) primal and (B, 200) scaled dual.
    """
    if minv.device.type == "cpu":
        return admm_iterations_plain(minv, qbar, lb, ub, rho_vec, mu, x0,
                                     y0, iters, alpha, sigma)
    x, _, y = _launch(minv, qbar, lb, ub, rho_vec, mu, x0, None, y0, iters,
                      alpha, sigma)
    return x, y


def admm_loop(minv, qbar, lb, ub, rho_vec, mu, x, z, y, iters, alpha,
              sigma):
    """K6 from a carried ADMM iterate (x, z, y): the loop of the solver's
    segments and warm ticks on the friction pyramid. CPU tensors take the
    plain loop ``admm._admm_iterations``; float32 CUDA tensors launch the
    kernel; anything else raises.

    Args:
      minv, qbar, lb, ub, rho_vec: as in :func:`admm_iterations`.
      mu: friction coefficient, a number, (B,) or (B, 1).
      x, z, y: (B, 120), (B, 200), (B, 200) iterate (y scaled).

    Returns:
      (x, z, y) after ``iters`` iterations.
    """
    if minv.device.type == "cpu":
        mu = admm._mu_col(mu)
        return admm._admm_iterations(
            admm._minv_solve(minv), x, z, y, qbar, lb, ub, rho_vec, iters,
            alpha, sigma, functools.partial(srb.constraint_matvec, mu=mu),
            functools.partial(srb.constraint_rmatvec, mu=mu))
    batch = minv.shape[0]
    mu = (mu.reshape(-1).expand(batch) if torch.is_tensor(mu)
          else torch.full((batch,), float(mu), dtype=torch.float32,
                          device=minv.device))
    minv, qbar, lb, ub, rho_vec, mu, x, z, y = (
        t.contiguous() for t in (minv, qbar, lb, ub, rho_vec, mu, x, z, y))
    return _launch(minv, qbar, lb, ub, rho_vec, mu, x, z, y, iters, alpha,
                   sigma)


def warm_batch_operands(qps, warms, mus, settings):
    """K6's operands for the dense warm tick :func:`mpc_solve_warm_batch`:
    the carried inverse refined with ``schulz_refine`` plain safeguarded
    steps (K3) on the fused pyramid KKT at the carried rho, and the
    cost-scaled gradient, bounds and dual. Returns (dict of
    :func:`admm_iterations` arguments, cost)."""
    cost = 1.0 / torch.clamp(torch.amax(torch.abs(qps.hessian),
                                        dim=(-2, -1)), min=1e-12)
    pbar = cost[:, None, None] * qps.hessian
    eq, lb_f, ub_f = admm._bounds(qps.lb, qps.ub)
    rho_vec = admm._rho_vec(eq, warms.rho, settings)
    m_mat = admm._pyramid_kkt_fused(pbar, settings.sigma, rho_vec,
                                    admm._mu_col(mus))
    minv = admm._schulz_inverse(m_mat, settings.schulz_refine,
                                warms.minv.contiguous(),
                                hi_tail=settings.schulz_hi_tail)
    return dict(minv=minv, qbar=(cost[:, None] * qps.gradient).contiguous(),
                lb=lb_f.contiguous(), ub=ub_f.contiguous(),
                rho_vec=rho_vec.contiguous(), mu=mus.contiguous(),
                x0=warms.x.contiguous(),
                y0=(warms.y * cost[:, None]).contiguous()), cost


def mpc_solve_warm_batch(qps, warms, mus, settings):
    """Batched dense warm MPC tick on K3 + K6 (the JAX package's
    ``pallas_admm.mpc_solve_warm_batch``). It differs from
    ``admm.mpc_solve_warm`` as the JAX entry does: the carried inverse is
    refined with ``schulz_refine`` plain safeguarded steps on the fused
    pyramid KKT and rho never adapts; the loop runs on K6; the returned z
    is clip(C x) recomputed after the loop, and the dual residual is
    taken against the dense Hessian.

    Args:
      qps: srb.CondensedQP, (B, ...) leaves.
      warms: admm.WarmState carry.
      mus: (B,) friction coefficients.
      settings: admm.ADMMSettings (seg_iters, alpha, sigma,
        schulz_refine, rho_eq_scale).

    Returns:
      (admm.ADMMSolution, next admm.WarmState).
    """
    ops, cost = warm_batch_operands(qps, warms, mus, settings)
    x, y_scaled = admm_iterations(**ops, iters=settings.seg_iters,
                                  alpha=settings.alpha, sigma=settings.sigma)
    y = y_scaled / cost[:, None]
    finite = torch.isfinite(x).all(-1) & torch.isfinite(y).all(-1)
    f = finite[:, None]
    x = torch.where(f, x, torch.zeros_like(x))
    y = torch.where(f, y, torch.zeros_like(y))
    mu_col = admm._mu_col(mus)
    cx = srb.constraint_matvec(x, mu_col)
    z = torch.clamp(cx, ops["lb"], ops["ub"])
    prim = admm._amax(cx - z)
    dual = admm._amax(admm._bmv(qps.hessian, x) + qps.gradient
                      + srb.constraint_rmatvec(y, mu_col))
    big = torch.full_like(prim, 1e6)
    sol = admm.ADMMSolution(x=x, y=y, z=z, rho=warms.rho,
                            primal_res=torch.where(finite, prim, big),
                            dual_res=torch.where(finite, dual, big))
    return sol, admm.WarmState(x=x, y=y, rho=warms.rho, minv=ops["minv"])

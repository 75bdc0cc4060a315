"""Batched ADMM QP solver with OSQP semantics: the controller's main path.

Port of the main-path subset of the JAX package's ``ops/admm.py``: the
warm tick over a lazy condensed QP (:func:`solve_warm_fused`) and the
segmented transition solve (:func:`solve_segmented_fused`). Every tensor
carries a leading batch axis ``B``; per-scenario scalars (cost, rho) are
(B,) tensors. The friction-pyramid constraint matrix is never
materialized (``srb.constraint_matvec`` / ``_rmatvec``).

Every KKT inverse comes from the fused-KKT kernel K1 through
``kkt_schulz.kkt_schulz``: the CUDA kernel for float32 CUDA tensors, its
plain PyTorch version for CPU tensors. The (n, n) KKT is never
materialized on the card. ``ADMMSettings.schulz_impl`` keeps the JAX
package's names ("auto", "pallas", "xla") so that settings carry over;
all three take that one route.
"""

import functools
from typing import NamedTuple

import torch

from go1_qp_mpc_controller_torch.config import params as P
from go1_qp_mpc_controller_torch.models import srb
from go1_qp_mpc_controller_torch.ops import kkt_schulz


class ADMMSettings(NamedTuple):
    """Solver hyperparameters; same fields and defaults as the JAX
    package's ``ADMMSettings`` (its docstring records the measurements
    behind each). Only the fused lazy-QP programs are ported: settings
    with ``polish=True`` or ``refine_f64=True`` need the dense solve,
    which raises ``NotImplementedError`` in the controller."""
    seg_iters: int = 50
    segments: int = 4
    first_seg_iters: int = 0
    adapt_factor_max: float = 100.0
    adapt_warm_rho: bool = False
    rho: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    rho_eq_scale: float = 1e3   # rho boost for lb == ub rows
    rho_min: float = 1e-3
    rho_max: float = 1e3
    adapt_tol: float = 1e-5
    polish: bool = True
    polish_rho: float = 1e3
    polish_iters: int = 2
    refine_f64: bool = False
    kkt_solver: str = "schulz"
    polish_solver: str = "chol"
    schulz_iters: int = 20
    schulz_refine: int = 6
    schulz_hi_tail: int = 2
    schulz_tile: int = 8
    schulz_l0: float = 0.0
    schulz_l0_first: float = 0.0
    schulz_l0_refine: float = 0.0
    schulz_impl: str = "xla"


class WarmState(NamedTuple):
    """Cross-tick solver carry (A1RobotControl.cpp:522-540).

    Attributes:
      x: (B, n) primal warm start.
      y: (B, m) dual warm start (unscaled units).
      rho: (B,) adapted step size.
      minv: (B, n, n) KKT inverse from the previous tick.
    """
    x: torch.Tensor
    y: torch.Tensor
    rho: torch.Tensor
    minv: torch.Tensor


class ADMMSolution(NamedTuple):
    x: torch.Tensor           # (B, n) primal solution
    y: torch.Tensor           # (B, m) dual solution
    z: torch.Tensor           # (B, m) projected constraint values
    rho: torch.Tensor         # (B,) final rho
    primal_res: torch.Tensor  # (B,) max |Cx - z|
    dual_res: torch.Tensor    # (B,) max |Px + q + C'y|


@functools.lru_cache(maxsize=None)
def _scaled_schulz_coeffs(l0, tail=2, margin=1e-3):
    """Endpoint-balanced scaled Newton-Schulz coefficient schedule.

    The scaled step X <- a X (2I - a M X) with a = 2 / (l + u) maps the
    spectral interval [l, u] of M_b X to [4lu/(l+u)^2, 1], quadrupling the
    lower edge per step; the schedule is computed for a worst-case lower
    edge ``l0`` and ends with ``tail`` plain steps. ``margin`` inflates the
    top edge above the product noise (see the JAX package's docstring for
    the measured hazards). Copied from the JAX package; a test holds the
    tuples equal.
    """
    l, u = float(l0), 1.0 / 1.05
    coeffs = []
    while l < 0.99 and len(coeffs) < 60:
        u_eff = u * (1.0 + margin) if coeffs else u
        coeffs.append(2.0 / (l + u_eff))
        l = 4.0 * l * u_eff / ((l + u_eff) ** 2)
        u = 1.0
    return tuple(coeffs) + (1.0,) * tail


def _schulz_inverse(m_mat, iters, x0=None, coeffs=None):
    """Newton-Schulz inverse of (B, n, n) SPD matrices on the
    Jacobi-balanced matrix, with the basin-safeguarded warm start."""
    if coeffs is None:
        coeffs = (1.0,) * iters
    return kkt_schulz.schulz_balanced_plain(m_mat, x0, coeffs)


def _pyramid_band_diags(w, mu):
    """The three diagonals (B, n) of C' diag(w) C for the friction
    pyramid: main, the (3k+1, 3k+2) yz coupling at its minimum index, and
    the (3k, 3k+2) xz coupling."""
    wb = w.reshape(w.shape[:-1] + (-1, 5))
    w0, w1, w2, w3, w4 = wb.unbind(-1)
    zero = torch.zeros_like(w0)
    flat = lambda parts: torch.stack(parts, dim=-1).reshape(w.shape[:-1]
                                                            + (-1,))
    main = flat([w0 + w1, w2 + w3, mu * mu * (w0 + w1 + w2 + w3) + w4])
    off1 = flat([zero, mu * (w2 - w3), zero])
    off2 = flat([mu * (w0 - w1), zero, zero])
    return main, off1, off2


def _kkt_kernel_operands(lazy, rho_vec, sigma, mu):
    """(tiled4, dmain, off1, off2, cost) for K1.

    cost = 1 / max diag(H): for the PSD condensed Hessian max|H_ij| <=
    max_i H_ii, so this equals the max|H| normalization without
    materializing H. dmain carries everything of M's diagonal except H's
    own (which the kernel's quadrant build contributes)."""
    h_diag = srb.lazy_hessian_diag(lazy)
    cost = 1.0 / torch.clamp(torch.amax(h_diag, dim=-1), min=1e-12)
    main, off1, off2 = _pyramid_band_diags(rho_vec, mu)
    dmain = cost[:, None] * lazy.r_diag + sigma + main
    return (lazy.tiled[:, :, 0].contiguous(), dmain.contiguous(),
            off1.contiguous(), off2.contiguous(), cost.contiguous())


def _resolved_impl(settings):
    """Check ``schulz_impl``: "auto", "pallas" and "xla" (the JAX
    package's names) all take K1 through ``kkt_schulz.kkt_schulz``, which
    launches the CUDA kernel on float32 CUDA tensors, takes the plain
    version on CPU tensors and raises on any other input."""
    if settings.schulz_impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown schulz_impl {settings.schulz_impl!r}")


def _bounds(lazy):
    """(eq, lb_f, ub_f): equality rows and the finite-clipped bounds."""
    eq = torch.isclose(lazy.lb, lazy.ub)
    big = torch.finfo(lazy.lb.dtype).max / 8
    return eq, torch.clamp(lazy.lb, min=-big), torch.clamp(lazy.ub, max=big)


def _rho_vec(eq, rho, settings):
    return torch.where(eq, (rho * settings.rho_eq_scale)[:, None],
                       rho[:, None])


def _admm_iterations(minv, x, z, y, qbar, lb_f, ub_f, rho_vec, iters,
                     settings, matvec, rmatvec):
    """``iters`` ADMM iterations on the carried inverse (the JAX
    package's fori_loop body)."""
    alpha = settings.alpha
    sigma = settings.sigma
    for _ in range(iters):
        rhs = sigma * x - qbar + rmatvec(rho_vec * z - y)
        x_t = (minv @ rhs[..., None])[..., 0]
        z_t = matvec(x_t)
        x_new = alpha * x_t + (1.0 - alpha) * x
        z_mid = alpha * z_t + (1.0 - alpha) * z
        z = torch.clamp(z_mid + y / rho_vec, lb_f, ub_f)
        y = y + rho_vec * (z_mid - z)
        x = x_new
    return x, z, y


def _amax(a):
    return torch.amax(torch.abs(a), dim=-1)


def _finite_latch(x, y, z):
    """Zero the iterates of non-finite scenarios; returns the mask too."""
    finite = torch.isfinite(x).all(-1) & torch.isfinite(y).all(-1)
    f = finite[:, None]
    return (finite, torch.where(f, x, torch.zeros_like(x)),
            torch.where(f, y, torch.zeros_like(y)),
            torch.where(f, z, torch.zeros_like(z)))


def _warm_finish(minv, hessian, gradient, cost, qbar, lb_f, ub_f, rho,
                 rho_vec, matvec, rmatvec, warm, settings):
    """Warm-tick tail: fixed ADMM iterations, NaN latch, residuals and the
    optional end-of-tick rho adaptation. ``hessian`` is a matvec callable
    v -> H v."""
    x = warm.x
    y = warm.y * cost[:, None]
    z = torch.clamp(matvec(x), lb_f, ub_f)
    x, z, y = _admm_iterations(minv, x, z, y, qbar, lb_f, ub_f, rho_vec,
                               settings.seg_iters, settings, matvec,
                               rmatvec)
    finite, x, y, z = _finite_latch(x, y, z)

    y_out = y / cost[:, None]
    cx = matvec(x)
    cty = rmatvec(y_out)
    px = hessian(x)
    primal = _amax(cx - z)
    dual = _amax(px + gradient + cty)
    big = torch.full_like(primal, 1e6)
    sol = ADMMSolution(x=x, y=y_out, z=z, rho=rho,
                       primal_res=torch.where(finite, primal, big),
                       dual_res=torch.where(finite, dual, big))
    rho_out = rho
    minv_out = minv
    if settings.adapt_warm_rho:
        # OSQP's residual-ratio adaptation at tick cadence; deadband on the
        # raw ratio, then clip; the carried inverse is rescaled by the
        # rho ratio
        eps = 1e-15
        prim_rel = primal / torch.clamp(torch.maximum(_amax(cx), _amax(z)),
                                        min=eps)
        dual_rel = dual / torch.clamp(
            torch.maximum(_amax(px), torch.maximum(_amax(gradient),
                                                   _amax(cty))), min=eps)
        raw = torch.sqrt(prim_rel / torch.clamp(dual_rel, min=eps))
        fmax = settings.adapt_factor_max
        one = torch.ones_like(raw)
        factor = torch.where((raw > 5.0) | (raw < 0.2),
                             torch.clamp(raw, 1.0 / fmax, fmax), one)
        factor = torch.where(torch.maximum(prim_rel, dual_rel)
                             > settings.adapt_tol, factor, one)
        factor = torch.where(finite, factor, one)
        rho_out = torch.clamp(rho * factor, settings.rho_min,
                              settings.rho_max)
        minv_out = minv * (rho / rho_out)[:, None, None]
    return sol, WarmState(x=x, y=y_out, rho=rho_out, minv=minv_out)


def solve_warm_fused(lazy, warm, settings, mu):
    """Warm tick over a LazyCondensedQP: refine the carried KKT inverse
    (K1, warm variant: ``schulz_refine`` plain steps, or the scaled
    ``schulz_l0_refine`` schedule for the robust tick), then one fixed
    ADMM segment. The Hessian is never materialized.

    Returns:
      (ADMMSolution, next WarmState).
    """
    hess = functools.partial(srb.lazy_hessian_matvec, lazy)
    eq, lb_f, ub_f = _bounds(lazy)
    matvec = functools.partial(srb.constraint_matvec, mu=mu)
    rmatvec = functools.partial(srb.constraint_rmatvec, mu=mu)
    rho = warm.rho
    rho_vec = _rho_vec(eq, rho, settings)
    coeffs = (_scaled_schulz_coeffs(settings.schulz_l0_refine)
              if settings.schulz_l0_refine > 0
              else (1.0,) * settings.schulz_refine)
    _resolved_impl(settings)
    tiled4, dmain, off1, off2, cost = _kkt_kernel_operands(
        lazy, rho_vec, settings.sigma, mu)
    minv = kkt_schulz.kkt_schulz(tiled4, dmain, off1, off2, cost,
                                 x0=warm.minv, coeffs=coeffs)
    qbar = cost[:, None] * lazy.gradient
    return _warm_finish(minv, hess, lazy.gradient, cost, qbar, lb_f, ub_f,
                        rho, rho_vec, matvec, rmatvec, warm, settings)


def mpc_solve_warm_fused(lazy_qp, warm, settings=ADMMSettings(), mu=None):
    """Warm-tick MPC solve over a LazyCondensedQP (:func:`solve_warm_fused`)."""
    mu = P.MPC_MU if mu is None else mu
    return solve_warm_fused(lazy_qp, warm, settings, mu)


def solve_segmented_fused(lazy, settings, mu, warm):
    """Segmented transition solve over a LazyCondensedQP.

    The mathematics of the JAX package's dense ``solve`` (warm-started
    primal/dual, per-segment KKT refactorization at the adapting rho,
    OSQP's inter-segment residual-ratio rule) on the lazy factors: each
    segment's inverse comes from K1 — the first segment cold, later ones
    warm from the rho-rescaled previous inverse. The carried minv is not
    consumed (a transition changed the equality pattern).

    Returns:
      (ADMMSolution, WarmState).
    """
    if settings.polish:
        raise ValueError("solve_segmented_fused does not implement polish")
    eq, lb_f, ub_f = _bounds(lazy)
    matvec = functools.partial(srb.constraint_matvec, mu=mu)
    rmatvec = functools.partial(srb.constraint_rmatvec, mu=mu)
    hess_mv = functools.partial(srb.lazy_hessian_matvec, lazy)
    h_diag = srb.lazy_hessian_diag(lazy)
    cost = 1.0 / torch.clamp(torch.amax(h_diag, dim=-1), min=1e-12)
    qbar = cost[:, None] * lazy.gradient
    sigma = settings.sigma
    _resolved_impl(settings)

    x = warm.x
    y = warm.y * cost[:, None]
    rho = warm.rho
    z = torch.clamp(matvec(x), lb_f, ub_f)
    minv = None
    rho_of_minv = rho
    eps = 1e-15
    for k in range(settings.segments):
        iters_k = (settings.first_seg_iters
                   if (k == 0 and settings.first_seg_iters > 0)
                   else settings.seg_iters)
        rho_vec = _rho_vec(eq, rho, settings)
        if k == 0:
            l0 = settings.schulz_l0_first or settings.schulz_l0
        else:
            l0 = settings.schulz_l0_refine or settings.schulz_l0
        coeffs = (_scaled_schulz_coeffs(l0) if l0 > 0
                  else (1.0,) * settings.schulz_iters)
        if minv is not None:
            minv = minv * (rho_of_minv / rho)[:, None, None]
        tiled4, dmain, off1, off2, cost_k = _kkt_kernel_operands(
            lazy, rho_vec, sigma, mu)
        minv = kkt_schulz.kkt_schulz(tiled4, dmain, off1, off2, cost_k,
                                     x0=minv, coeffs=coeffs)
        rho_of_minv = rho
        x, z, y = _admm_iterations(minv, x, z, y, qbar, lb_f, ub_f,
                                   rho_vec, iters_k, settings, matvec,
                                   rmatvec)

        # OSQP inter-segment adaptation
        cx = matvec(x)
        prim = _amax(cx - z) / torch.clamp(torch.maximum(_amax(cx),
                                                         _amax(z)), min=eps)
        px = cost[:, None] * hess_mv(x)
        cty = rmatvec(y)
        dual = (_amax(px + qbar + cty)
                / torch.clamp(torch.maximum(
                    _amax(px), torch.maximum(_amax(qbar), _amax(cty))),
                    min=eps))
        factor = torch.sqrt(prim / torch.clamp(dual, min=eps))
        fmax = settings.adapt_factor_max
        factor = torch.clamp(factor, 1.0 / fmax, fmax)
        one = torch.ones_like(factor)
        factor = torch.where((factor > 5.0) | (factor < 0.2), factor, one)
        factor = torch.where(torch.maximum(prim, dual) > settings.adapt_tol,
                             factor, one)
        rho = torch.clamp(rho * factor, settings.rho_min, settings.rho_max)

    finite, x, y, z = _finite_latch(x, y, z)
    y_out = y / cost[:, None]
    primal = _amax(matvec(x) - z)
    dual_r = _amax(hess_mv(x) + lazy.gradient + rmatvec(y_out))
    big = torch.full_like(primal, 1e6)
    sol = ADMMSolution(x=x, y=y_out, z=z, rho=rho,
                       primal_res=torch.where(finite, primal, big),
                       dual_res=torch.where(finite, dual_r, big))
    minv_out = minv * (rho_of_minv / rho)[:, None, None]
    return sol, WarmState(x=x, y=y_out, rho=rho, minv=minv_out)

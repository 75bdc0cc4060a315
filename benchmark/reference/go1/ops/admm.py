"""Batched ADMM QP solver with OSQP semantics, plain PyTorch in the
input's dtype. Every tensor carries a leading batch axis ``B``;
per-scenario scalars (cost, rho) are (B,) tensors, and every max, residual
and acceptance test is per scenario. The friction-pyramid constraint
matrix is never materialized (``srb.constraint_matvec`` / ``_rmatvec``); a
friction coefficient is a number or a (B,) tensor.

Two families of programs:

- on a lazy condensed QP (``srb.LazyCondensedQP``): the warm tick
  (:func:`solve_warm_fused`) and the segmented transition solve
  (:func:`solve_segmented_fused`), their KKT inverses from K1's plain
  version (``kkt_schulz.kkt_schulz``);
- on a dense QP: :func:`solve` (segmented, with the optional active-set
  polish and float64 refinement) and its MPC wrapper, the "schulz" KKT
  inverses from K3's plain version (``schulz_batch``); "chol" and "inv"
  are library factorizations that flag a failed scenario with NaN.

The ADMM loop on the friction pyramid with a carried inverse is K6's plain
version (``admm_iterations.admm_loop``). The names K1-K6 are the
program's kernels, whose plain versions these are.
"""

import functools
from typing import NamedTuple

import torch

from reference.go1.config import params as P
from reference.go1.models import srb
from reference.go1.ops import admm_iterations, kkt_schulz, schulz_batch


class ADMMSettings(NamedTuple):
    """Solver hyperparameters; same fields and defaults as the JAX
    package's ``ADMMSettings`` (its docstring records the measurements
    behind each). ``polish`` and ``refine_f64`` apply to the dense
    :func:`solve`; ``refine_f64`` always refines in float64 (torch has no
    global 64-bit switch to forget)."""
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


def _schulz_inverse(m_mat, iters, x0=None, coeffs=None, hi_tail=2):
    """Newton-Schulz inverse of (B, n, n) UNBALANCED SPD matrices on the
    Jacobi-balanced matrix, with the basin-safeguarded warm start ``x0``:
    ``coeffs`` (a scaled schedule) or else ``iters`` plain steps, the last
    ``hi_tail`` of them in full FP32 on the card (the solvers pass
    ``ADMMSettings.schulz_hi_tail``, as the JAX package's Pallas route
    does). Runs on K3 (``schulz_batch.schulz_inverse_batch``). Also the
    JAX package's ``_schulz_refine_warm`` (``iters`` plain steps from the
    carried inverse)."""
    if coeffs is None:
        coeffs = (1.0,) * iters
    return schulz_batch.schulz_inverse_batch(m_mat, x0, coeffs,
                                             hi_tail=hi_tail)


def _mu_col(mu):
    """A (B,) per-scenario friction coefficient as a (B, 1) column, which
    broadcasts against the (B, 40) per-leg planes of the pyramid
    operators; a number stays as it is."""
    return mu[:, None] if torch.is_tensor(mu) and mu.dim() == 1 else mu


def _bmv(a, v):
    """Batched matrix-vector product (B, n, k) x (B, k) -> (B, n)."""
    return (a @ v[..., None])[..., 0]


def _minv_solve(minv):
    """The KKT solve rhs -> minv rhs on a carried inverse."""
    return functools.partial(_bmv, minv)


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
    package's names) all take K1's plain version
    (``kkt_schulz.kkt_schulz``)."""
    if settings.schulz_impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown schulz_impl {settings.schulz_impl!r}")


def _bounds(lb, ub):
    """(eq, lb_f, ub_f): equality rows and the finite-clipped bounds."""
    eq = torch.isclose(lb, ub)
    big = torch.finfo(lb.dtype).max / 8
    return eq, torch.clamp(lb, min=-big), torch.clamp(ub, max=big)


def _rho_vec(eq, rho, settings):
    return torch.where(eq, (rho * settings.rho_eq_scale)[:, None],
                       rho[:, None])


def _admm_iterations(kkt_solve, x, z, y, qbar, lb_f, ub_f, rho_vec, iters,
                     alpha, sigma, matvec, rmatvec):
    """``iters`` ADMM iterations (the JAX package's fori_loop body);
    ``kkt_solve`` maps rhs -> M^-1 rhs (:func:`_minv_solve` on a carried
    inverse). The plain version of kernel K6 (``ops/admm_iterations.py``)
    on the friction pyramid; on the card it runs only for other
    constraint operators (the balance QP) or the "chol" KKT solver, which
    carries no inverse."""
    for _ in range(iters):
        rhs = sigma * x - qbar + rmatvec(rho_vec * z - y)
        x_t = kkt_solve(rhs)
        z_t = matvec(x_t)
        x_new = alpha * x_t + (1.0 - alpha) * x
        z_mid = alpha * z_t + (1.0 - alpha) * z
        z = torch.clamp(z_mid + y / rho_vec, lb_f, ub_f)
        y = y + rho_vec * (z_mid - z)
        x = x_new
    return x, z, y


def _amax(a):
    return torch.amax(torch.abs(a), dim=-1)


def _adapted_rho(rho, x, z, y, qbar, px, matvec, rmatvec, settings):
    """OSQP's inter-segment rule on scaled quantities (px = P x): rho
    times sqrt(relative primal / relative dual residual), clipped to
    adapt_factor_max, applied only outside the (0.2, 5) deadband and
    while either residual exceeds adapt_tol, then clipped to
    [rho_min, rho_max]."""
    eps = 1e-15
    cx = matvec(x)
    prim = _amax(cx - z) / torch.clamp(torch.maximum(_amax(cx), _amax(z)),
                                       min=eps)
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
    return torch.clamp(rho * factor, settings.rho_min, settings.rho_max)


def _finite_latch(x, y, z):
    """Zero the iterates of non-finite scenarios; returns the mask too."""
    finite = torch.isfinite(x).all(-1) & torch.isfinite(y).all(-1)
    f = finite[:, None]
    return (finite, torch.where(f, x, torch.zeros_like(x)),
            torch.where(f, y, torch.zeros_like(y)),
            torch.where(f, z, torch.zeros_like(z)))


def _iterate(minv, x, z, y, qbar, lb_f, ub_f, rho_vec, iters, settings, mu,
             matvec, rmatvec):
    """``iters`` ADMM iterations on a carried inverse: on the friction
    pyramid (``mu`` given) through K6 (``admm_iterations.admm_loop``),
    otherwise the plain loop on ``matvec`` / ``rmatvec``."""
    if mu is not None:
        return admm_iterations.admm_loop(minv, qbar, lb_f, ub_f, rho_vec, mu,
                                         x, z, y, iters, settings.alpha,
                                         settings.sigma)
    return _admm_iterations(_minv_solve(minv), x, z, y, qbar, lb_f, ub_f,
                            rho_vec, iters, settings.alpha, settings.sigma,
                            matvec, rmatvec)


def _warm_finish(minv, hessian, gradient, cost, qbar, lb_f, ub_f, rho,
                 rho_vec, matvec, rmatvec, warm, settings, mu):
    """Warm-tick tail: fixed ADMM iterations (:func:`_iterate`; ``mu`` is
    the pyramid's friction, None for another operator), NaN latch,
    residuals and the optional end-of-tick rho adaptation. ``hessian`` is
    a matvec callable v -> H v."""
    x = warm.x
    y = warm.y * cost[:, None]
    z = torch.clamp(matvec(x), lb_f, ub_f)
    x, z, y = _iterate(minv, x, z, y, qbar, lb_f, ub_f, rho_vec,
                       settings.seg_iters, settings, mu, matvec, rmatvec)
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
    mu = _mu_col(mu)
    hess = functools.partial(srb.lazy_hessian_matvec, lazy)
    eq, lb_f, ub_f = _bounds(lazy.lb, lazy.ub)
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
                                 x0=warm.minv, coeffs=coeffs,
                                 hi_tail=settings.schulz_hi_tail)
    qbar = cost[:, None] * lazy.gradient
    return _warm_finish(minv, hess, lazy.gradient, cost, qbar, lb_f, ub_f,
                        rho, rho_vec, matvec, rmatvec, warm, settings, mu)


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
        raise ValueError("solve_segmented_fused does not implement polish; "
                         "use mpc_solve on the dense QP")
    mu = _mu_col(mu)
    eq, lb_f, ub_f = _bounds(lazy.lb, lazy.ub)
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
                                     x0=minv, coeffs=coeffs,
                                     hi_tail=settings.schulz_hi_tail)
        rho_of_minv = rho
        x, z, y = _iterate(minv, x, z, y, qbar, lb_f, ub_f, rho_vec,
                           iters_k, settings, mu, matvec, rmatvec)
        rho = _adapted_rho(rho, x, z, y, qbar,
                           cost[:, None] * hess_mv(x), matvec, rmatvec,
                           settings)

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


# ------------------------- the dense solver ---------------------------------

def _pyramid_ctc_dense(w, mu):
    """C' diag(w) C (B, n, n) for the friction pyramid: a 3x3 block per
    (step, leg) on three strided diagonals."""
    return kkt_schulz.band_matrix(*_pyramid_band_diags(w, mu))


def _pyramid_kkt_fused(pbar, sigma, w, mu):
    """M = pbar + sigma I + C' diag(w) C for the friction pyramid."""
    main, off1, off2 = _pyramid_band_diags(w, mu)
    return pbar + kkt_schulz.band_matrix(main + sigma, off1, off2)


def _nan_where_failed(mat, info):
    """NaN out the scenarios whose factorization reported failure, as JAX's
    cholesky / inv return NaN there: the solve's non-finite latch or the
    polish acceptance test then handles them, and nothing waits for the
    device to check ``info``."""
    return torch.where((info != 0)[:, None, None],
                       torch.full_like(mat, float("nan")), mat)


def _make_kkt_solve(m_mat, settings, warm_minv=None, solver=None):
    """(kkt_solve, carry_minv) for the configured ``kkt_solver`` on the
    (B, n, n) KKT: "chol" (factor + two triangular solves per
    application, no carried inverse), "inv" (library inverse) or "schulz"
    (K3 on the full ``schulz_iters`` schedule even from a warm start: a
    basin-rejected start restarts cold and needs all of it; the scaled
    edge is ``schulz_l0_refine`` with a warm start and ``schulz_l0_first``
    without one, else ``schulz_l0``)."""
    solver = settings.kkt_solver if solver is None else solver
    if solver == "chol":
        chol, info = torch.linalg.cholesky_ex(m_mat)
        chol = _nan_where_failed(chol, info)

        def solve_fn(rhs):
            w = torch.linalg.solve_triangular(chol, rhs[..., None],
                                              upper=False)
            return torch.linalg.solve_triangular(
                chol.transpose(-1, -2), w, upper=True)[..., 0]

        return solve_fn, None
    if solver == "inv":
        minv, info = torch.linalg.inv_ex(m_mat)
        minv = _nan_where_failed(minv, info)
    elif solver == "schulz":
        _resolved_impl(settings)
        l0 = settings.schulz_l0
        if warm_minv is not None and settings.schulz_l0_refine > 0:
            l0 = settings.schulz_l0_refine
        elif warm_minv is None and settings.schulz_l0_first > 0:
            l0 = settings.schulz_l0_first
        coeffs = _scaled_schulz_coeffs(l0) if l0 > 0 else None
        minv = _schulz_inverse(m_mat, settings.schulz_iters, warm_minv,
                               coeffs, settings.schulz_hi_tail)
    else:
        raise ValueError(f"unknown kkt solver {solver!r}")
    return _minv_solve(minv), minv


def solve(hessian, gradient, lb, ub, matvec, rmatvec, rmatvec_dense,
          settings, warm_x=None, warm_y=None, warm_rho=None,
          return_warm=False, kkt_fused=None, mu=None):
    """Solve min 1/2 x'Px + q'x s.t. lb <= Cx <= ub for a batch of QPs.

    Cost scaling |P| -> 1, then ``segments`` ADMM segments, each on a KKT
    factorized at the current rho (the inverse carried across segments,
    rescaled by the rho ratio) followed by OSQP's residual-ratio rho
    adaptation; then the optional active-set polish and float64
    refinement, and the per-scenario non-finite latch.

    Args:
      hessian, gradient: (B, n, n), (B, n).
      lb, ub: (B, m) bounds; equality rows encoded as lb == ub.
      matvec: u (B, n) -> C u (B, m); rmatvec: y (B, m) -> C' y (B, n);
        both must accept float64 operands (``refine_f64``).
      rmatvec_dense: w (B, m) -> C' diag(w) C (B, n, n).
      warm_x, warm_y, warm_rho: optional warm starts ((B, n), (B, m)
        unscaled, (B,)).
      return_warm: also return the WarmState carry, which keeps the
        pre-polish ADMM iterates and the last inverse rescaled to the
        final rho (identity when the solver carries none).
      kkt_fused: optional (pbar, sigma, rho_vec) -> M, the KKT matrix.
      mu: the friction coefficient when C is the MPC friction pyramid
        (``mpc_solve`` passes it): segments on a carried inverse then run
        on K6.

    Returns:
      ADMMSolution (duals unscaled), and the WarmState with return_warm.
    """
    batch, n = gradient.shape
    m = lb.shape[-1]
    dtype, device = gradient.dtype, gradient.device
    eye_n = torch.eye(n, dtype=dtype, device=device)

    cost = 1.0 / torch.clamp(torch.amax(torch.abs(hessian), dim=(-2, -1)),
                             min=1e-12)
    pbar = cost[:, None, None] * hessian
    qbar = cost[:, None] * gradient
    eq, lb_f, ub_f = _bounds(lb, ub)
    alpha, sigma = settings.alpha, settings.sigma

    x = (torch.zeros((batch, n), dtype=dtype, device=device)
         if warm_x is None else warm_x)
    y = (torch.zeros((batch, m), dtype=dtype, device=device)
         if warm_y is None else warm_y * cost[:, None])
    rho = (torch.full((batch,), settings.rho, dtype=dtype, device=device)
           if warm_rho is None else warm_rho)
    z = torch.clamp(matvec(x), lb_f, ub_f)

    minv = None
    rho_of_minv = rho
    for k in range(settings.segments):
        iters_k = (settings.first_seg_iters
                   if (k == 0 and settings.first_seg_iters > 0)
                   else settings.seg_iters)
        rho_vec = _rho_vec(eq, rho, settings)
        if kkt_fused is not None:
            m_mat = kkt_fused(pbar, sigma, rho_vec)
        else:
            m_mat = pbar + sigma * eye_n + rmatvec_dense(rho_vec)
        if minv is not None:
            # M scales ~ rho where the constraint term dominates
            minv = minv * (rho_of_minv / rho)[:, None, None]
        kkt_solve, minv = _make_kkt_solve(m_mat, settings, minv)
        rho_of_minv = rho
        if minv is None:            # "chol": no inverse to carry
            x, z, y = _admm_iterations(kkt_solve, x, z, y, qbar, lb_f, ub_f,
                                       rho_vec, iters_k, alpha, sigma,
                                       matvec, rmatvec)
        else:
            x, z, y = _iterate(minv, x, z, y, qbar, lb_f, ub_f, rho_vec,
                               iters_k, settings, mu, matvec, rmatvec)
        rho = _adapted_rho(rho, x, z, y, qbar, _bmv(pbar, x), matvec,
                           rmatvec, settings)

    # polish and refinement post-process the returned solution; the warm
    # carry keeps the raw ADMM iterates (polish zeroes inactive duals)
    x_admm, y_admm = x, y
    if settings.polish:
        x, y = _polish(pbar, qbar, lb, ub, lb_f, ub_f, eq, matvec, rmatvec,
                       rmatvec_dense, x, y, settings)
        z = torch.clamp(matvec(x), lb_f, ub_f)
    if settings.refine_f64 and dtype != torch.float64:
        f64 = torch.float64
        x64, y64 = _polish(
            pbar.to(f64), qbar.to(f64), lb.to(f64), ub.to(f64),
            lb_f.to(f64), ub_f.to(f64), eq, matvec, rmatvec,
            lambda w: rmatvec_dense(w.to(dtype)).to(f64),
            x.to(f64), y.to(f64),
            settings._replace(polish_iters=4, polish_solver="inv"))
        x, y = x64.to(dtype), y64.to(dtype)
        z = torch.clamp(matvec(x), lb_f, ub_f)

    finite, x, y, z = _finite_latch(x, y, z)
    y_out = y / cost[:, None]
    primal = _amax(matvec(x) - z)
    dual = _amax(_bmv(hessian, x) + gradient + rmatvec(y_out))
    big = torch.full_like(primal, 1e6)
    sol = ADMMSolution(x=x, y=y_out, z=z, rho=rho,
                       primal_res=torch.where(finite, primal, big),
                       dual_res=torch.where(finite, dual, big))
    if not return_warm:
        return sol
    if minv is None:
        minv_out = eye_n.expand(batch, n, n).clone()
    else:
        minv_out = minv * (rho_of_minv / rho)[:, None, None]
    f = finite[:, None]
    x_c = torch.where(f, x_admm, torch.zeros_like(x_admm))
    y_c = torch.where(f, y_admm / cost[:, None], torch.zeros_like(y_admm))
    return sol, WarmState(x=x_c, y=y_c, rho=rho, minv=minv_out)


def _polish(pbar, qbar, lb, ub, lb_f, ub_f, eq, matvec, rmatvec,
            rmatvec_dense, x, y, settings):
    """Masked active-set refinement (fixed-shape OSQP polish), per
    scenario: rows whose dual and iterate both say active, plus the
    equality rows, become equalities; ``polish_iters`` augmented-Lagrangian
    passes solve the restricted problem on its own KKT
    (``polish_solver``); the result is kept only where it stayed feasible
    and did not raise the objective. Scaled quantities in, scaled dual
    out."""
    dtype = x.dtype
    n = x.shape[-1]
    delta = 1e-6 * torch.clamp(_amax(y), min=1.0)[:, None]
    cx = matvec(x)
    scale_b = 1.0 + torch.maximum(torch.abs(lb_f), torch.abs(ub_f))
    near_lb = (cx - lb_f) < 1e-3 * scale_b
    near_ub = (ub_f - cx) < 1e-3 * scale_b
    act_low = (y < -delta) & torch.isfinite(lb) & near_lb
    act_up = (y > delta) & torch.isfinite(ub) & near_ub
    act = act_low | act_up | eq
    d = act.to(dtype)
    bvals = torch.where(act_up, ub_f, lb_f) * d

    rho_p = settings.polish_rho
    eye_n = torch.eye(n, dtype=dtype, device=x.device)
    m_mat = pbar + settings.sigma * eye_n + rmatvec_dense(rho_p * d)
    kkt_solve, _ = _make_kkt_solve(m_mat, settings, None,
                                   solver=settings.polish_solver)
    x_p, nu = x, torch.zeros_like(y)
    for _ in range(settings.polish_iters):
        rhs = -qbar + rmatvec(d * (rho_p * bvals - nu))
        x_p = kkt_solve(rhs + settings.sigma * x_p)
        nu = nu + rho_p * d * (matvec(x_p) - bvals)

    def viol(v):
        cv = matvec(v)
        return torch.maximum(torch.amax(cv - ub_f, dim=-1),
                             torch.amax(lb_f - cv, dim=-1))

    def obj(v):
        return (0.5 * torch.sum(v * _bmv(pbar, v), dim=-1)
                + torch.sum(qbar * v, dim=-1))

    tol = 1e-5 * (1.0 + _amax(bvals))
    obj_x = obj(x)
    obj_tol = 1e-6 * (1.0 + torch.abs(obj_x))
    ok = ((viol(x_p) <= torch.maximum(viol(x), tol))
          & (obj(x_p) <= obj_x + obj_tol))[:, None]
    return torch.where(ok, x_p, x), torch.where(ok, d * nu, y)


def mpc_solve(qp, settings=ADMMSettings(), warm_x=None, warm_y=None,
              warm_rho=None, mu=None, return_warm=False):
    """Solve a batch of condensed MPC QPs (``srb.CondensedQP``) with
    :func:`solve`."""
    mu = _mu_col(P.MPC_MU if mu is None else mu)
    return solve(qp.hessian, qp.gradient, qp.lb, qp.ub,
                 functools.partial(srb.constraint_matvec, mu=mu),
                 functools.partial(srb.constraint_rmatvec, mu=mu),
                 functools.partial(_pyramid_ctc_dense, mu=mu), settings,
                 warm_x=warm_x, warm_y=warm_y, warm_rho=warm_rho,
                 return_warm=return_warm,
                 kkt_fused=functools.partial(_pyramid_kkt_fused, mu=mu),
                 mu=mu)


"""K6's plain version: the fixed-iteration ADMM loop with the KKT inverse
held, on the flat (B, 120) / (B, 200) layout, the friction pyramid acting
per (step, leg) pair as in ``srb.constraint_matvec``."""

import functools

from reference.go1.models import srb
from reference.go1.ops import admm


def admm_loop(minv, qbar, lb, ub, rho_vec, mu, x, z, y, iters, alpha,
              sigma):
    """K6 from a carried ADMM iterate (x, z, y): the loop of the solver's
    segments and warm ticks on the friction pyramid: the plain loop
    ``admm._admm_iterations``.

    Args:
      minv: (B, 120, 120) KKT inverse; qbar: (B, 120) linear term;
        lb, ub, rho_vec: (B, 200).
      mu: friction coefficient, a number, (B,) or (B, 1).
      x, z, y: (B, 120), (B, 200), (B, 200) iterate (y scaled).

    Returns:
      (x, z, y) after ``iters`` iterations.
    """
    mu = admm._mu_col(mu)
    return admm._admm_iterations(
        admm._minv_solve(minv), x, z, y, qbar, lb, ub, rho_vec, iters,
        alpha, sigma, functools.partial(srb.constraint_matvec, mu=mu),
        functools.partial(srb.constraint_rmatvec, mu=mu))

"""K3's plain version: the Newton-Schulz inverse of already-built dense KKT
matrices, per scenario, in the input's dtype. For each matrix of an
UNBALANCED SPD batch (B, n, n) it Jacobi-balances the matrix, runs the
basin-safeguarded (scaled) Newton-Schulz schedule from the optional warm
start and returns the unbalanced inverse: K1's body (``kkt_schulz.py``)
without the KKT build. The dense solver's KKT solves reach it
(``admm._schulz_inverse``) at n = 120."""

from reference.go1.ops import kkt_schulz


def schulz_inverse_batch(m, x0=None, coeffs=(1.0,), hi_tail=None):
    """(B, n, n) unbalanced inverses of the unbalanced SPD matrices ``m``.

    Args:
      m: (B, n, n).
      x0: optional (B, n, n) unbalanced warm inverses (basin-safeguarded).
      coeffs: the step schedule, 0 to 64 steps (1.0 = plain Newton step).
      hi_tail: the program's FP32 tail; every product here runs in the
        input's dtype, so it changes nothing.
    """
    if len(coeffs) > kkt_schulz.MAX_COEFFS:
        raise ValueError(f"schulz_inverse_batch: schedule of {len(coeffs)} "
                         f"steps; at most {kkt_schulz.MAX_COEFFS} supported")
    return kkt_schulz.schulz_balanced_plain(m, x0, coeffs)

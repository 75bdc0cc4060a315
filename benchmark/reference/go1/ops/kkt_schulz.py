"""K1's plain version: the fused KKT build + Newton-Schulz inverse, per
scenario, in the input's dtype. For each scenario it

1. builds M = cost H + sigma I + C' diag(rho) C from the lazy Gram
   quadrants (``srb.LazyCondensedQP.tiled``) times the constant
   ``srb._NILP_COEFFS_E`` plus the three band diagonals,
2. Jacobi-balances M (M_b = S M S, S = diag(M)^-1/2),
3. with a warm start X0, runs the basin test on M_b X0_b (min diagonal
   > 1e-4 and max absolute row sum < 3): a passing scenario takes a plain
   Newton step from X0, a failing one the scaled cold step,
4. runs the rest of the coefficient schedule
   (``admm._scaled_schulz_coeffs``; scaled steps apply only to scenarios
   that did not accept their warm start),
5. returns the unbalanced inverse S X S.
"""

import torch

from reference.go1.models import srb

MAX_COEFFS = 64             # the longest schedule a solve runs


def default_hi_tail(coeffs, hi_tail=None):
    """The FP32 tail of a schedule: ``hi_tail`` (default 2), at most its
    length (``pallas_admm.schulz_inverse_kkt_batch``'s rule)."""
    return min(len(coeffs), 2 if hi_tail is None else hi_tail)


def band_matrix(main, off1, off2):
    """(B, n, n) symmetric band matrix from its diagonals: ``main``, then
    ``off1`` at +-1 and ``off2`` at +-2 (each stored at the smaller index;
    their last 1 and 2 entries are unused)."""
    return (torch.diag_embed(main)
            + torch.diag_embed(off1[..., :-1], 1)
            + torch.diag_embed(off1[..., :-1], -1)
            + torch.diag_embed(off2[..., :-2], 2)
            + torch.diag_embed(off2[..., :-2], -2))


def kkt_build_plain(tiled, dmain, off1, off2, cost):
    """Materialized (B, n, n) M = cost H + band (the kernel's build step).

    Args:
      tiled: (B, 4, 12, n) lazy Gram quadrants.
      dmain, off1, off2: (B, n) band diagonals; dmain holds everything of
        M's diagonal except H's own (cost r_diag + sigma + band main).
      cost: (B,) cost normalization 1 / max diag H.
    """
    batch, n = tiled.shape[0], tiled.shape[-1]
    coef = srb._const("coeffs_e", tiled)                   # (4, H, n)
    acc = coef[0][None, :, None, :] * tiled[:, 0][:, None]
    for k in range(1, 4):
        acc = acc + coef[k][None, :, None, :] * tiled[:, k][:, None]
    return (cost[:, None, None] * acc.reshape(batch, n, n)
            + band_matrix(dmain, off1, off2))


def schulz_balanced_core(mb, x0b=None, coeffs=(1.0,), hi_tail=None,
                         middle_matmul=None):
    """Basin-safeguarded (scaled) Newton-Schulz on already-balanced
    (B, n, n) matrices; returns the BALANCED inverse (the kernels' Schulz
    step, ``_schulz_batch_body`` between balance and unbalance).

    Args:
      mb: (B, n, n) Jacobi-balanced matrices.
      x0b: optional (B, n, n) balanced warm inverses.
      coeffs: per-step schedule (1.0 = plain Newton step). An empty
        schedule returns the warm start where it passes the basin test and
        the scalar cold init c I elsewhere (c I without a warm start).
      hi_tail, middle_matmul: with ``middle_matmul`` (e.g.
        :func:`matmul_3xtf32`), the steps before the last ``hi_tail``
        (default 2, at most the schedule's length) take both products
        from it; the basin test, the accepted warm step and the tail keep
        ``@``. Without it every product is ``@`` (the default).
    """
    n = mb.shape[-1]
    tail = min(len(coeffs), 2 if hi_tail is None else hi_tail)
    eye = torch.eye(n, dtype=mb.dtype, device=mb.device)
    eye2 = 2.0 * eye
    norminf = torch.amax(torch.sum(torch.abs(mb), dim=-1), dim=-1)
    c = (1.0 / (1.05 * norminf))[:, None, None]
    start = 0
    ok = None
    if x0b is not None:
        inner = mb @ x0b
        row_inner = torch.sum(torch.abs(inner), dim=-1)
        d = torch.diagonal(inner, dim1=-2, dim2=-1)
        # amin/amax propagate NaN like jnp.min/max: a NaN scenario fails
        ok = ((torch.amin(d, dim=-1) > 1e-4)
              & (torch.amax(row_inner, dim=-1) < 3.0))[:, None, None]
        if not coeffs:
            return torch.where(ok, x0b, c * eye)
        stepped = x0b @ (eye2 - inner)
        ac = coeffs[0] * c
        stepped_cold = ac * (eye2 - ac * mb)
        x = torch.where(ok, stepped, stepped_cold)
        start = 1
    elif coeffs:
        # the first step from the scalar cold init c I, folded (exact for
        # any coefficient, the plain a = 1 included): no product
        ac = coeffs[0] * c
        x = ac * (eye2 - ac * mb)
        start = 1
    else:
        x = c * eye
    for k in range(start, len(coeffs)):
        a = coeffs[k]
        mm = (middle_matmul if middle_matmul is not None
              and k < len(coeffs) - tail else torch.matmul)
        inner = mm(mb, x)
        if a == 1.0:
            x = mm(x, eye2 - inner)
        else:
            # scaled step X <- a X (2I - a M X); warm-accepted scenarios
            # run plain Newton (a = 1)
            aa = (a if ok is None
                  else torch.where(ok, 1.0, a).to(mb.dtype))
            x = mm(x, (2.0 * aa) * eye - (aa * aa) * inner)
    return x


def schulz_balanced_plain(m, x0=None, coeffs=(1.0,), hi_tail=None,
                          middle_matmul=None):
    """Balance + :func:`schulz_balanced_core` + unbalance on (B, n, n)
    UNBALANCED SPD matrices with optional unbalanced warm inverses: the
    plain PyTorch version of K3 (``ops/schulz_batch.py``), and K1's after
    the KKT build. ``hi_tail`` and ``middle_matmul`` as in
    :func:`schulz_balanced_core`."""
    s = torch.rsqrt(torch.diagonal(m, dim1=-2, dim2=-1))
    unb = s[:, :, None] * s[:, None, :]
    x0b = None if x0 is None else x0 / unb
    return schulz_balanced_core(m * unb, x0b, coeffs, hi_tail,
                                middle_matmul) * unb


def kkt_schulz_plain(tiled, dmain, off1, off2, cost, x0=None,
                     coeffs=(1.0,), hi_tail=None, middle_matmul=None):
    """Plain PyTorch version of K1 (the arguments of :func:`kkt_schulz`);
    ``hi_tail`` and ``middle_matmul`` as in :func:`schulz_balanced_core`
    (with ``middle_matmul=matmul_3xtf32``, the card's middle steps)."""
    m = kkt_build_plain(tiled, dmain, off1, off2, cost)
    return schulz_balanced_plain(m, x0, coeffs, hi_tail, middle_matmul)


def kkt_schulz(tiled, dmain, off1, off2, cost, x0=None, coeffs=(1.0,),
               hi_tail=None):
    """K1: (B, n, n) unbalanced inverses of
    cost H + sigma I + C' diag(rho) C (see the module docstring).

    Args:
      tiled: (B, 4, 12, 120); dmain, off1, off2: (B, 120); cost: (B,).
      x0: optional (B, 120, 120) unbalanced warm inverses.
      coeffs: the step schedule (1 to 64 steps).
      hi_tail: as in :func:`schulz_balanced_core` (default 2, at most
        the schedule's length); every product runs in the input's dtype.
    """
    if not 0 < len(coeffs) <= MAX_COEFFS:
        raise ValueError(f"kkt_schulz: schedule of {len(coeffs)} steps; "
                         f"1..{MAX_COEFFS} supported")
    return kkt_schulz_plain(tiled, dmain, off1, off2, cost, x0, coeffs,
                            default_hi_tail(coeffs, hi_tail))

"""Horizon-axis (sequence-parallel) sharding of the stagewise LQR sweeps.

Port of the JAX package's ``parallel/horizon.py``. The stagewise solver's
per-ADMM-iteration work is two affine recurrences over the horizon
(``ops/stagewise.py::_lqr_solve``). This module distributes them over a
process group (the mesh's ``mpc`` axis, ``parallel/mesh.py``):

- each rank holds H/n contiguous stages of the per-stage tensors,
- a local log-depth scan (``stagewise._affine_scan_maps``) composes the
  rank's affine maps,
- one ``all_gather`` of the n per-rank composites (13 x 13 + 13 a
  scenario) gives every rank the cross-rank prefix / suffix, applied
  locally: depth O(H/n + log(H/n) + n) instead of O(H).

The Riccati factorization stays replicated: it is a nonlinear recursion
with no affine composition, runs once a rho segment, and costs about two
LQR iterations. Tensors are batch first, as in ``ops/stagewise.py``.
"""

import torch
import torch.distributed as dist

from go1_qp_mpc_controller_torch.ops import stagewise

NX = stagewise.NX
_bmv = stagewise._bmv


def _gather(t, group):
    """(n, ...) stack of ``t`` from every rank of ``group``, rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def affine_scan_sharded(e_loc, f_loc, group, reverse=False):
    """Distributed inclusive affine scan over a sharded horizon axis.

    Equals ``stagewise._affine_scan(e, f, reverse)`` on the concatenated
    global tensors, with the horizon axis split in contiguous blocks over
    ``group`` (rank k holds stages [k s, (k + 1) s)).

    Args:
      e_loc: (B, s, 13, 13) local map matrices.
      f_loc: (B, s, 13) local offsets.
      group: the process group of the horizon axis.

    Returns:
      (B, s, 13) local slice of the global scan result.
    """
    k = dist.get_rank(group)
    loc_e, loc_f = stagewise._affine_scan_maps(e_loc, f_loc, reverse)
    # this rank's composite: the composition of all its local maps
    end = 0 if reverse else -1
    comp = torch.cat([loc_e[:, end].flatten(1), loc_f[:, end]], 1)
    comps = _gather(comp, group)                 # (n, B, 13 * 13 + 13)
    n = comps.shape[0]
    es = comps[..., :NX * NX].reshape(n, -1, NX, NX)
    fs = comps[..., NX * NX:]
    # the value entering this rank's block: the earlier ranks' composites
    # applied in turn from v = 0 (reverse: the later ranks', latest first)
    others = range(n - 1, k, -1) if reverse else range(k)
    v = torch.zeros_like(f_loc[:, 0])
    for j in others:
        v = _bmv(es[j], v) + fs[j]
    return _bmv(loc_e, v[:, None]) + loc_f


def lqr_solve_sharded(fac_loc, a_d, b_d_loc, g_loc, c_lin_loc, group):
    """Horizon-sharded affine LQR solve (== ``stagewise._lqr_solve``).

    Factor keys: the JAX package's ``_lqr_solve(fac, a_d, b_d, g, c_lin)``
    reads k, ginv, acl and bt = B'; the port's ``_lqr_solve(fac, b_d, f_c,
    g, parallel)`` reads k, ginv, acl and c_lin from ``fac`` and takes
    f_c = Acl' c_lin precomputed. Here ``fac_loc`` holds the local slices
    of the port's ``_riccati_factor`` keys k, ginv and acl (a "bt" or
    "c_lin" key is ignored); B' is ``b_d_loc`` transposed, and c_lin and
    f_c come from ``c_lin_loc``. ``a_d`` is unused, as in the JAX function
    (the closed-loop maps carry it).

    Args:
      fac_loc: dict of local slices k (B, s, 12, 13), ginv (B, s, 12, 12),
        acl (B, s, 13, 13) of a replicated ``_riccati_factor``.
      a_d: (B, 13, 13) replicated.
      b_d_loc: (B, s, 13, 12); g_loc: (B, s, 12); c_lin_loc: (B, s, 13).
      group: the process group of the horizon axis.

    Returns:
      (B, s, 12) local slice of the per-stage inputs u.
    """
    del a_d
    k_gain, ginv, acl = fac_loc["k"], fac_loc["ginv"], fac_loc["acl"]
    idx, n = dist.get_rank(group), dist.get_world_size(group)

    # backward: p_i = Acl_i' p_{i+1} + (Acl_i' c_i - K_i' g_i), p_H = 0
    e_bwd = acl.transpose(-1, -2)
    f_bwd = _bmv(e_bwd, c_lin_loc) - torch.einsum('bhux,bhu->bhx', k_gain,
                                                  g_loc)
    p_all = affine_scan_sharded(e_bwd, f_bwd, group, reverse=True)
    # s_i = p_{i+1} + c_i: shift left by one across the block boundary
    # (rank k's last stage needs rank k + 1's first value)
    firsts = _gather(p_all[:, 0], group)
    nxt = (firsts[idx + 1] if idx < n - 1
           else torch.zeros_like(p_all[:, 0]))
    s_next = torch.cat([p_all[:, 1:], nxt[:, None]], 1) + c_lin_loc

    # forward: x_{i+1} = Acl_i x_i - B_i d_i, x_0 = 0
    d = _bmv(ginv, torch.einsum('bhxu,bhx->bhu', b_d_loc, s_next) + g_loc)
    x_all = affine_scan_sharded(acl, -_bmv(b_d_loc, d), group, reverse=False)
    # the x_i stage i consumes is the previous stage's scan output
    lasts = _gather(x_all[:, -1], group)
    prev = lasts[idx - 1] if idx > 0 else torch.zeros_like(x_all[:, -1])
    x = torch.cat([prev[:, None], x_all[:, :-1]], 1)
    return -_bmv(k_gain, x) - d

"""Stagewise (sparse, O(H)) long-horizon MPC solver.

Port of the JAX package's ``ops/stagewise.py``. The horizon-H QP stays in
its stagewise form and is solved with the OSQP-semantics ADMM of
``ops/admm.py``, except that the per-iteration KKT solve

    (P + sigma I + C' diag(rho) C) u = rhs,   P = B_qp' Q B_qp + R

runs without materializing P, as the affine LQR problem

    min  sum_i 1/2 x_{i+1}' Q x_{i+1} + 1/2 u_i' Rbar u_i + g_i' u_i
    s.t. x_{i+1} = A x_i + B_i u_i,  x_0 = 0,   g = -rhs

with Rbar = R + sigma I + C' diag(rho) C (block-diagonal per leg): one
discrete-Riccati backward factorization per rho segment (gains K_i and
G_i^-1, independent of rhs), then per ADMM iteration an affine backward /
forward pass of 13-dim steps. Every tensor carries a leading scenario axis
``B``; each ``lax.scan`` over the horizon of the JAX package is a Python
loop over H of batched operations.

The 12 x 12 inverse G_i^-1 of each stage is the JAX package's
``admm._schulz_inverse(g, 0, coeffs=_scaled_schulz_coeffs(1e-7))``: kernel
K3 at n = 12 on the card (``ops/schulz_batch.py``, one launch a stage for
the whole batch, FP32 in every step), its plain version on the CPU.

The affine passes: each is a recurrence p <- E p + f. Their constant parts
(E_i and the rhs-independent terms) are formed once a segment, so each step
of a pass is one batched multiply-add; with ``parallel_scan=True`` the
passes are log-depth prefix compositions over the horizon instead
(:func:`_affine_scan`). On the card the ``seg_iters`` iterations of a
segment, which launch no counted kernel, replay as one CUDA graph
(a one-part ``utils/graphs.StagedStep``) while the Riccati pass with its K3
launches stays eager; :data:`REPLAY` = False runs them eagerly. A graph is
captured per schedule and batch bucket: a batch of n scenarios replays
padded to the next power of two (the iterations are per scenario, the
padding rows' results are dropped), so the cold and warm sub-batches of a
routed tick, whose sizes follow the data, meet at most log2(B) + 1 shapes a
schedule; the cache keeps the :data:`MAX_GRAPHS` most recently used.
"""

from typing import NamedTuple

import torch

from go1_qp_mpc_controller_torch.config import params as P
from go1_qp_mpc_controller_torch.models import srb
from go1_qp_mpc_controller_torch.ops import admm
from go1_qp_mpc_controller_torch.utils import graphs
from go1_qp_mpc_controller_torch.utils.device import const

NX = 13
NU = 12
NC = P.MPC_CONSTRAINT_DIM     # 20 pyramid rows per stage

# replay each segment's ADMM iterations as a CUDA graph on the card
REPLAY = True
MAX_GRAPHS = 32
_captured = {}          # key -> StagedStep, least recently used first
_bmv = admm._bmv        # (..., n, k) x (..., k) -> (..., n)


class StagewiseSolution(NamedTuple):
    u: torch.Tensor            # (B, H, 12) per-stage GRFs (u[:, 0] applied)
    y: torch.Tensor            # (B, H, 20) duals (unscaled)
    z: torch.Tensor            # (B, H, 20) projected constraint values
    rho: torch.Tensor          # (B,) adapted rho
    primal_res: torch.Tensor   # (B,) relative max |Cu - z|
    dual_res: torch.Tensor     # (B,) relative max |Pu + q + C'y|


class StagewiseWarmState(NamedTuple):
    """Cross-tick carry of the stagewise solver (no KKT inverse: the
    Riccati pass is re-run each tick against the drifted (A, B, rho)).

    Attributes:
      u: (B, H, 12) primal carry; y: (B, H, 20) dual carry (unscaled).
      rho: (B,) carried step size.
      q_lin: (B, H, 12) the linear term the carry solved (drift trigger).
    """
    u: torch.Tensor
    y: torch.Tensor
    rho: torch.Tensor
    q_lin: torch.Tensor


def _mu_planes(mu, like):
    """The friction coefficient (a number or (B,)) as a tensor that
    broadcasts against the (B, ..., 4) per-leg planes of ``like``
    (B, ..., k); a number is copied to the device once."""
    if not torch.is_tensor(mu):
        return const((float(mu),), like.dtype, like.device)[0]
    mu = mu.to(like.dtype)
    return mu.reshape(mu.shape + (1,) * (like.dim() - 1))


def _stage_matvec(u, mu):
    """(..., 12) -> (..., 20): per-stage friction-pyramid rows
    (``srb.constraint_matvec`` for one stage)."""
    f = u.reshape(u.shape[:-1] + (4, 3))
    fx, fy, fz = f.unbind(-1)
    rows = torch.stack(
        [fx + mu * fz, fx - mu * fz, fy + mu * fz, fy - mu * fz, fz], dim=-1)
    return rows.reshape(u.shape[:-1] + (NC,))


def _stage_rmatvec(y, mu):
    """(..., 20) -> (..., 12): adjoint of :func:`_stage_matvec`."""
    r = y.reshape(y.shape[:-1] + (4, 5))
    r0, r1, r2, r3, r4 = r.unbind(-1)
    fz = mu * (r0 - r1 + r2 - r3) + r4
    return torch.stack([r0 + r1, r2 + r3, fz], dim=-1).reshape(
        y.shape[:-1] + (NU,))


def _ctc_dense(rho_vec, mu):
    """C' diag(rho_vec) C for one stage: (B, 12, 12), block-diagonal per
    leg (rows fx+mu fz, fx-mu fz, fy+mu fz, fy-mu fz, fz with weights
    r1..r5; ConvexMpc.cpp:46-58). ``mu`` broadcasts against (B, 4)."""
    r1, r2, r3, r4, r5 = rho_vec.reshape(rho_vec.shape[0], 4, 5).unbind(-1)
    sxx = r1 + r2
    syy = r3 + r4
    sxz = mu * (r1 - r2)
    syz = mu * (r3 - r4)
    szz = mu * mu * (r1 + r2 + r3 + r4) + r5
    z = torch.zeros_like(sxx)
    blk = torch.stack([torch.stack([sxx, z, sxz], -1),
                       torch.stack([z, syy, syz], -1),
                       torch.stack([sxz, syz, szz], -1)], -2)  # (B, 4, 3, 3)
    out = torch.zeros(blk.shape[:1] + (4, 3, 4, 3), dtype=blk.dtype,
                      device=blk.device)
    for leg in range(4):
        out[:, leg, :, leg, :] = blk[:, leg]
    return out.reshape(-1, NU, NU)


def _riccati_factor(a_d, b_d, q_diag, rbar):
    """Backward Riccati factorization (once per rho segment).

    Args:
      a_d: (B, 13, 13); b_d: (B, H, 13, 12) per-stage B.
      q_diag: (B, 13) scaled state-cost diagonal (on x_1..x_H).
      rbar: (B, 12, 12) scaled augmented input cost.

    Returns dict of per-stage tensors: k (B, H, 12, 13) the gains
    G^-1 B' S A, ginv (B, H, 12, 12), acl (B, H, 13, 13) the closed loop
    A - B K.
    """
    h = b_d.shape[1]
    q_mat = torch.diag_embed(q_diag)
    coeffs = admm._scaled_schulz_coeffs(1e-7)
    a_t = a_d.transpose(-1, -2)
    p_next = torch.zeros_like(a_d)
    k, ginv, acl = [None] * h, [None] * h, [None] * h
    for i in reversed(range(h)):
        b_i = b_d[:, i]
        s = q_mat + p_next                       # cost on x_{i+1}
        bs = b_i.transpose(-1, -2) @ s           # (B, 12, 13)
        g = rbar + bs @ b_i                      # (B, 12, 12)
        ginv[i] = admm._schulz_inverse(g, 0, coeffs=coeffs)
        k[i] = ginv[i] @ (bs @ a_d)
        acl[i] = a_d - b_i @ k[i]
        p = a_t @ s @ acl[i]
        p_next = 0.5 * (p + p.transpose(-1, -2))
    return {"k": torch.stack(k, 1), "ginv": torch.stack(ginv, 1),
            "acl": torch.stack(acl, 1)}


def _hessian_diag_max(a_d, b_d, q_diag, r_diag):
    """(B,) max of the condensed Hessian's diagonal,
    max_i max(diag(B_i' T_{i+1} B_i) + r_diag) with T_H = Q and
    T_i = Q + A' T_{i+1} A (the open-loop state-cost propagation): the
    cost scale of :func:`_problem_setup` (the JAX package tracks it in its
    Riccati scan)."""
    h = b_d.shape[1]
    q_mat = torch.diag_embed(q_diag)
    a_t = a_d.transpose(-1, -2)
    t_next = [None] * h
    t = q_mat
    for i in reversed(range(h)):
        t_next[i] = t
        t = q_mat + a_t @ t @ a_d
    t_next = torch.stack(t_next, 1)                          # (B, H, 13, 13)
    diag = torch.diagonal(b_d.transpose(-1, -2) @ t_next @ b_d, dim1=-2,
                          dim2=-1)                           # (B, H, 12)
    return torch.clamp((diag + r_diag[:, None]).amax((1, 2)), min=0.0)


def _affine_scan(e, f, reverse):
    """Log-depth prefix (``reverse``: suffix) composition of the affine
    maps v -> E_i v + f_i over the horizon: the value after stage i of the
    forward recurrence v_{i+1} = E_i v_i + f_i from v = 0 (reverse:
    v_i = E_i v_{i+1} + f_i from v_H = 0). Composition applies the later
    map last in both directions, as the JAX package's ``comb`` does.

    Args:
      e: (B, H, n, n); f: (B, H, n).

    Returns:
      (B, H, n).
    """
    return _affine_scan_maps(e, f, reverse)[1]


def _affine_scan_maps(e, f, reverse):
    """:func:`_affine_scan` returning the composed maps (E, f) of every
    prefix (``reverse``: suffix), (B, H, n, n) and (B, H, n)."""
    h = e.shape[1]
    d = 1
    while d < h:
        if reverse:        # element i absorbs i + d (applied first)
            head_e, head_f = e[:, :-d], f[:, :-d]
            e = torch.cat([head_e @ e[:, d:], e[:, h - d:]], 1)
            f = torch.cat([_bmv(head_e, f[:, d:]) + head_f, f[:, h - d:]], 1)
        else:              # element i absorbs i - d (applied first)
            tail_e, tail_f = e[:, d:], f[:, d:]
            e = torch.cat([e[:, :d], tail_e @ e[:, :-d]], 1)
            f = torch.cat([f[:, :d], _bmv(tail_e, f[:, :-d]) + tail_f], 1)
        d *= 2
    return e, f


def _lqr_solve(fac, b_d, f_c, g, parallel=False):
    """Solve the affine LQR for per-stage input linear terms g (B, H, 12).

    min sum 1/2 x_{i+1}'Q x_{i+1} + c_{i+1}'x_{i+1} + 1/2 u'Rbar u + g'u
    s.t. x_{i+1} = A x_i + B u_i, x_0 = 0.

    Backward: p_i = Acl_i' p_{i+1} + Acl_i' c_i - K_i' g_i, p_H = 0, with
    ``f_c`` = Acl_i' c_i formed once a segment; the value stage i consumes
    is s_i = p_{i+1} + c_i. Forward: x_{i+1} = Acl_i x_i - B_i d_i,
    d_i = G_i^-1 (B_i' s_i + g_i), and u_i = -K_i x_i - d_i. Each pass is
    a loop of one batched multiply-add a stage, or with ``parallel`` the
    log-depth :func:`_affine_scan`.

    Returns u: (B, H, 12).
    """
    k, ginv, acl, c_lin = fac["k"], fac["ginv"], fac["acl"], fac["c_lin"]
    batch, h = g.shape[:2]
    f_bwd = f_c - torch.einsum('bhux,bhu->bhx', k, g)
    acl_t = acl.transpose(-1, -2)
    if parallel:
        p_all = _affine_scan(acl_t, f_bwd, reverse=True)
    else:
        p = torch.zeros((batch, NX, 1), dtype=g.dtype, device=g.device)
        p_all = [None] * h
        for i in reversed(range(h)):
            p = torch.baddbmm(f_bwd[:, i, :, None], acl_t[:, i], p)
            p_all[i] = p[..., 0]
        p_all = torch.stack(p_all, 1)
    s_next = torch.cat([p_all[:, 1:], torch.zeros_like(p_all[:, :1])],
                       1) + c_lin                          # (B, H, 13)
    d = _bmv(ginv, torch.einsum('bhxu,bhx->bhu', b_d, s_next) + g)
    h_fwd = -_bmv(b_d, d)
    if parallel:
        x_all = _affine_scan(acl, h_fwd, reverse=False)
        x = torch.cat([torch.zeros_like(x_all[:, :1]), x_all[:, :-1]], 1)
    else:
        xv = torch.zeros((batch, NX, 1), dtype=g.dtype, device=g.device)
        x = [xv[..., 0]]
        for i in range(h - 1):
            xv = torch.baddbmm(h_fwd[:, i, :, None], acl[:, i], xv)
            x.append(xv[..., 0])
        x = torch.stack(x, 1)                                # x_i
    return -_bmv(k, x) - d


def _gradient(a_d, b_d, u, qs_diag, refs, r_diag):
    """P u + q stagewise (B, H, 12): one rollout from x0 = 0 (refs already
    hold ref_i - A^i x0) and one adjoint pass,
    P u + q = R u_i + B_i' lambda_{i+1},
    lambda_i = A' lambda_{i+1} + Q (x_i - ref_i)."""
    batch, h = u.shape[:2]
    bu = _bmv(b_d, u)                                        # (B, H, 13)
    x = torch.zeros((batch, NX, 1), dtype=u.dtype, device=u.device)
    xs = []
    for i in range(h):
        x = torch.baddbmm(bu[:, i, :, None], a_d, x)
        xs.append(x[..., 0])
    qx = qs_diag[:, None] * (torch.stack(xs, 1) - refs)      # (B, H, 13)
    a_t = a_d.transpose(-1, -2)
    lam = torch.zeros_like(x)
    lams = [None] * h
    for i in reversed(range(h)):
        lam = torch.baddbmm(qx[:, i, :, None], a_t, lam)
        lams[i] = lam[..., 0]
    return u * r_diag[:, None] + torch.einsum('bhxu,bhx->bhu', b_d,
                                              torch.stack(lams, 1))


def _free_rollout(a_d, x0, h):
    """(B, h, 13): A^i x0 for i = 1..h."""
    x, xs = x0[..., None], []
    for _ in range(h):
        x = a_d @ x
        xs.append(x[..., 0])
    return torch.stack(xs, 1)


def _batched(w, batch):
    """Weights (n,) or (B, n) as (B, n)."""
    return w.expand(batch, w.shape[-1])


def _stage_b(b_d, h):
    """(B, 13, 12) shared or (B, H, 13, 12) per-stage B as (B, H, 13, 12)."""
    if b_d.dim() == 3:
        return b_d[:, None].expand(b_d.shape[0], h, NX, NU)
    return b_d


def linear_term(a_d, b_d, x0, x_ref, q_weights, r_weights):
    """Unscaled condensed gradient q (B, H, 12) in stagewise form: the
    condensed path's 2 B_qp' Qw (A_qp x0 - x_ref) per stage, the
    controller's drift trigger for long horizons."""
    batch, h = x_ref.shape[:2]
    b_d = _stage_b(b_d, h)
    refs = x_ref - _free_rollout(a_d, x0, h)
    return _gradient(a_d, b_d, torch.zeros((batch, h, NU), dtype=x_ref.dtype,
                                           device=x_ref.device),
                     2.0 * _batched(q_weights, batch), refs,
                     2.0 * _batched(r_weights, batch))


def _problem_setup(a_d, b_d, x0, x_ref, q_weights, r_weights, contacts,
                   fz_min, fz_max):
    """Shared cold / warm preprocessing: reference folding, bounds, cost
    scale and the constant linear term. Returns a dict of tensors."""
    batch, h = x_ref.shape[:2]
    dtype = x_ref.dtype
    b_d = _stage_b(b_d, h)
    qs = 2.0 * _batched(q_weights, batch)                    # as condense()
    rs = 2.0 * _batched(r_weights, batch)
    # fold x0 into the references: tracking (x_i - ref_i) under the true
    # dynamics == tracking (w_i - (ref_i - A^i x0)) with w_0 = 0
    refs = x_ref - _free_rollout(a_d, x0, h)
    # one-stage bounds, shared across stages (contacts constant over the
    # horizon, A1RobotControl.cpp:498-514)
    lb1, ub1 = srb._pyramid_bounds(contacts, fz_min, fz_max, dtype)
    lb = lb1[:, None, :NC].expand(batch, h, NC)
    ub = ub1[:, None, :NC].expand(batch, h, NC)
    eq = torch.isclose(lb, ub)
    big = torch.finfo(dtype).max / 8
    lb_f = torch.clamp(lb, min=-big)
    ub_f = torch.clamp(ub, max=big)
    # cost scale 1 / max diag(P), the exact condensed diagonal
    cost = 1.0 / torch.clamp(_hessian_diag_max(a_d, b_d, qs, rs), min=1e-12)
    qs_s = cost[:, None] * qs
    rs_s = cost[:, None] * rs
    # the constant linear term q = gradient at u = 0: the dual residual
    # normalizes by max(|Pu|, |q|, |C'y|) separately, as admm.solve does
    q_lin = _gradient(a_d, b_d, torch.zeros((batch, h, NU), dtype=dtype,
                                            device=x_ref.device),
                      qs_s, refs, rs_s)
    return dict(h=h, b_d=b_d, qs_s=qs_s, rs_s=rs_s, refs_s=refs, cost=cost,
                q_lin=q_lin, eq=eq, lb_f=lb_f, ub_f=ub_f)


class _LoopOperands(NamedTuple):
    """What a segment's ADMM iterations read (the CUDA graph's inputs)."""
    k: torch.Tensor
    ginv: torch.Tensor
    acl: torch.Tensor
    b_d: torch.Tensor
    c_lin: torch.Tensor
    f_c: torch.Tensor
    rho_vec: torch.Tensor
    lb_f: torch.Tensor
    ub_f: torch.Tensor
    mu: torch.Tensor


def _iterations(u, z, y, ops, iters, sigma, alpha, parallel):
    """``iters`` fixed ADMM iterations on the segment's factorization."""
    fac = {"k": ops.k, "ginv": ops.ginv, "acl": ops.acl, "c_lin": ops.c_lin}
    mu = ops.mu
    for _ in range(iters):
        g = -(sigma * u + _stage_rmatvec(ops.rho_vec * z - y, mu))
        u_t = _lqr_solve(fac, ops.b_d, ops.f_c, g, parallel)
        z_t = _stage_matvec(u_t, mu)
        u_new = alpha * u_t + (1.0 - alpha) * u
        z_mid = alpha * z_t + (1.0 - alpha) * z
        z_new = torch.minimum(torch.maximum(z_mid + y / ops.rho_vec,
                                            ops.lb_f), ops.ub_f)
        y = y + ops.rho_vec * (z_mid - z_new)
        u, z = u_new, z_new
    return u, z, y


def _bucket(n):
    """The batch a sub-batch of ``n`` scenarios replays at."""
    return 1 << (n - 1).bit_length()


def _run_iterations(u, z, y, ops, settings, parallel):
    """:func:`_iterations` with the segment's schedule: a CUDA-graph replay
    on the card (captured once per batch bucket and schedule), eager
    elsewhere."""
    args = (settings.seg_iters, settings.sigma, settings.alpha, parallel)
    if u.device.type != "cuda" or not REPLAY:
        return _iterations(u, z, y, ops, *args)
    n = u.shape[0]
    rows = _bucket(n)
    if rows != n:       # pad with copies of the last scenario
        idx = torch.arange(rows, device=u.device).clamp_(max=n - 1)
        pad = lambda t: t.index_select(0, idx) if t.dim() else t
        u, z, y = pad(u), pad(z), pad(y)
        ops = _LoopOperands(*map(pad, ops))
    key = (tuple(u.shape), u.dtype, u.device, ops.mu.dim()) + args
    step = _captured.pop(key, None)
    if step is None:
        while len(_captured) >= MAX_GRAPHS:
            del _captured[next(iter(_captured))]
        step = graphs.StagedStep(
            graphs.single(lambda *a: _iterations(*a, *args)), u, z, y, ops)
    _captured[key] = step
    return tuple(t[:n].clone() for t in step(u, z, y, ops)[1])


def _amax(a):
    return a.abs().amax((1, 2))


def _segment(pr, a_d, mu, settings, parallel_scan, carry, adapt_rho=True):
    """One rho segment over the setup dict ``pr``: Riccati refactorization
    + ``seg_iters`` fixed ADMM iterations (+ the rho adaptation). Returns
    ((u, z, y, rho), (prim, dual))."""
    u, z, y, rho = carry
    b_d, eq = pr["b_d"], pr["eq"]
    qs_s, rs_s, refs_s, q_lin = (pr["qs_s"], pr["rs_s"], pr["refs_s"],
                                 pr["q_lin"])
    batch, h = u.shape[:2]
    rho_vec1 = torch.where(eq[:, 0], (rho * settings.rho_eq_scale)[:, None],
                           rho[:, None])                     # (B, 20)
    mu_leg = _mu_planes(mu, rho_vec1)
    rbar = (torch.diag_embed(rs_s)
            + settings.sigma * torch.eye(NU, dtype=u.dtype, device=u.device)
            + _ctc_dense(rho_vec1, mu_leg))
    fac = _riccati_factor(a_d, b_d, qs_s, rbar)
    c_lin = -(qs_s[:, None] * refs_s)                        # (B, H, 13)
    ops = _LoopOperands(
        k=fac["k"], ginv=fac["ginv"], acl=fac["acl"], b_d=b_d.contiguous(),
        c_lin=c_lin,
        f_c=torch.einsum('bhyx,bhy->bhx', fac["acl"], c_lin),
        rho_vec=rho_vec1[:, None].expand(batch, h, NC).contiguous(),
        lb_f=pr["lb_f"].contiguous(), ub_f=pr["ub_f"].contiguous(),
        mu=_mu_planes(mu, u))
    u, z, y = _run_iterations(u, z, y, ops, settings, parallel_scan)

    # residuals: the rule and normalization of admm.solve (|Pu|, |q| and
    # |C'y| enter the dual denominator separately)
    cu = _stage_matvec(u, ops.mu)
    eps = 1e-15
    prim = _amax(cu - z) / torch.clamp(torch.maximum(_amax(cu), _amax(z)),
                                       min=eps)
    grad = _gradient(a_d, b_d, u, qs_s, refs_s, rs_s)        # P u + q
    pu = grad - q_lin
    cty = _stage_rmatvec(y, ops.mu)
    dual = _amax(grad + cty) / torch.clamp(
        torch.maximum(_amax(pu), torch.maximum(_amax(q_lin), _amax(cty))),
        min=eps)
    if adapt_rho:
        factor = torch.sqrt(prim / torch.clamp(dual, min=eps))
        factor = torch.clamp(factor, 1e-2, 1e2)
        factor = torch.where((factor > 5.0) | (factor < 0.2), factor,
                             torch.ones_like(factor))
        factor = torch.where(torch.maximum(prim, dual) > settings.adapt_tol,
                             factor, torch.ones_like(factor))
        rho = torch.clamp(rho * factor, settings.rho_min, settings.rho_max)
    return (u, z, y, rho), (prim, dual)


def _package(pr, u, z, y, rho, prim, dual):
    """Per-scenario NaN latch + unscale, shared by the cold and warm
    entries."""
    finite = (torch.isfinite(u).all(-1).all(-1)
              & torch.isfinite(y).all(-1).all(-1))
    f = finite[:, None, None]
    u = torch.where(f, u, torch.zeros_like(u))
    y = torch.where(f, y, torch.zeros_like(y))
    z = torch.where(f, z, torch.zeros_like(z))
    bigr = torch.full_like(prim, 1e6)
    cost = pr["cost"][:, None, None]
    sol = StagewiseSolution(
        u=u, y=y / cost, z=z, rho=rho,
        primal_res=torch.where(finite, prim, bigr),
        dual_res=torch.where(finite, dual, bigr))
    warm = StagewiseWarmState(u=sol.u, y=sol.y, rho=rho,
                              q_lin=pr["q_lin"] / cost)
    return sol, warm


def mpc_solve(a_d, b_d, x0, x_ref, q_weights, r_weights, contacts,
              mu=P.MPC_MU, settings=admm.ADMMSettings(),
              fz_min=P.MPC_FZ_MIN, fz_max=P.MPC_FZ_MAX,
              parallel_scan=False, return_warm=False):
    """Long-horizon MPC solve in stagewise form (O(H) an iteration).

    Args:
      a_d: (B, 13, 13) discrete A.
      b_d: (B, 13, 12) shared or (B, H, 13, 12) per-stage discrete B.
      x0: (B, 13); x_ref: (B, H, 13), H arbitrary.
      q_weights: (13,) or (B, 13); r_weights: (12,) or (B, 12).
      contacts: (B, 4); mu: a number or (B,).
      settings: admm.ADMMSettings; seg_iters / segments / rho / sigma /
        alpha / rho_eq_scale / rho bounds / adapt_tol are honored, the
        dense path's KKT and polish knobs are not (the KKT solve is the
        Riccati pass).
      return_warm: also return a StagewiseWarmState for
        :func:`mpc_solve_warm` ticks.

    Returns:
      StagewiseSolution (or (solution, warm)); u[:, 0] is the applied GRF.
    """
    pr = _problem_setup(a_d, b_d, x0, x_ref, q_weights, r_weights,
                        contacts, fz_min, fz_max)
    batch, h = x_ref.shape[:2]
    dtype, device = x_ref.dtype, x_ref.device
    u = torch.zeros((batch, h, NU), dtype=dtype, device=device)
    z = torch.minimum(torch.maximum(_stage_matvec(u, _mu_planes(mu, u)),
                                    pr["lb_f"]), pr["ub_f"])
    y = torch.zeros((batch, h, NC), dtype=dtype, device=device)
    carry = (u, z, y, torch.full((batch,), settings.rho, dtype=dtype,
                                 device=device))
    for _ in range(settings.segments):
        carry, (prim, dual) = _segment(pr, a_d, mu, settings, parallel_scan,
                                       carry)
    sol, warm = _package(pr, *carry, prim, dual)
    return (sol, warm) if return_warm else sol


def mpc_solve_warm(a_d, b_d, x0, x_ref, q_weights, r_weights, contacts,
                   warm, mu=P.MPC_MU, settings=admm.ADMMSettings(),
                   fz_min=P.MPC_FZ_MIN, fz_max=P.MPC_FZ_MAX,
                   parallel_scan=False):
    """One warm stagewise tick: refactorize the Riccati pass at the
    carried rho and run one fixed-iteration segment from the carried
    primal / dual (the Riccati refactorization is exact for the current
    (A, B, rho), so no basin safeguard exists; the caller routes contact
    flips and large drifts to :func:`mpc_solve`).

    Args:
      warm: StagewiseWarmState from a previous tick.
      settings: seg_iters is the warm budget; segments is ignored (one
        segment, rho fixed at the carry).

    Returns:
      (StagewiseSolution, next StagewiseWarmState).
    """
    pr = _problem_setup(a_d, b_d, x0, x_ref, q_weights, r_weights,
                        contacts, fz_min, fz_max)
    u = warm.u
    y = warm.y * pr["cost"][:, None, None]
    z = torch.minimum(torch.maximum(_stage_matvec(u, _mu_planes(mu, u)),
                                    pr["lb_f"]), pr["ub_f"])
    carry, (prim, dual) = _segment(pr, a_d, mu, settings, parallel_scan,
                                   (u, z, y, warm.rho), adapt_rho=False)
    return _package(pr, *carry, prim, dual)

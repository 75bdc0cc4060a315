"""Single-rigid-body (SRB) linearized dynamics and dense MPC condensation.

Port of the JAX package's ``models/srb.py`` (ConvexMpc.cpp:110-245). State
x = (roll, pitch, yaw, px, py, pz, wx, wy, wz, vx, vy, vz, g); input u = 12
world-frame ground-reaction forces. Every function takes an explicit
leading batch axis ``B``. Four condensations build the same horizon-10 QP:
the general A-power recursion over per-step B (:func:`condense`), its
nilpotent closed form (:func:`condense_nilpotent`), and for a B shared
across the horizon the block-Toeplitz form (:func:`condense_toeplitz`) and
the factored form the controller uses (:func:`condense_nilpotent_lazy`).
Weights are (13,) / (12,) shared or (B, 13) / (B, 12) per scenario.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from reference.go1.config import params as P
from reference.go1.utils import rotations

H = P.PLAN_HORIZON
NX = P.MPC_STATE_DIM   # 13
NU = P.NUM_DOF         # 12
NC1 = P.MPC_CONSTRAINT_DIM  # 20 per step


def calculate_A_c(root_euler):
    """Continuous-time A (..., 13, 13) (ConvexMpc.cpp:110-130): only the
    yaw enters, through Rz(yaw)^T on the omega -> rpy-rate block."""
    dtype, device = root_euler.dtype, root_euler.device
    lead = root_euler.shape[:-1]
    a = torch.zeros(lead + (NX, NX), dtype=dtype, device=device)
    a[..., 0:3, 6:9] = rotations.rot_z(root_euler[..., 2]).transpose(-1, -2)
    a[..., 3:6, 9:12] = torch.eye(3, dtype=dtype, device=device)
    a[..., 11, 12] = 1.0                     # gravity state drives vz
    return a


def calculate_B_c(mass, trunk_inertia, root_rot_mat, foot_pos):
    """Continuous-time B (B, 13, 12) (ConvexMpc.cpp:132-143):
    B[6:9, 3i:3i+3] = I_world^-1 skew(r_i), B[9:12, 3i:3i+3] = I / m, with
    I_world = R I_body R' inverted by the 3x3 adjugate.

    Args:
      mass: () kg; trunk_inertia: (3, 3).
      root_rot_mat: (B, 3, 3); foot_pos: (B, 4, 3) world-aligned feet
        relative to the CoM.
    """
    dtype, device = foot_pos.dtype, foot_pos.device
    batch = foot_pos.shape[0]
    i_world = root_rot_mat @ trunk_inertia @ root_rot_mat.transpose(-1, -2)
    skews = rotations.skew(foot_pos)                        # (B, 4, 3, 3)
    c0 = rotations.cross(i_world[:, :, 1], i_world[:, :, 2])
    c1 = rotations.cross(i_world[:, :, 2], i_world[:, :, 0])
    c2 = rotations.cross(i_world[:, :, 0], i_world[:, :, 1])
    det = torch.sum(i_world[:, :, 0] * c0, dim=-1)
    i_world_inv = torch.stack([c0, c1, c2], dim=1) / det[:, None, None]
    inv_skews = torch.einsum('brc,bkcx->bkrx', i_world_inv, skews)
    omega_rows = inv_skews.transpose(1, 2).reshape(batch, 3, NU)
    v_rows = (torch.eye(3, dtype=dtype, device=device).repeat(1, P.NUM_LEG)
              / mass).expand(batch, 3, NU)
    zeros = lambda r: torch.zeros((batch, r, NU), dtype=dtype, device=device)
    return torch.cat([zeros(6), omega_rows, v_rows, zeros(1)], dim=1)


def discretize(a_c, b_c, dt):
    """Forward Euler (ConvexMpc.cpp:145-156): A_d = I + A_c dt,
    B_d = B_c dt."""
    eye = torch.eye(NX, dtype=a_c.dtype, device=a_c.device)
    return eye + a_c * dt, b_c * dt


def _nilpotent_coeffs_expanded():
    """Hessian coefficients for the constant-B_d nilpotent condensation,
    pre-expanded to (4, H, H*NU) (see the JAX package's srb.py)."""
    i = np.arange(H)[:, None, None]
    j = np.arange(H)[None, :, None]
    jp = np.arange(H)[None, None, :]
    valid = (i >= j) & (i >= jp)
    a = valid.sum(0)
    b = np.where(valid, i - jp, 0).sum(0)
    c = np.where(valid, i - j, 0).sum(0)
    e = np.where(valid, (i - j) * (i - jp), 0).sum(0)
    coefs = np.stack([a, b, c, e]).astype(np.float32)      # (4, H, H)
    return np.repeat(coefs, NU, axis=2)                    # (4, H, H*NU)


_NILP_COEFFS_E = _nilpotent_coeffs_expanded()
# lane-expansion operator R[y, j'*NU + y'] = [y == y'] (tiles a 12x12 block
# H times along the columns)
_NILP_EXPAND = np.tile(np.eye(NU, dtype=np.float32), (1, H))
# Hessian-diagonal coefficient slice: COEFFS_DIAG[k, a] = COEFFS_E[k, a//NU, a]
_NILP_COEFFS_DIAG = _NILP_COEFFS_E[:, np.arange(H * NU) // NU,
                                   np.arange(H * NU)]


def _nilpotent_masks():
    """Constants M0[i, j] = [i >= j], M1[i, j] = [i >= j] (i - j): with
    N = A_d - I nilpotent (N^3 = 0, N^2 B_d = 0) the B_qp block is
    block(i, j) = M0[i, j] U_j + M1[i, j] V_j, U_j = B_d[j], V_j = N B_d[j]."""
    i = np.arange(H)[:, None]
    j = np.arange(H)[None, :]
    m0 = (i >= j).astype(np.float32)
    return m0, m0 * (i - j)


_NILP_M0, _NILP_M1 = _nilpotent_masks()


def _toeplitz_mask():
    """Constant M[k, l, i, j] = 1 iff block (i, j) of B'B receives
    G_k'QG_l, i.e. i + k == j + l <= H-1 (B_qp = sum_k Shift_k (x) G_k)."""
    k = np.arange(H)[:, None, None, None]
    l = np.arange(H)[None, :, None, None]
    i = np.arange(H)[None, None, :, None]
    j = np.arange(H)[None, None, None, :]
    return (((i + k) == (j + l)) & ((i + k) <= H - 1)).astype(np.float32)


# gradient window: w[k, j, i] = 1 iff i == j + k
_WINDOW_MASK = (
    (np.arange(H)[:, None, None] + np.arange(H)[None, :, None])
    == np.arange(H)[None, None, :]).astype(np.float32)

_CONSTS = {"coeffs_e": _NILP_COEFFS_E, "expand": _NILP_EXPAND,
           "coeffs_diag": _NILP_COEFFS_DIAG, "m0": _NILP_M0,
           "m1": _NILP_M1, "toeplitz": _toeplitz_mask(),
           "window": _WINDOW_MASK}


@functools.lru_cache(maxsize=None)
def _const_on(name, dtype, device):
    return torch.as_tensor(_CONSTS[name]).to(device=device, dtype=dtype)


def _const(name, like):
    """Constant ``name`` on ``like``'s device and dtype, copied there once
    (a copy from host memory waits for the device)."""
    return _const_on(name, like.dtype, like.device)


def _per_step(w):
    """Weights (n,) or (B, n) as rows that broadcast against (B, H, n)."""
    return w if w.dim() == 1 else w[:, None, :]


def _tiled(w, h=H):
    """Weights (n,) or (B, n) tiled over ``h`` steps: (h n,) or (B, h n)."""
    return torch.tile(w, (h,))


def _pyramid_bounds(contacts, fz_min, fz_max, dtype):
    """Friction-pyramid bounds (B, 200) tiled over the horizon
    (ConvexMpc.cpp:223-245)."""
    c = contacts.to(dtype)
    inf = torch.full_like(c, float("inf"))
    zero = torch.zeros_like(c)
    lb_leg = torch.stack([zero, -inf, zero, -inf, fz_min * c], dim=-1)
    ub_leg = torch.stack([inf, zero, inf, zero, fz_max * c], dim=-1)
    lead = contacts.shape[:-1]
    return (lb_leg.reshape(lead + (-1,)).repeat((1,) * len(lead) + (H,)),
            ub_leg.reshape(lead + (-1,)).repeat((1,) * len(lead) + (H,)))


class CondensedQP(NamedTuple):
    """Batched dense condensed MPC QP: min 1/2 u'Pu + q'u s.t.
    lb <= C u <= ub, with C the friction pyramid applied by
    :func:`constraint_matvec` / :func:`constraint_rmatvec`.

    Attributes:
      hessian: (B, 120, 120); gradient: (B, 120); lb, ub: (B, 200).
    """
    hessian: torch.Tensor
    gradient: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor


class LazyCondensedQP(NamedTuple):
    """Batched condensed MPC QP with the Hessian left factored:
    hessian = sum_k COEF[k] * tiled[k] (reshaped) + diag(r_diag), COEF
    the constant ``_NILP_COEFFS_E``.

    Attributes:
      tiled: (B, 4, 1, 12, 120) expanded Gram quadrants.
      r_diag: (B, 120) the 2 R diagonal term.
      gradient: (B, 120); lb, ub: (B, 200).
    """
    tiled: torch.Tensor
    r_diag: torch.Tensor
    gradient: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor


def lazy_hessian(lazy):
    """Materialize the (B, 120, 120) Hessian of a LazyCondensedQP."""
    coef = _const("coeffs_e", lazy.tiled)                # (4, H, 120)
    t = lazy.tiled[:, :, 0]                                  # (B, 4, 12, 120)
    h_blocks = (coef[0][:, None, :] * t[:, 0, None]
                + coef[1][:, None, :] * t[:, 1, None]
                + coef[2][:, None, :] * t[:, 2, None]
                + coef[3][:, None, :] * t[:, 3, None])      # (B, H, 12, 120)
    return (h_blocks.reshape(-1, H * NU, H * NU)
            + torch.diag_embed(lazy.r_diag))


def lazy_hessian_matvec(lazy, x):
    """hessian @ x (B, 120) without materializing the Hessian."""
    coef = _const("coeffs_e", lazy.tiled)
    w = coef * x[:, None, None, :]                           # (B, 4, H, 120)
    y = torch.einsum('bkij,bkhj->bkhi', lazy.tiled[:, :, 0], w)
    return torch.sum(y, dim=1).reshape(-1, H * NU) + lazy.r_diag * x


def lazy_hessian_diag(lazy):
    """diag(hessian) (B, 120) without materializing the Hessian."""
    cdiag = _const("coeffs_diag", lazy.tiled)            # (4, 120)
    cols = torch.arange(H * NU, device=lazy.tiled.device)
    tiled3 = lazy.tiled.reshape(-1, 4, NU, H * NU)
    tdiag = tiled3[:, :, cols % NU, cols]                    # (B, 4, 120)
    return torch.sum(cdiag * tdiag, dim=1) + lazy.r_diag


def _polynomial_residuals(n_mat, x0, x_ref):
    """r_i = A_d^(i+1) x0 - xref_i (B, H, 13) by the polynomial in
    N = A_d - I: A_d^k = I + k N + k(k-1)/2 N^2."""
    n1 = (n_mat @ x0[..., None])[..., 0]
    n2 = (n_mat @ n1[..., None])[..., 0]
    k = torch.arange(1, H + 1, dtype=x0.dtype, device=x0.device)[:, None]
    return (x0[:, None] + k * n1[:, None] + (k * (k - 1) / 2) * n2[:, None]
            - x_ref)


def condense_nilpotent_lazy(a_d, b_d, x0, x_ref, q_weights, r_weights,
                            contacts, fz_min=P.MPC_FZ_MIN,
                            fz_max=P.MPC_FZ_MAX):
    """Closed-form condensation for a constant B_d, Hessian left factored.

    With N = A_d - I nilpotent (N^3 = 0, N^2 B_d = 0) the Hessian
    assembles from four 12x12 Gram blocks (U'QU, U'QV, V'QU, V'QV) scaled
    by constant coefficient masks (see the JAX package's
    ``condense_nilpotent_lazy``).

    Args:
      a_d: (B, 13, 13); b_d: (B, 13, 12) shared across the horizon.
      x0: (B, 13); x_ref: (B, H, 13).
      q_weights: (13,) or (B, 13); r_weights: (12,) or (B, 12);
      contacts: (B, 4).
    """
    dtype = a_d.dtype
    batch = a_d.shape[0]
    n_mat = a_d - torch.eye(NX, dtype=dtype, device=a_d.device)
    u = b_d                                                  # (B, 13, 12)
    v = n_mat @ u                                            # N B_d
    w = torch.cat([u, v], dim=2)                             # (B, 13, 24)
    qw13 = 2.0 * q_weights
    gram = w.transpose(1, 2) @ (qw13[..., None] * w)         # (B, 24, 24)
    quad4 = torch.cat([gram[:, :NU, :NU], gram[:, :NU, NU:],
                       gram[:, NU:, :NU], gram[:, NU:, NU:]], dim=1)
    expand = _const("expand", a_d)                       # (12, 120)
    tiled = (quad4 @ expand).reshape(batch, 4, 1, NU, H * NU)

    resid = _polynomial_residuals(n_mat, x0, x_ref)

    # q_j = U'Qw s0_j + V'Qw (s1_j - j s0_j) with suffix sums
    # s0_j = sum_{i>=j} r_i, s1_j = sum_{i>=j} i r_i
    rq = resid * _per_step(qw13)
    jcol = torch.arange(H, dtype=dtype, device=a_d.device)[:, None]
    s0 = torch.flip(torch.cumsum(torch.flip(rq, [1]), dim=1), [1])
    s1 = torch.flip(torch.cumsum(torch.flip(jcol * rq, [1]), dim=1), [1])
    s_both = torch.cat([s0, s1 - jcol * s0], dim=2)          # (B, H, 26)
    w2 = torch.cat([u, v], dim=1)                            # (B, 26, 12)
    gradient = (s_both @ w2).reshape(batch, H * NU)

    lb, ub = _pyramid_bounds(contacts, fz_min, fz_max, dtype)
    r_diag = _tiled(2.0 * r_weights).expand(batch, H * NU)
    return LazyCondensedQP(tiled=tiled, r_diag=r_diag, gradient=gradient,
                           lb=lb, ub=ub)


def condense_nilpotent_const(a_d, b_d, x0, x_ref, q_weights, r_weights,
                             contacts, fz_min=P.MPC_FZ_MIN,
                             fz_max=P.MPC_FZ_MAX):
    """:func:`condense_nilpotent_lazy` with the Hessian materialized: the
    dense :class:`CondensedQP` the dense solver takes."""
    lazy = condense_nilpotent_lazy(a_d, b_d, x0, x_ref, q_weights,
                                   r_weights, contacts, fz_min, fz_max)
    return CondensedQP(hessian=lazy_hessian(lazy), gradient=lazy.gradient,
                       lb=lazy.lb, ub=lazy.ub)


# --- friction-pyramid constraint operators --------------------------------
# Per (step, leg) block (ConvexMpc.cpp:46-58):
#   rows = [fx + mu fz, fx - mu fz, fy + mu fz, fy - mu fz, fz]
# The 200x120 matrix is block-diagonal over the 40 (step, leg) pairs and is
# never materialized.

def constraint_matvec(u, mu=P.MPC_MU):
    """C @ u: (..., 120) -> (..., 200)."""
    f = u.reshape(u.shape[:-1] + (H * P.NUM_LEG, 3))
    fx, fy, fz = f.unbind(-1)
    rows = torch.stack(
        [fx + mu * fz, fx - mu * fz, fy + mu * fz, fy - mu * fz, fz], dim=-1)
    return rows.reshape(u.shape[:-1] + (H * NC1,))


def constraint_rmatvec(y, mu=P.MPC_MU):
    """C' @ y: (..., 200) -> (..., 120)."""
    r = y.reshape(y.shape[:-1] + (H * P.NUM_LEG, 5))
    r0, r1, r2, r3, r4 = r.unbind(-1)
    fx = r0 + r1
    fy = r2 + r3
    fz = mu * (r0 - r1 + r2 - r3) + r4
    return torch.stack([fx, fy, fz], dim=-1).reshape(y.shape[:-1]
                                                     + (H * NU,))


def reference_trajectory(root_pos, root_euler, root_pos_d, root_euler_d,
                         root_ang_vel_d, root_lin_vel_d_world, mpc_dt,
                         gravity=P.GRAVITY, horizon=H):
    """Desired (B, horizon, 13) trajectory (A1RobotControl.cpp:470-488):
    the desired world velocity and yaw rate integrate from the current
    state; height tracks the desired height; vz reference is 0. The
    stagewise long-horizon path passes its own ``horizon``."""
    dtype = root_pos.dtype
    batch = root_pos.shape[0]
    h = horizon
    i1 = torch.arange(1, h + 1, dtype=dtype, device=root_pos.device)
    full = lambda v: v[:, None].expand(batch, h)
    zeros = torch.zeros((batch, h), dtype=dtype, device=root_pos.device)
    return torch.stack([
        full(root_euler_d[:, 0]),
        full(root_euler_d[:, 1]),
        root_euler[:, 2:3] + root_ang_vel_d[:, 2:3] * mpc_dt * i1,
        root_pos[:, 0:1] + root_lin_vel_d_world[:, 0:1] * mpc_dt * i1,
        root_pos[:, 1:2] + root_lin_vel_d_world[:, 1:2] * mpc_dt * i1,
        full(root_pos_d[:, 2]),
        full(root_ang_vel_d[:, 0]),
        full(root_ang_vel_d[:, 1]),
        full(root_ang_vel_d[:, 2]),
        full(root_lin_vel_d_world[:, 0]),
        full(root_lin_vel_d_world[:, 1]),
        zeros,
        zeros - gravity,
    ], dim=-1)


def mpc_state(root_euler, root_pos, root_ang_vel, root_lin_vel,
              gravity=P.GRAVITY):
    """Pack the (B, 13) current MPC state (A1RobotControl.cpp:452-456)."""
    g = torch.full(root_pos.shape[:-1] + (1,), -gravity,
                   dtype=root_pos.dtype, device=root_pos.device)
    return torch.cat([root_euler, root_pos, root_ang_vel, root_lin_vel, g],
                     dim=-1)

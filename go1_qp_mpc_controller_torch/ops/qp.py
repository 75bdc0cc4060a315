"""Single-step balance QP (the reference's "QP mode" stance controller).

Port of the JAX package's ``ops/qp.py`` (A1RobotControl.cpp:377-444): a
12-variable / 20-constraint QP per scenario that tracks a PD-derived
6-dim root wrench with world-frame contact forces under a mu = 0.7
friction pyramid, solved cold every tick by the dense ADMM
(``admm.solve``), whose "schulz" KKT inverses run on kernel K3 at n = 12.
Every tensor carries a leading batch axis ``B``.
"""

from typing import NamedTuple

import numpy as np
import torch

from go1_qp_mpc_controller_torch.config import params as P
from go1_qp_mpc_controller_torch.ops import admm
from go1_qp_mpc_controller_torch.utils import rotations
from go1_qp_mpc_controller_torch.utils.device import const


class BalanceQP(NamedTuple):
    hessian: torch.Tensor   # (B, 12, 12)
    gradient: torch.Tensor  # (B, 12)
    lb: torch.Tensor        # (B, 20)
    ub: torch.Tensor        # (B, 20)


def balance_constraint_matrix(mu=P.QP_MU, dtype=np.float64):
    """(20, 12): rows 0-3 extract fz_i; rows 4-19 the friction pyramid
    (A1RobotControl.cpp:28-48)."""
    c = np.zeros((20, 12), dtype)
    for i in range(4):
        c[i, 3 * i + 2] = 1.0
        r = 4 + 4 * i
        c[r + 0, 3 * i + 0] = 1.0
        c[r + 0, 3 * i + 2] = -mu
        c[r + 1, 3 * i + 0] = -1.0
        c[r + 1, 3 * i + 2] = -mu
        c[r + 2, 3 * i + 1] = 1.0
        c[r + 2, 3 * i + 2] = -mu
        c[r + 3, 3 * i + 1] = -1.0
        c[r + 3, 3 * i + 2] = -mu
    return c


_C_FLAT = tuple(balance_constraint_matrix().ravel())


def desired_root_acc(ctrl, params, mass):
    """PD 6-dim wrench target + gravity feedforward (A1RobotControl.cpp:
    378-391): (B, 6) [linear force (world), angular moment]."""
    euler_err = ctrl.root_euler_d - ctrl.root_euler
    yaw_err = rotations.wrap_yaw_error(ctrl.root_euler_d[:, 2],
                                       ctrl.root_euler[:, 2])
    euler_err = torch.cat([euler_err[:, :2], yaw_err[:, None]], dim=-1)
    rot = ctrl.root_rot_mat
    rot_t = rot.transpose(-1, -2)
    mv = lambda a, v: (a @ v[..., None])[..., 0]
    lin = params.kp_linear * (ctrl.root_pos_d - ctrl.root_pos)
    lin = lin + mv(rot, params.kd_linear * (ctrl.root_lin_vel_d
                                            - mv(rot_t, ctrl.root_lin_vel)))
    lin = torch.cat([lin[:, :2], lin[:, 2:] + mass * P.GRAVITY], dim=-1)
    ang = params.kp_angular * euler_err
    ang = ang + params.kd_angular * (ctrl.root_ang_vel_d
                                     - mv(rot_t, ctrl.root_ang_vel))
    return torch.cat([lin, ang], dim=-1)


def build_balance_qp(root_acc, root_rot_mat_z, foot_pos_abs, contacts,
                     q_weights=None, r_weight=P.QP_R_WEIGHT,
                     f_min=P.QP_F_MIN, f_max=P.QP_F_MAX):
    """Assemble the balance QPs (A1RobotControl.cpp:393-413): the (6, 12)
    map M has identity force blocks and yaw-frame torque arms
    Rz' skew(r_i); hessian = r I + M' Q M, gradient = -M' Q acc.

    Args:
      root_acc: (B, 6) desired wrench; root_rot_mat_z: (B, 3, 3);
      foot_pos_abs: (B, 4, 3); contacts: (B, 4) bool, scales the fz box.
    """
    dtype, device = root_acc.dtype, root_acc.device
    batch = root_acc.shape[0]
    if q_weights is None:
        q_weights = const(P.QP_Q_WEIGHTS, dtype, device)
    arms = (root_rot_mat_z.transpose(-1, -2)[:, None]
            @ rotations.skew(foot_pos_abs))                 # (B, 4, 3, 3)
    eye = torch.eye(3, dtype=dtype, device=device)
    m_mat = torch.cat([eye.repeat(1, 4).expand(batch, 3, 12),
                       arms.transpose(1, 2).reshape(batch, 3, 12)], dim=1)
    mq = m_mat * q_weights[:, None]
    hessian = (r_weight * torch.eye(12, dtype=dtype, device=device)
               + m_mat.transpose(-1, -2) @ mq)
    gradient = -(mq.transpose(-1, -2) @ root_acc[..., None])[..., 0]
    c = contacts.to(dtype)
    inf = torch.full((batch, 16), float("inf"), dtype=dtype, device=device)
    lb = torch.cat([f_min * c, -inf], dim=-1)
    ub = torch.cat([f_max * c, torch.zeros_like(inf)], dim=-1)
    return BalanceQP(hessian=hessian, gradient=gradient, lb=lb, ub=ub)


def solve_balance_qp(qp, settings=admm.ADMMSettings()):
    """Solve via the dense ADMM; returns (world-frame forces (B, 4, 3),
    ADMMSolution). The constraint operators take float64 operands too
    (``refine_f64``)."""
    c_mat = const(_C_FLAT, qp.hessian.dtype, qp.hessian.device).reshape(
        20, 12)
    c_of = lambda t: c_mat.to(t.dtype)

    def matvec(u):
        return u @ c_of(u).T

    def rmatvec(y):
        return y @ c_of(y)

    def dense(w):
        c = c_of(w)
        return c.T @ (w[..., :, None] * c)

    sol = admm.solve(qp.hessian, qp.gradient, qp.lb, qp.ub, matvec, rmatvec,
                     dense, settings)
    return sol.x.reshape(-1, 4, 3), sol

"""18-state / 28-measurement Kalman-filter state estimator (A1BasicEKF.cpp:
7-164), batch first. State x = (root pos 3, root vel 3, foot positions
4x3); measurements are the 4 body->foot FK vectors, 4 leg-odometry
velocities and 4 foot heights, with contact-weighted noise inflation (x1001
for swing legs). The innovation matrix is inverted by the scaled
Newton-Schulz schedule at ``_scaled_schulz_coeffs(1e-5)`` (K4's plain
version) and the covariance takes the Joseph form: the EKF half of K2's
plain version (``ops/observe_ekf.py``).
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from reference.go1.config.params import EKF_GRAVITY
from reference.go1.ops import admm, kkt_schulz
from reference.go1.utils import rotations
from reference.go1.utils.device import const

STATE_SIZE = 18
MEAS_SIZE = 28
# noise constants (A1BasicEKF.h:16-21)
PROCESS_NOISE_PIMU = 0.01
PROCESS_NOISE_VIMU = 0.01
PROCESS_NOISE_PFOOT = 0.01
SENSOR_NOISE_PIMU_REL_FOOT = 0.001
SENSOR_NOISE_VIMU_REL_FOOT = 0.1
SENSOR_NOISE_ZFOOT = 0.001
# lower spectral edge of the innovation inverse's Schulz schedule: the
# balanced innovation matrix has cond ~1.3e3 on the controller presets
SINV_L0 = 1e-5


class EKFResult(NamedTuple):
    x: torch.Tensor                   # (B, 18) posterior state
    P: torch.Tensor                   # (B, 18, 18) posterior covariance
    estimated_contacts: torch.Tensor  # (B, 4) in [0, 1]


def _measurement_matrix():
    """Fixed C (A1BasicEKF.cpp:11-17) as float64 numpy."""
    c = np.zeros((MEAS_SIZE, STATE_SIZE))
    for i in range(4):
        c[3 * i:3 * i + 3, 0:3] = -np.eye(3)
        c[3 * i:3 * i + 3, 6 + 3 * i:9 + 3 * i] = np.eye(3)
        c[12 + 3 * i:15 + 3 * i, 3:6] = np.eye(3)
        c[24 + i, 6 + 3 * i + 2] = 1.0
    return c


_C = _measurement_matrix()


@functools.lru_cache(maxsize=None)
def _c_on(dtype, device):
    return torch.as_tensor(_C).to(device=device, dtype=dtype)


def innovation_inverse(s_mat):
    """The (B, 28, 28) innovation inverse by the scaled Newton-Schulz
    schedule at ``_scaled_schulz_coeffs(SINV_L0)``."""
    coeffs = admm._scaled_schulz_coeffs(SINV_L0)
    return kkt_schulz.schulz_balanced_plain(s_mat, None, tuple(coeffs))


class Predicted(NamedTuple):
    """A KF update's operands before the innovation inverse."""
    xbar: torch.Tensor      # (B, 18) predicted state
    pbar: torch.Tensor      # (B, 18, 18) predicted covariance
    err: torch.Tensor       # (B, 28) measurement residual
    r_diag: torch.Tensor    # (B, 28) measurement noise
    est_c: torch.Tensor     # (B, 4) contact weights in [0, 1]
    s_mat: torch.Tensor     # (B, 28, 28) innovation matrix


def predict(x, P, dt, root_rot_mat, imu_acc, imu_ang_vel, foot_pos_rel,
            foot_vel_rel, foot_force, movement_mode, assume_flat_ground=True,
            contact_force_norm=100.0):
    """The KF predict step and the measurement residual
    (A1BasicEKF.cpp:70-128): everything of :func:`update_estimation` up to
    the innovation inverse. Same arguments, except that ``dt`` may also be
    a 0-d tensor on ``x``'s device (the estimator's CUDA graph reads it from
    its input); returns :class:`Predicted`."""
    dtype, device = x.dtype, x.device
    batch = x.shape[0]
    c_mat = _c_on(dtype, device)
    ones3 = torch.ones((batch, 3), dtype=dtype, device=device)

    # contact estimate (A1BasicEKF.cpp:79-86)
    contacts_walk = torch.clamp(foot_force / contact_force_norm, 0.0, 1.0)
    est_c = torch.where((movement_mode == 0)[:, None],
                        torch.ones_like(contacts_walk), contacts_walk)
    infl = 1.0 + (1.0 - est_c) * 1e3            # (B, 4)
    # each leg's entry three times (a copy, no data-dependent size: the
    # estimator's CUDA graph captures it)
    rep3 = lambda a: a[..., None].expand(batch, 4, 3).reshape(batch, 12)

    # process model (A1BasicEKF.cpp:72-95)
    a_mat = torch.eye(STATE_SIZE, dtype=dtype, device=device)
    a_mat[0:3, 3:6] = dt * torch.eye(3, dtype=dtype, device=device)
    q_diag = torch.cat([
        ones3 * (PROCESS_NOISE_PIMU * dt / 20.0),
        ones3 * (PROCESS_NOISE_VIMU * dt * 9.8 / 20.0),
        rep3(infl * dt * PROCESS_NOISE_PFOOT)], dim=-1)

    # measurement noise (A1BasicEKF.cpp:27-31, 49-53, 98-106)
    r_z = (infl * SENSOR_NOISE_ZFOOT if assume_flat_ground
           else torch.full_like(infl, 1e5))
    r_diag = torch.cat([rep3(infl * SENSOR_NOISE_PIMU_REL_FOOT),
                        rep3(infl * SENSOR_NOISE_VIMU_REL_FOOT), r_z], dim=-1)

    # predict (A1BasicEKF.cpp:110-112); B u feeds the velocity rows only
    u = ((root_rot_mat @ imu_acc[..., None])[..., 0]
         + const((0.0, 0.0, -EKF_GRAVITY), dtype, device))
    xbar = x @ a_mat.T
    xbar = torch.cat([xbar[:, 0:3], xbar[:, 3:6] + dt * u, xbar[:, 6:]],
                     dim=-1)
    pbar = a_mat @ P @ a_mat.T + torch.diag_embed(q_diag)

    # measurements (A1BasicEKF.cpp:115-128)
    rot_t = root_rot_mat.transpose(-1, -2)
    fk_world = foot_pos_rel @ rot_t                              # (B, 4, 3)
    omega_skew = rotations.skew(imu_ang_vel)
    leg_v = -foot_vel_rel - foot_pos_rel @ omega_skew.transpose(-1, -2)
    vel_meas = ((1.0 - est_c)[..., None] * x[:, None, 3:6]
                + est_c[..., None] * (leg_v @ rot_t))
    height_meas = (1.0 - est_c) * (x[:, 2:3] + foot_pos_rel[..., 2])
    y = torch.cat([fk_world.reshape(batch, 12), vel_meas.reshape(batch, 12),
                   height_meas], dim=-1)
    s_mat = c_mat @ pbar @ c_mat.T + torch.diag_embed(r_diag)
    return Predicted(xbar=xbar, pbar=pbar, err=y - xbar @ c_mat.T,
                     r_diag=r_diag, est_c=est_c,
                     s_mat=0.5 * (s_mat + s_mat.transpose(-1, -2)))


def correct(pred, s_inv):
    """The KF update from :func:`predict`'s operands and the innovation
    inverse (A1BasicEKF.cpp:130-147): gain, state, Joseph-form covariance
    and the xy covariance surgery. Returns :class:`EKFResult`."""
    pbar, r_diag = pred.pbar, pred.r_diag
    dtype, device = pbar.dtype, pbar.device
    c_mat = _c_on(dtype, device)
    eye18 = torch.eye(STATE_SIZE, dtype=dtype, device=device)
    k_gain = pbar @ c_mat.T @ s_inv                              # (B, 18, 28)
    x_new = pred.xbar + (k_gain @ pred.err[..., None])[..., 0]
    # Joseph form: PSD for any gain, robust to the Schulz residual
    ikc = eye18 - k_gain @ c_mat
    p_new = (ikc @ pbar @ ikc.transpose(-1, -2)
             + k_gain @ torch.diag_embed(r_diag) @ k_gain.transpose(-1, -2))
    return _finish(x_new, p_new, pred.est_c)


def _finish(x_new, p_new, est_c):
    """Symmetrize the posterior covariance and apply the xy covariance
    surgery."""
    dtype, device = p_new.dtype, p_new.device
    p_new = 0.5 * (p_new + p_new.transpose(-1, -2))

    # xy-position covariance surgery (A1BasicEKF.cpp:143-147), branchless
    det2 = p_new[:, 0, 0] * p_new[:, 1, 1] - p_new[:, 0, 1] * p_new[:, 1, 0]
    mask = torch.ones((STATE_SIZE, STATE_SIZE), dtype=dtype, device=device)
    mask[0:2, 2:] = 0.0
    mask[2:, 0:2] = 0.0
    mask[0:2, 0:2] = 0.1
    p_new = torch.where((det2 > 1e-6)[:, None, None], p_new * mask, p_new)
    return EKFResult(x=x_new, P=p_new, estimated_contacts=est_c)


def update_estimation(x, P, dt, root_rot_mat, imu_acc, imu_ang_vel,
                      foot_pos_rel, foot_vel_rel, foot_force, movement_mode,
                      assume_flat_ground=True, contact_force_norm=100.0):
    """One KF predict + update tick (A1BasicEKF.cpp:70-164), batch first:
    :func:`predict`, then the innovation inverse and :func:`correct`.

    Args:
      x: (B, 18); P: (B, 18, 18); dt: step length (float, or a 0-d
        tensor on x's device).
      root_rot_mat: (B, 3, 3); imu_acc, imu_ang_vel: (B, 3).
      foot_pos_rel, foot_vel_rel: (B, 4, 3) body-frame FK.
      foot_force: (B, 4); movement_mode: (B,) int, 0 = stand.
      contact_force_norm: full-contact force scale (100 for A1 units).

    Returns:
      :class:`EKFResult` (x (B, 18), P (B, 18, 18), estimated_contacts
      (B, 4) in [0, 1]).
    """
    pred = predict(x, P, dt, root_rot_mat, imu_acc, imu_ang_vel,
                   foot_pos_rel, foot_vel_rel, foot_force, movement_mode,
                   assume_flat_ground, contact_force_norm)
    return correct(pred, innovation_inverse(pred.s_mat))

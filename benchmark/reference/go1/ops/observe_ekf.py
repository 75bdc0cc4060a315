"""K2's plain version: the whole observe + EKF stage of a controller tick,
per scenario: quat -> rotation, euler and yaw rotation; closed-form leg FK
and Jacobians with foot velocities, world-aligned feet and world angular
velocity; the contact weights; the KF predict step; the 28-dim measurement
and the innovation S = C P C' + R; the scaled Newton-Schulz S^-1; the gain,
state update, Joseph covariance and xy covariance surgery."""

import torch

from reference.go1.models import kinematics
from reference.go1.ops import ekf
from reference.go1.utils import rotations


def observe_ekf(x, P, quat, acc, gyro, qpos, qvel, ffoot, mode, dt,
                rho_opt, rho_fix, contact_force_norm=100.0,
                assume_flat_ground=True):
    """K2's plain version: the observe + EKF stage for a batch, the
    reference composition of the JAX package's
    ``controller._observe_ekf_fn``.

    Args:
      x: (B, 18) prior states; P: (B, 18, 18) covariances.
      quat (B, 4), acc (B, 3), gyro (B, 3), qpos (B, 12), qvel (B, 12),
        ffoot (B, 4): sensors.
      mode: (B,) int32 movement mode (0 = stand).
      dt: step length, a Python float.
      rho_opt, rho_fix: (4, 3) / (4, 5) leg geometry (shared).

    Returns:
      dict of batch-first outputs: rot (B,3,3), euler (B,3), rot_z
      (B,3,3), foot_pos_rel / foot_pos_abs / foot_vel_rel (B,4,3), j_foot
      (B,4,3,3), root_ang_vel (B,3), x (B,18), P (B,18,18), est_contacts
      (B,4) in [0, 1].
    """
    batch = x.shape[0]
    rot = rotations.quat_to_rot_mat(quat)
    euler = rotations.quat_to_euler(quat)
    rot_z = rotations.rot_z(euler[:, 2])
    q_legs = qpos.reshape(batch, 4, 3)
    dq_legs = qvel.reshape(batch, 4, 3)
    fpr = kinematics.fk(q_legs, rho_opt, rho_fix)
    jf = kinematics.jac(q_legs, rho_opt, rho_fix)
    fvr = torch.einsum('blij,blj->bli', jf, dq_legs)
    fpa = fpr @ rot.transpose(-1, -2)
    wav = (rot @ gyro[..., None])[..., 0]      # world frame
    x_new, p_new, est_c = ekf.update_estimation(
        x, P, dt, rot, acc, gyro, fpr, fvr, ffoot, mode,
        assume_flat_ground=assume_flat_ground,
        contact_force_norm=contact_force_norm)
    return {"rot": rot, "euler": euler, "rot_z": rot_z, "foot_pos_rel": fpr,
            "foot_pos_abs": fpa, "foot_vel_rel": fvr, "j_foot": jf,
            "root_ang_vel": wav, "x": x_new, "P": p_new,
            "est_contacts": est_c}

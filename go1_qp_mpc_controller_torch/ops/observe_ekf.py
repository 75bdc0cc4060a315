"""K2: the whole observe + EKF stage of a controller tick, per scenario.

Port of the JAX package's Pallas kernel
``ops/pallas_ekf.py::observe_ekf_lanes`` (``_kernel``, which inlines
``pallas_admm.schulz_lanes_body``). For each scenario it computes
quat -> rotation, euler and yaw rotation; closed-form leg FK and Jacobians
with foot velocities, world-aligned feet and world angular velocity; the
contact weights; the KF predict step; the 28-dim measurement and the
innovation S = C P C' + R; the scaled Newton-Schulz S^-1 (12 steps,
``admm._scaled_schulz_coeffs(1e-5)``); the gain, state update, Joseph
covariance and xy covariance surgery. Its outputs equal the reference
composition of ``controller.sensor_update`` (rotations + kinematics +
``ekf.update_estimation``).

``observe_ekf`` is the entry point: CUDA float32 inputs launch the
hand-written Hopper kernel ``csrc/observe_ekf.cu``; CPU inputs take the
plain PyTorch version ``observe_ekf_plain`` below (any float dtype).
"""

import ctypes
import functools

import torch

from go1_qp_mpc_controller_torch.models import kinematics
from go1_qp_mpc_controller_torch.ops import _build, admm, ekf
from go1_qp_mpc_controller_torch.ops.kkt_schulz import check_cuda_f32
from go1_qp_mpc_controller_torch.utils import rotations

OUTPUTS = (("rot", (3, 3)), ("euler", (3,)), ("rot_z", (3, 3)),
           ("foot_pos_rel", (4, 3)), ("foot_pos_abs", (4, 3)),
           ("foot_vel_rel", (4, 3)), ("j_foot", (4, 3, 3)),
           ("root_ang_vel", (3,)), ("x", (ekf.STATE_SIZE,)),
           ("P", (ekf.STATE_SIZE, ekf.STATE_SIZE)), ("est_contacts", (4,)))
MAX_COEFFS = 32             # schedule capacity of the CUDA kernel

# launches of the CUDA kernel since the last reset (CPU calls do not count)
launches = 0


def reset_launches():
    global launches
    launches = 0


def observe_ekf_plain(x, P, quat, acc, gyro, qpos, qvel, ffoot, mode, dt,
                      rho_opt, rho_fix, contact_force_norm=100.0,
                      assume_flat_ground=True):
    """Plain PyTorch version of K2 (same signature as :func:`observe_ekf`):
    the reference composition of the JAX package's
    ``controller._observe_ekf_fn``."""
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
        contact_force_norm=contact_force_norm, sinv="plain")
    return {"rot": rot, "euler": euler, "rot_z": rot_z, "foot_pos_rel": fpr,
            "foot_pos_abs": fpa, "foot_vel_rel": fvr, "j_foot": jf,
            "root_ang_vel": wav, "x": x_new, "P": p_new,
            "est_contacts": est_c}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("observe_ekf")
    ptr = ctypes.c_void_p
    lib.observe_ekf_launch.argtypes = (
        [ptr] * 11 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        + [ptr] * len(OUTPUTS) + [ctypes.c_int, ptr])
    lib.observe_ekf_launch.restype = ctypes.c_int
    return lib


def observe_ekf(x, P, quat, acc, gyro, qpos, qvel, ffoot, mode, dt,
                rho_opt, rho_fix, contact_force_norm=100.0,
                assume_flat_ground=True):
    """K2 entry point: the observe + EKF stage for a batch.

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
    if x.device.type == "cpu":
        return observe_ekf_plain(x, P, quat, acc, gyro, qpos, qvel, ffoot,
                                 mode, dt, rho_opt, rho_fix,
                                 contact_force_norm, assume_flat_ground)
    batch = x.shape[0]
    ns = ekf.STATE_SIZE
    for name, t, shape in (("x", x, (batch, ns)), ("P", P, (batch, ns, ns)),
                           ("quat", quat, (batch, 4)),
                           ("acc", acc, (batch, 3)),
                           ("gyro", gyro, (batch, 3)),
                           ("qpos", qpos, (batch, 12)),
                           ("qvel", qvel, (batch, 12)),
                           ("ffoot", ffoot, (batch, 4)),
                           ("rho_opt", rho_opt, (4, 3)),
                           ("rho_fix", rho_fix, (4, 5))):
        check_cuda_f32("observe_ekf", name, t, shape)
    if (mode.device != x.device or mode.dtype != torch.int32
            or tuple(mode.shape) != (batch,) or not mode.is_contiguous()):
        raise TypeError("observe_ekf: mode must be a contiguous (B,) int32 "
                        f"tensor on {x.device}")
    outs = {name: torch.empty((batch,) + shape, dtype=torch.float32,
                              device=x.device)
            for name, shape in OUTPUTS}
    if batch == 0:
        return outs
    coeffs = admm._scaled_schulz_coeffs(ekf.SINV_L0)
    if len(coeffs) > MAX_COEFFS:
        raise ValueError("observe_ekf: innovation schedule too long")
    sched = (ctypes.c_float * len(coeffs))(*coeffs)
    rc = _lib().observe_ekf_launch(
        x.data_ptr(), P.data_ptr(), quat.data_ptr(), acc.data_ptr(),
        gyro.data_ptr(), qpos.data_ptr(), qvel.data_ptr(), ffoot.data_ptr(),
        mode.data_ptr(), rho_opt.data_ptr(), rho_fix.data_ptr(),
        float(dt), float(contact_force_norm), int(bool(assume_flat_ground)),
        sched, len(coeffs), *[outs[name].data_ptr() for name, _ in OUTPUTS],
        batch, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"observe_ekf: CUDA launch failed with error {rc}")
    global launches
    launches += 1
    return outs

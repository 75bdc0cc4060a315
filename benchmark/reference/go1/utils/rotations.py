"""Rotation / small linear-algebra utilities.

Port of the JAX package's ``utils/rotations.py`` (Utils.cpp:7-62 of the
reference). All functions take arbitrary leading batch dimensions.
"""

import torch


def quat_to_euler(quat_wxyz):
    """(..., 4) quaternion (w, x, y, z) -> (..., 3) (roll, pitch, yaw),
    the aerospace ZYX extraction of Utils::quat_to_euler."""
    w, x, y, z = quat_wxyz.unbind(-1)
    y_sqr = y * y
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y_sqr))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y_sqr + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def _rows(r00, r01, r02, r10, r11, r12, r20, r21, r22):
    return torch.stack([torch.stack([r00, r01, r02], dim=-1),
                        torch.stack([r10, r11, r12], dim=-1),
                        torch.stack([r20, r21, r22], dim=-1)], dim=-2)


def quat_to_rot_mat(quat_wxyz):
    """(..., 4) quaternion -> (..., 3, 3) body->world rotation; the input
    is normalized first."""
    q = quat_wxyz / torch.linalg.norm(quat_wxyz, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return _rows(1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                 2 * (x * z + w * y),
                 2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                 2 * (y * z - w * x),
                 2 * (x * z - w * y), 2 * (y * z + w * x),
                 1 - 2 * (x * x + y * y))


def rot_z(yaw):
    """(...) yaw -> (..., 3, 3) rotation about +z (root_rot_mat_z)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    return _rows(c, -s, zero, s, c, zero, zero, zero, one)


def skew(vec):
    """(..., 3) -> (..., 3, 3) cross-product matrix (Utils.cpp:35-41)."""
    x, y, z = vec.unbind(-1)
    zero = torch.zeros_like(x)
    return _rows(zero, -z, y, z, zero, -x, -y, x, zero)


def cross(a, b):
    """Cross product over the last axis (broadcasting like jnp.cross)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def solve_3x3(a, b):
    """Solve a x = b for (..., 3, 3) systems via the closed-form adjugate
    (no pivoting; a singular input yields inf/nan, caught by the callers'
    NaN latches as in the reference)."""
    c0 = cross(a[..., 1, :], a[..., 2, :])
    c1 = cross(a[..., 2, :], a[..., 0, :])
    c2 = cross(a[..., 0, :], a[..., 1, :])
    det = torch.sum(a[..., 0, :] * c0, dim=-1, keepdim=True)
    inv_rows = torch.stack([c0, c1, c2], dim=-2) / det[..., None]
    return torch.einsum('...cr,...c->...r', inv_rows, b)


def cal_dihedral_angle(coef_a, coef_b):
    """acos(|a . b| / (|a| |b|)) in [0, pi/2] (Utils.cpp:54-62)."""
    num = torch.abs(torch.sum(coef_a * coef_b, dim=-1))
    den = (torch.linalg.norm(coef_a, dim=-1)
           * torch.linalg.norm(coef_b, dim=-1))
    return torch.arccos(torch.clamp(num / den, -1.0, 1.0))


def wrap_yaw_error(yaw_d, yaw):
    """Shortest-path yaw error (A1RobotControl.cpp:325-332): an error
    beyond +-1.5 pi is shifted by 2 pi toward the current yaw."""
    err = yaw_d - yaw
    two_pi = 2.0 * torch.pi
    err = torch.where(err > 1.5 * torch.pi, err - two_pi, err)
    return torch.where(err < -1.5 * torch.pi, err + two_pi, err)

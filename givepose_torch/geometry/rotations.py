"""Batched rotation representations (PyTorch).

Port of ``givepose_tpu/geometry/rotations.py``: ``get_rot_mat`` and every
representation it dispatches to.  Every function takes arbitrary leading
batch dims and is differentiable.
"""

from __future__ import annotations

import torch


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # torch.maximum, not torch.clamp: jnp.maximum's gradient, 0.5 at a
    # norm of exactly eps
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.maximum(n, n.new_tensor(eps))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _rows_to_mat(r00, r01, r02, r10, r11, r12, r20, r21, r22) -> torch.Tensor:
    row0 = torch.stack([r00, r01, r02], dim=-1)
    row1 = torch.stack([r10, r11, r12], dim=-1)
    row2 = torch.stack([r20, r21, r22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rot6d_to_mat(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation -> (...,3,3); columns x = normalize(a1),
    z = normalize(x cross a2), y = z cross x."""
    x = _normalize(d6[..., 0:3])
    z = _normalize(_cross(x, d6[..., 3:6]))
    y = _cross(z, x)
    return torch.stack((x, y, z), dim=-1)


def rot6d_fixed_y_to_mat(d6: torch.Tensor) -> torch.Tensor:
    """Variant anchoring the y column first."""
    y = _normalize(d6[..., 3:6])
    z = _normalize(_cross(y, d6[..., 0:3]))
    x = _cross(z, y)
    return torch.stack((x, y, z), dim=-1)


def rot6d_fixed_x_to_mat(d6: torch.Tensor) -> torch.Tensor:
    """Same construction as rot6d_to_mat."""
    return rot6d_to_mat(d6)


def rot6d_fixed_z_to_mat(d6: torch.Tensor) -> torch.Tensor:
    """Variant anchoring the z column first."""
    z = _normalize(d6[..., 3:6])
    x = _normalize(_cross(z, d6[..., 0:3]))
    y = _cross(x, z)
    return torch.stack((x, y, z), dim=-1)




def quat_to_mat(quat: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """(w,x,y,z) quaternion (not necessarily unit) -> rotation matrix."""
    q = _normalize(quat, eps)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return _rows_to_mat(
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y))




def euler_to_mat(euler: torch.Tensor) -> torch.Tensor:
    """Euler angles (radians) -> matrix, XZ'Y'' intrinsic:
    R = Rx(e0) @ Rz(e2) @ Ry(e1)."""
    c1, s1 = torch.cos(euler[..., 0]), torch.sin(euler[..., 0])  # X
    c2, s2 = torch.cos(euler[..., 2]), torch.sin(euler[..., 2])  # Z
    c3, s3 = torch.cos(euler[..., 1]), torch.sin(euler[..., 1])  # Y
    return _rows_to_mat(
        c2 * c3, -s2, c2 * s3,
        c1 * s2 * c3 + s1 * s3, c1 * c2, c1 * s2 * s3 - s1 * c3,
        s1 * s2 * c3 - c1 * s3, s1 * c2, s1 * s2 * s3 + c1 * c3)


def axangle_to_mat(axis: torch.Tensor, angle: torch.Tensor,
                   eps: float = 1e-12) -> torch.Tensor:
    """Rodrigues' formula, batched.  axis (...,3), angle (...)."""
    a = _normalize(axis, eps)
    x, y, z = a[..., 0], a[..., 1], a[..., 2]
    c = torch.cos(angle)
    s = torch.sin(angle)
    C = 1 - c
    return _rows_to_mat(
        x * x * C + c, x * y * C - z * s, x * z * C + y * s,
        y * x * C + z * s, y * y * C + c, y * z * C - x * s,
        z * x * C - y * s, z * y * C + x * s, z * z * C + c)


def lie_vec_to_mat(vec: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """so(3) exponential map: (...,3) axis-angle vector -> (...,3,3)."""
    theta = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    safe = torch.maximum(theta, theta.new_tensor(eps))
    return axangle_to_mat(vec / safe, theta[..., 0])


def log_quat_to_mat(log_q: torch.Tensor) -> torch.Tensor:
    """Quaternion exponential then quat->mat: (...,4) -> (...,3,3)."""
    v = log_q[..., 1:]
    mag = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    safe = torch.maximum(mag, mag.new_tensor(1e-8))
    return quat_to_mat(torch.cat([torch.cos(mag), torch.sin(mag) * v / safe],
                                 dim=-1))






def get_rot_mat(rot: torch.Tensor, rot_type: str) -> torch.Tensor:
    """Dispatch on the PoseNet rotation type."""
    if rot_type in ("ego_quat", "allo_quat"):
        return quat_to_mat(rot)
    if rot_type in ("ego_log_quat", "allo_log_quat"):
        return log_quat_to_mat(rot)
    if rot_type in ("ego_lie_vec", "allo_lie_vec"):
        return lie_vec_to_mat(rot)
    if rot_type in ("ego_rot6d", "allo_rot6d", "allo_rot6d_sym"):
        return rot6d_to_mat(rot)
    if rot_type in ("allo_rot6d_sym_y", "allo_rot6d_y"):
        return rot6d_fixed_y_to_mat(rot)
    if rot_type == "allo_rot6d_z":
        return rot6d_fixed_z_to_mat(rot)
    if rot_type == "allo_rot6d_x":
        return rot6d_fixed_x_to_mat(rot)
    if rot_type == "euler":
        return euler_to_mat(rot)
    raise ValueError(f"Wrong pred_rot type: {rot_type}")

"""Rigid transforms (tf2 / pcl_ros::transformPointCloud equivalent).

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/transforms.py``: an
xyzw quaternion plus a translation, applied as one rotate + add.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["RigidTransform", "quat_rotate"]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, written per component."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v[..., 3] by the xyzw quaternion q[4]."""
    u = q[..., :3]
    w = q[..., 3:]
    t = 2.0 * _cross(u.expand_as(v), v)
    return v + w * t + _cross(u.expand_as(t), t)


@dataclasses.dataclass
class RigidTransform:
    """SE(3) transform p' = R(q) p + t."""

    quat_xyzw: torch.Tensor  # [4] float32
    translation: torch.Tensor  # [3] float32

    @classmethod
    def identity(cls, device=None) -> "RigidTransform":
        return cls(
            quat_xyzw=torch.cat([torch.zeros(3, device=device), torch.ones(1, device=device)]),
            translation=torch.zeros(3, dtype=torch.float32, device=device),
        )

    @classmethod
    def from_quat_trans(cls, quat_xyzw, translation, device=None) -> "RigidTransform":
        return cls(
            quat_xyzw=torch.as_tensor(np.asarray(quat_xyzw, np.float32), device=device),
            translation=torch.as_tensor(np.asarray(translation, np.float32), device=device),
        )

    def to(self, device) -> "RigidTransform":
        return RigidTransform(self.quat_xyzw.to(device), self.translation.to(device))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        return quat_rotate(self.quat_xyzw, points) + self.translation

    def inverse(self) -> "RigidTransform":
        qinv = torch.cat([-self.quat_xyzw[:3], self.quat_xyzw[3:]])
        return RigidTransform(quat_xyzw=qinv, translation=-quat_rotate(qinv, self.translation))

"""Rigid transforms (tf2 / pcl_ros::transformPointCloud equivalent).

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/transforms.py``: an
xyzw quaternion plus a translation, applied as one rotate + add.  A
transform may hold one pose (``[4]``, ``[3]``) or one per scan (``[B, 4]``,
``[B, 3]``); ``apply`` broadcasts it over each scan's points.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import fma

__all__ = ["RigidTransform", "quat_rotate"]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis (operands broadcast) as XLA:CPU
    evaluates the reference's ``jnp.cross``: each component's second
    product rounded, its first fused into the subtraction, ``(fma(ay, bz, -(az*by)), fma(az, bx, -(ax*bz)),
    fma(ax, by, -(ay*bx)))``, the three components at once (the rolled
    operands put each component's factors in its place)."""
    a1, a2 = a.roll(-1, -1), a.roll(-2, -1)
    b1, b2 = b.roll(-1, -1), b.roll(-2, -1)
    return fma(a1, b2, -(a2 * b1))


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v[..., 3] by the xyzw quaternion q[..., 4] (the two
    broadcast over their leading axes): the reference's
    ``v + w*t + cross(u, t)`` as XLA:CPU evaluates it, ``w*t`` fused into
    the first add."""
    u = q[..., :3]
    w = q[..., 3:]
    t = 2.0 * _cross(u, v)
    return fma(w, t, v) + _cross(u, t)


@dataclasses.dataclass
class RigidTransform:
    """SE(3) transform p' = R(q) p + t."""

    quat_xyzw: torch.Tensor  # [4] or [B, 4] float32
    translation: torch.Tensor  # [3] or [B, 3] float32

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
        """``points`` [N, 3], or [B, N, 3] with one pose or one per scan."""
        q, t = self.quat_xyzw, self.translation
        if q.dim() > 1:  # a pose per scan: broadcast over the scan's points
            q, t = q[..., None, :], t[..., None, :]
        return quat_rotate(q, points) + t

    def inverse(self) -> "RigidTransform":
        q = self.quat_xyzw
        qinv = torch.cat([-q[..., :3], q[..., 3:]], dim=-1)
        return RigidTransform(quat_xyzw=qinv, translation=-quat_rotate(qinv, self.translation))

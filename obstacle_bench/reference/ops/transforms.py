"""Rigid transforms (tf2 / pcl_ros::transformPointCloud equivalent).

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/transforms.py``: an
xyzw quaternion plus a translation, applied as one rotate + add.  A
transform may hold one pose (``[4]``, ``[3]``) or one per scan (``[B, 4]``,
``[B, 3]``); ``apply`` broadcasts it over each scan's points.

Each function is written as XLA:CPU evaluates the reference's (read off
its optimized HLO and probed on seeded poses): where a product feeds an
add, the chain is an ``ops.fma``, so the port's results are bitwise the
reference's jitted ones (``tests/test_torch_node.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import fma, sqrt32

__all__ = ["RigidTransform", "quat_rotate", "quat_to_matrix"]


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


def _norm4(q: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(q, axis=-1)`` of xyzw quaternions as XLA:CPU
    evaluates it: the squares summed in order, each fused into the add,
    ``sqrt(fma(w, w, fma(z, z, fma(y, y, x * x))))``."""
    x, y, z, w = q.unbind(-1)
    return sqrt32(fma(w, w, fma(z, z, fma(y, y, x * x))))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """xyzw quaternion(s) ``[..., 4]`` -> rotation matrices ``[..., 3, 3]``
    (tf::Quaternion convention), normalized first.  Each entry's
    ``a*b +- c*d`` is ``fma(a, b, +-(c*d))``: XLA:CPU fuses the first
    product into the add (the doubling and ``1 -`` are exact)."""
    q = q / _norm4(q)[..., None]
    x, y, z, w = q.unbind(-1)

    def pair(a, b, c, d, sign):  # a*b + sign * c*d, the first product fused
        return fma(a, b, sign * (c * d))

    rows = (
        (1 - 2 * pair(y, y, z, z, 1), 2 * pair(x, y, w, z, -1), 2 * pair(x, z, w, y, 1)),
        (2 * pair(x, y, w, z, 1), 1 - 2 * pair(x, x, z, z, 1), 2 * pair(y, z, w, x, -1)),
        (2 * pair(x, z, w, y, -1), 2 * pair(y, z, w, x, 1), 1 - 2 * pair(x, x, y, y, 1)),
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


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

    @classmethod
    def from_matrix(cls, m) -> "RigidTransform":
        """From a 4x4 (or 3x4) homogeneous matrix, or a stack ``[..., 4, 4]``
        of them: Shepperd's method, branch-free through the signs of the
        off-diagonal differences, as the reference writes it (its sums
        are plain adds; only the final norm fuses, ``_norm4``)."""
        m = torch.as_tensor(m, dtype=torch.float32)
        r, t = m[..., :3, :3], m[..., :3, 3]
        r00, r11, r22 = r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]
        zero = torch.zeros((), dtype=torch.float32)

        def root(v):  # sqrt(max(0, v)) / 2
            return sqrt32(torch.maximum(zero, v)) / 2

        qw = root(1 + ((r00 + r11) + r22))
        qx = torch.copysign(root(((1 + r00) - r11) - r22), r[..., 2, 1] - r[..., 1, 2])
        qy = torch.copysign(root(((1 - r00) + r11) - r22), r[..., 0, 2] - r[..., 2, 0])
        qz = torch.copysign(root(((1 - r00) - r11) + r22), r[..., 1, 0] - r[..., 0, 1])
        q = torch.stack([qx, qy, qz, qw], dim=-1)
        return cls(quat_xyzw=q / _norm4(q)[..., None], translation=t.contiguous())

    def matrix(self) -> torch.Tensor:
        """The 4x4 homogeneous matrix ``[..., 4, 4]``."""
        q = self.quat_xyzw
        m = torch.zeros((*q.shape[:-1], 4, 4), dtype=torch.float32, device=q.device)
        m[..., :3, :3] = quat_to_matrix(q)
        m[..., :3, 3] = self.translation
        m[..., 3, 3] = 1.0
        return m

    def compose(self, other: "RigidTransform") -> "RigidTransform":
        """self ∘ other: apply ``other`` first, then ``self``.  Each component
        of the Hamilton product sums four products in the reference's order;
        XLA:CPU rounds the second and fuses the other three,
        ``fma(p3, fma(p2, fma(p0, p1)))``."""
        x1, y1, z1, w1 = self.quat_xyzw.unbind(-1)
        x2, y2, z2, w2 = other.quat_xyzw.unbind(-1)
        q = torch.stack(
            [
                fma(-z1, y2, fma(y1, z2, fma(w1, x2, x1 * w2))),
                fma(z1, x2, fma(y1, w2, fma(w1, y2, -(x1 * z2)))),
                fma(z1, w2, fma(-y1, x2, fma(w1, z2, x1 * y2))),
                fma(-z1, z2, fma(-y1, y2, fma(w1, w2, -(x1 * x2)))),
            ],
            dim=-1,
        )
        # self.apply(other.translation), pose by pose
        t = quat_rotate(self.quat_xyzw, other.translation) + self.translation
        return RigidTransform(quat_xyzw=q, translation=t)

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

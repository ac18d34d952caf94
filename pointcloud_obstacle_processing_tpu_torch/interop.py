"""Carry the reference package's state across to the port.

The pipeline has no weights; what both sides must share to compute the same
thing is the configuration, the input cloud and the sensor pose.  The
reference side hands them over as plain Python and NumPy values (a
``dataclasses.asdict`` of its ``PipelineConfig``, the cloud's ``points`` and
``valid`` arrays, the pose's quaternion and translation), so this module
needs no JAX.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import numpy as np

from . import _build
from .config import PipelineConfig
from .ops.transforms import RigidTransform
from .types import Cloud

__all__ = ["from_reference", "ReferenceState"]


class ReferenceState(NamedTuple):
    config: PipelineConfig | None
    cloud: Cloud | None
    pose: RigidTransform | None


def from_reference(
    config: Mapping[str, Any] | None = None,
    points: np.ndarray | None = None,
    valid: np.ndarray | None = None,
    quat_xyzw: np.ndarray | None = None,
    translation: np.ndarray | None = None,
    device="cuda",
) -> ReferenceState:
    """Build the port's config, cloud and pose from the reference's state.

    Any part may be omitted (it comes back as None).  ``valid`` defaults to
    all-True for the given points; a pose needs both its quaternion and its
    translation.  Tensors go to the card unless ``device`` says otherwise;
    without a card this raises.
    """
    device = _build.resolve_device(device)
    cfg = PipelineConfig(**dict(config)) if config is not None else None
    cloud = None
    if points is not None:
        cloud = Cloud.from_points(np.asarray(points, np.float32), valid, device=device)
    pose = None
    if (quat_xyzw is None) != (translation is None):
        raise ValueError("a pose needs both quat_xyzw and translation")
    if quat_xyzw is not None:
        pose = RigidTransform.from_quat_trans(quat_xyzw, translation, device=device)
    return ReferenceState(config=cfg, cloud=cloud, pose=pose)

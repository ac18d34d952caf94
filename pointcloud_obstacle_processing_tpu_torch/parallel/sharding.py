"""Multi-scan batching.

Counterpart of ``batched_pipeline`` in the reference's
``parallel/sharding.py`` (:69), which ``jax.vmap``s ``process_scan`` over a
leading scan axis: many scans (or sensor heads) in one call.  Here the scan
axis is written out: ``process_scan`` runs every stage on the batch, and
each kernel takes the scan as a grid dimension, one launch a call for the
whole batch.  The multi-device forms of that module (data-parallel over a
mesh, point sharding) are not ported.
"""

from __future__ import annotations

import torch

from ..config import PipelineConfig
from ..ops.ransac import Draw
from ..ops.transforms import RigidTransform
from ..pipeline import process_scan
from ..types import Cloud, PipelineResult

__all__ = ["batched_pipeline"]


def batched_pipeline(config: PipelineConfig):
    """``Cloud[B, N]`` -> ``PipelineResult`` with a leading ``B`` on every
    field.  The callable takes the RANSAC draws (``draw``, [B, K, 3]
    indices a round) or a ``generator`` to make them, and the sensor pose
    (one for all scans, or ``[B]`` poses)."""
    config.validate()

    def fn(clouds: Cloud, draw: Draw | None = None, generator: torch.Generator | None = None,
           sensor_pose: RigidTransform | None = None) -> PipelineResult:
        if clouds.points.dim() != 3:
            raise ValueError(f"batched_pipeline: clouds must be [B, N, 3] (got "
                             f"{tuple(clouds.points.shape)})")
        return process_scan(clouds, config, sensor_pose, draw=draw, generator=generator)

    return fn

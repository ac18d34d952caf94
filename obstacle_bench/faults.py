"""Controls and faults that break the timed path, for showing that the
comparison fails them.

``run.py --fault <name>`` runs a cell with one of these in the program's
place; no run of the benchmark's own takes the option.  Each takes the
batched entry's factory and the configuration and returns the call the
window makes.

* ``bf16_points`` (control): the program computes on its input points
  rounded to bfloat16, the nearest precision below the float32 the
  configuration states;
* ``half_batch``: the first half of the batch run, its outputs handed out
  for the second half too;
* ``altered_answer``: one grid cell of every scan altered where the
  program produced it.
"""

from __future__ import annotations

import dataclasses

import torch


def _take(obj, index: torch.Tensor):
    """Every tensor of a result indexed by ``index`` on its scan axis."""
    if isinstance(obj, torch.Tensor):
        return obj.index_select(0, index.to(obj.device)) if obj.dim() else obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj, **{f.name: _take(getattr(obj, f.name), index) for f in dataclasses.fields(obj)})
    return obj


def bf16_points(factory, cfg):
    fn = factory(cfg)

    def call(clouds, **kw):
        rounded = clouds.points.to(torch.bfloat16).to(torch.float32)
        return fn(dataclasses.replace(clouds, points=rounded), **kw)

    return call


def half_batch(factory, cfg):
    fn = factory(cfg)

    def call(clouds, **kw):
        b = clouds.points.shape[0]
        h = max(b // 2, 1)
        res = fn(dataclasses.replace(clouds, points=clouds.points[:h], valid=clouds.valid[:h]), **kw)
        return _take(res, torch.arange(b) % h)

    return call


def altered_answer(factory, cfg):
    fn = factory(cfg)

    def call(clouds, **kw):
        res = fn(clouds, **kw)
        res.grid.data[:, 0, 0] ^= 1
        return res

    return call


FAULTS = {f.__name__: f for f in (bf16_points, half_batch, altered_answer)}

"""The solver's collective layer across processes — the counterpart of
the reference's psums over the ``data``, ``model`` and ``pod`` mesh
axes when those axes are spread over the ranks of a process group
(``repro_torch.dist.mesh.rank_layout``).

Three operations on one axis's group (``device_mesh.get_group(axis)``):

  ``gather_axis``  every rank's slice, concatenated in rank order: the
                   one-process layout of the axis's shards;
  ``sum_int``      an exact int64 SUM (integer adds commute);
  ``max_all``      a MAX (exact in any order).

On a virtual axis (no ranks on it) or with no layout, each is the
identity.  **The design rule**: a psum site gathers the partials into
the layout the one-process solve already reduces, then applies the same
torch reduction there, so a W-rank solve gives the one-process solve's
bits at the same mesh and seed.  No float ``all_reduce`` is used: its
summation order is the backend's.

The backend is the process group's (``dist.get_backend``): ``nccl``
where each rank has its own card, ``gloo`` otherwise.  In the card's
torch (2.11.0+cu128) ``gloo`` takes CUDA tensors for every collective
used here (``all_gather``, ``all_reduce`` SUM and MAX of int64), as
``scripts/gloo_cuda_probe.py`` shows on the card, so no tensor is staged
through the host by this layer.

``STATS`` counts the layer's calls and bytes sent; with ``STATS["timed"]``
set it also sums their host seconds, each call's clock started after a
``torch.cuda.synchronize()`` (a gloo collective on CUDA tensors waits
for the stream anyway), so the seconds are the collectives' own.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.dist.mesh import RankLayout


STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "timed": False}


def reset_stats(timed: bool = False) -> None:
    """Zero ``STATS``; ``timed`` also sums the calls' seconds."""
    STATS.update(calls=0, bytes=0, seconds=0.0, timed=bool(timed))


def _run(t, fn):
    """Run one collective on ``t``, counted in ``STATS``."""
    timed = STATS["timed"]
    if timed:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
    fn()
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    if timed:
        STATS["seconds"] += time.perf_counter() - t0


def axis_group(lay: RankLayout | None, axis: str):
    """The process group of ``axis``, or None where the axis is virtual."""
    if lay is None or lay.count(axis) == 1:
        return None
    return lay.device_mesh.get_group(axis)


def _all_gather(t, group):
    """Every rank's ``t`` (equal shapes), in rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _run(t, lambda: dist.all_gather(out, t, group=group))
    return out


def gather_axis(t, lay: RankLayout | None, axis: str, dim: int = 0):
    """Every rank's slice of ``t`` along ``axis``, concatenated on
    ``dim`` in rank order — the one-process layout of the axis's shards
    (rank r's slice holds shards [r·S/R, (r+1)·S/R)).  The identity on a
    virtual axis."""
    group = axis_group(lay, axis)
    if group is None:
        return t
    return torch.cat(_all_gather(t, group), dim=dim)


def _reduce(t, lay, axes, op):
    out = t
    for axis in axes:
        group = axis_group(lay, axis)
        if group is None:
            continue
        if out is t:
            out = t.clone()
        _run(out, lambda: dist.all_reduce(out, op=op, group=group))
    return out


def sum_int(t, lay: RankLayout | None, axes=("pod", "data", "model")):
    """The exact SUM of an integer tensor over ``axes`` (int64: integer
    adds commute, so any order gives the same value)."""
    if t.dtype != torch.int64:
        raise TypeError(f"sum_int takes int64, got {t.dtype}")
    return _reduce(t, lay, axes, dist.ReduceOp.SUM)


def max_all(t, lay: RankLayout | None, axes=("pod", "data", "model")):
    """The MAX of ``t`` over ``axes`` (exact in any order)."""
    return _reduce(t, lay, axes, dist.ReduceOp.MAX)

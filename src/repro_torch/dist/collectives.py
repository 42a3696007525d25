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
bits at the same mesh and seed.  No float ``all_reduce`` is used for the
solver: its summation order is the backend's.

The LM stack on a live ``DeviceMesh`` adds three over the whole mesh:
``mesh_gather`` (the top-k codec's candidates), ``mesh_max`` (the int8
codec's scale, the train loop's failure flag) and ``slot_sum`` (an
all-gather, or a gather to one rank, as an integer SUM of disjoint
slots: a checkpoint's leaves, DTensor's staged gathers).  A host-side
value crosses the ranks on ``crossing_device``: the host under gloo, the
mesh's device under a plain nccl group, which takes no CPU tensor.
DTensor's own collectives inside its ops are DTensor's, and
``host_staged`` (below) stands in for the three that crash under gloo
on the card.

The backend is the process group's (``dist.get_backend``): ``nccl``
where each rank has its own card, ``gloo`` otherwise.  In the card's
torch (2.11.0+cu128) ``gloo`` takes CUDA tensors for every plain
collective used here (``all_gather``, ``all_reduce`` SUM and MAX), as
``scripts/gloo_cuda_probe.py`` shows on the card (gloo copies them
through pinned host memory itself).

``STATS`` counts the layer's calls and bytes sent; with ``STATS["timed"]``
set it also sums their host seconds, each call's clock started after a
``torch.cuda.synchronize()`` (a gloo collective on CUDA tensors waits
for the stream anyway), so the seconds are the collectives' own.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

from repro_torch.dist.mesh import RankLayout


STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "timed": False}
# DTensor's collectives that ``host_staged`` ran through gloo's plain
# all-reduce: calls, and bytes of the CUDA tensors they took
STAGED = {"calls": 0, "bytes": 0}


def reset_stats(timed: bool = False) -> None:
    """Zero ``STATS`` and ``STAGED``; ``timed`` also sums the calls'
    seconds."""
    STATS.update(calls=0, bytes=0, seconds=0.0, timed=bool(timed))
    STAGED.update(calls=0, bytes=0)


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


# ------------------------------------------- the LM stack's DeviceMesh ----


def mesh_group(mesh):
    """The group of every rank of ``mesh`` (a live ``DeviceMesh``, which
    ``dist.mesh.make_rank_mesh`` builds over the whole default group),
    or None on a mesh of one rank."""
    if mesh.size() == 1:
        return None
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a DeviceMesh of {mesh.size()} ranks in a world "
                         f"of {dist.get_world_size()}: the LM stack's "
                         f"collectives span the whole mesh")
    return dist.group.WORLD


def crossing_device(mesh) -> str:
    """Where a host-side value (a flag, a codec's candidates, a
    checkpoint's leaf) crosses ``mesh``'s ranks: the host where the
    default group's backend takes CPU tensors (``gloo``, or a
    ``cpu:gloo,cuda:nccl`` pair), else the mesh's device (a plain
    ``nccl`` group takes CUDA tensors only)."""
    return "cpu" if "gloo" in str(dist.get_backend()) else mesh.device_type


def mesh_gather(t, mesh):
    """Every rank's ``t`` (equal shapes) stacked in rank order on a new
    leading dimension, on ``t``'s device; ``t[None]`` on a mesh of one
    rank."""
    group = mesh_group(mesh)
    if group is None:
        return t[None]
    parts = _all_gather(t.to(crossing_device(mesh)), group)
    return torch.stack(parts).to(t.device)


def mesh_max(t, mesh):
    """The MAX of ``t`` over every rank of ``mesh`` (exact in any
    order), on ``t``'s device."""
    group = mesh_group(mesh)
    if group is None:
        return t
    out = t.to(crossing_device(mesh), copy=True)
    _run(out, lambda: dist.all_reduce(out, op=dist.ReduceOp.MAX,
                                      group=group))
    return out.to(t.device)


_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def slot_sum(part, shape, slot, group, *, dst=None, device=None):
    """A tensor of ``shape`` holding ``part`` where ``slot`` puts it and
    zeros elsewhere, summed as integers over ``group``'s ranks: where
    the ranks' slots are disjoint, every rank's part with its exact bits
    (an all-gather as one all-reduce).  ``slot(buf)`` is the view of
    ``buf`` that takes this rank's part, or None where this rank adds
    nothing (a replica another rank counts).  With ``dst`` (a global
    rank) only ``dst`` receives the sum (a reduce) and every other rank
    an empty tensor.  The buffer lies on ``device`` (``part``'s by
    default); a ``group`` of None is one rank: the buffer as it is."""
    buf = torch.zeros(shape, dtype=part.dtype,
                      device=part.device if device is None else device)
    view = slot(buf)
    if view is not None:
        view.copy_(part)
    if group is None:
        return buf
    bits = buf.view(_INT_VIEW[buf.element_size()])
    if dst is None:
        _run(buf, lambda: dist.all_reduce(bits, op=dist.ReduceOp.SUM,
                                          group=group))
        return buf
    _run(buf, lambda: dist.reduce(bits, dst=dst, op=dist.ReduceOp.SUM,
                                  group=group))
    return buf if dist.get_rank() == dst else buf.new_empty((0,))


# ------------------------------------- DTensor's collectives on the host ----
#
# Two gloo ranks share one card (NCCL refuses two ranks on one device).
# On the card's torch (2.11.0+cu128) gloo takes CUDA tensors for every
# plain collective, copying them through pinned host memory, but kills
# the process in the coalesced forms that DTensor's functional
# collectives reach: the all-gather of a ``Shard → Replicate``, the
# reduce-scatter of a ``Partial → Shard`` and the all-to-all of a
# ``Shard(i) → Shard(j)`` (``scripts/gloo_cuda_probe.py`` on the card).
# ``host_staged`` runs those three through gloo's plain all-reduce
# instead, counted in ``STAGED``: a gather is an integer SUM of a buffer
# that holds each rank's shard in its slot and zeros elsewhere (exact,
# bit for bit; gloo's all-reduce moves bytes faster than its
# all-gather), a reduce-scatter the all-reduce's own slot.

def _process_group(group):
    """A functional collective's ``group`` argument as a process group:
    a (DeviceMesh, mesh dim) pair, a one-dimensional DeviceMesh or a
    process group."""
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    if isinstance(group, dist.ProcessGroup):
        return group
    if hasattr(group, "get_group") and group.ndim == 1:
        return group.get_group()
    raise TypeError(f"host staging takes a (DeviceMesh, dim) pair, a 1-D "
                    f"DeviceMesh or a process group, not {type(group)}")


def _count(t):
    STAGED["calls"] += 1
    STAGED["bytes"] += t.numel() * t.element_size()


def _staged_gather(t, gather_dim, group):
    """Every rank's ``t`` concatenated on ``gather_dim`` in rank order:
    ``slot_sum`` with this rank's slot along that dimension."""
    _count(t)
    pg = _process_group(group)
    n = t.shape[gather_dim]
    shape = (*t.shape[:gather_dim], pg.size() * n, *t.shape[gather_dim + 1:])
    return slot_sum(t, shape, lambda buf: buf.narrow(
        gather_dim, pg.rank() * n, n), pg)


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
               "product": dist.ReduceOp.PRODUCT}


def _staged_reduce_scatter(t, reduce_op, scatter_dim, group):
    _count(t)
    pg = _process_group(group)
    op = str(reduce_op).lower()
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_REDUCE_OPS[op], group=pg)
    if op == "avg":
        out = out / pg.size()
    return out.chunk(pg.size(), dim=scatter_dim)[pg.rank()].contiguous()


def _staged_alltoall(t, gather_dim, shard_dim, mesh, mesh_dim):
    full = _staged_gather(t, gather_dim, (mesh, mesh_dim))
    return torch.chunk(full, mesh.size(mesh_dim), dim=shard_dim)[
        mesh.get_local_rank(mesh_dim)].contiguous()


@contextlib.contextmanager
def host_staged(mesh):
    """Within: DTensor's all-gather, reduce-scatter and all-to-all of
    CUDA tensors on ``mesh`` go through gloo's plain all-reduce (see
    above), the same values in the same layout; any other tensor takes
    torch's own path.
    Only a ``cuda`` DeviceMesh under a ``gloo`` group is staged;
    anywhere else the context does nothing."""
    if (mesh is None or getattr(mesh, "device_type", None) != "cuda"
            or not dist.is_initialized() or dist.get_backend() != "gloo"):
        yield
        return
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import _collective_utils, placement_types

    def gathered(orig):
        def fn(self, gather_dim, group, tag=""):
            if not self.is_cuda:
                return orig(self, gather_dim, group, tag)
            return _staged_gather(self, gather_dim, group)
        return fn

    def scattered(orig):
        def fn(self, reduceOp, scatter_dim, group, tag=""):
            if not self.is_cuda:
                return orig(self, reduceOp, scatter_dim, group, tag)
            return _staged_reduce_scatter(self, reduceOp, scatter_dim, group)
        return fn

    def alltoall(orig):
        def fn(input, gather_dim, shard_dim, mesh, mesh_dim):
            if not input.is_cuda:
                return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
            return _staged_alltoall(input, gather_dim, shard_dim, mesh,
                                    mesh_dim)
        return fn

    wraps = [(funcol, n, gathered) for n in ("all_gather_tensor",
                                              "all_gather_single")]
    wraps += [(funcol, n, scattered) for n in ("reduce_scatter_tensor",
                                                "reduce_scatter_single")]
    wraps += [(m, "shard_dim_alltoall", alltoall)
              for m in (_collective_utils, placement_types)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in wraps if hasattr(m, n)]
    if not any(n.startswith("all_gather") for _, n, _ in saved) or not any(
            n.startswith("reduce_scatter") for _, n, _ in saved):
        raise RuntimeError("this torch's functional collectives have none "
                           "of the all-gather or reduce-scatter entries "
                           "host staging replaces")
    make = {n: w for _, n, w in wraps}
    for m, n, orig in saved:
        setattr(m, n, make[n](orig))
    try:
        yield
    finally:
        for m, n, orig in saved:
            setattr(m, n, orig)

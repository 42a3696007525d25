"""Roofline terms of one device's share of a step, counted at dispatch
(the counterpart of ``repro/launch/roofline.py``).

  compute term    = FLOPs_per_device / peak_FLOP/s
  memory term     = HBM_bytes_per_device / HBM_bw
  collective term = collective_bytes_per_device / (links × link_bw)

The reference parses the post-SPMD HLO of a compiled step.  The port
runs the step eagerly on meta tensors — shapes, no storage — under
``OpCounter``, a ``TorchDispatchMode`` that sits *below* DTensor: it
declines every DTensor-level op, so DTensor dispatches it, and then
counts the local ops DTensor runs on this device's shards and the
functional collectives it issues.  DTensor's sharding propagation runs
its ops on fake tensors; they are not counted.  A Python loop over
layers or groups runs its body once a trip, so trip counts multiply by
construction.

  * FLOPs: 2·∏(result)·∏(contraction) for every matmul-class aten op
    (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot`` — an
    einsum or a ``matmul`` reaches dispatch as these — and
    ``convolution``, 2·∏(result)·∏(kernel)·C_in/groups); elementwise
    ops count none (the standard MFU convention, as the reference);
  * HBM bytes: per op, result + operand bytes; views and reshapes move
    nothing; ``copy_`` writes its source into the slice it is given
    (2 × source); ``index_put_``, ``scatter`` and their kin touch only
    the rows they write (2 × values + indices), and ``index``,
    ``gather`` and ``embedding`` only the rows they read (2 × result +
    indices) — the reference's dynamic-(update-)slice rule;
  * collective wire bytes per op (ring algorithms, (N−1)/N ≈ 1):
    all-gather ≈ result, reduce-scatter ≈ result × group, all-reduce ≈
    2 × result, all-to-all / broadcast ≈ result.  On a CPU mesh DTensor
    runs an all-to-all as an all-gather and a chunk; the counter bills
    it as the all-to-all it stands for.

``OpCounter`` also tracks the bytes of the tensors the step creates and
frees (by storage, so a view keeps its base alive): ``temp_peak`` is the
largest sum live at once, the dry-run's ``temp_bytes``.

Hardware constants: the NVIDIA H100 SXM's published figures at 700 W —
989 TFLOP/s dense bf16/fp16, 495 TF32, 67 float32 outside the tensor
cores; 3.35 TB/s HBM3; NVLink 4, 18 links of 25 GB/s each way
(450 GB/s).  ``peak_flops_for`` picks the compute peak from the step's
matmul dtype and ``torch.backends.cuda.matmul.allow_tf32``.  The
production mesh's 256 cards span 32 nodes of 8, and a card's links
across nodes are slower (a 400 Gb/s NIC per card on a DGX H100), so
the collective term, costed at NVLink's rate, is a lower bound.
"""

from __future__ import annotations

import dataclasses
import json
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS_BF16 = 989e12  # dense bf16 / fp16, tensor cores
PEAK_FLOPS_TF32 = 495e12  # dense TF32, tensor cores
PEAK_FLOPS_FP32 = 67e12  # float32 outside the tensor cores
PEAK_FLOPS = PEAK_FLOPS_BF16
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 25e9  # bytes/s per NVLink 4 link, each way
N_LINKS = 18  # NVLink 4 links per H100 SXM


def peak_flops_for(dtype, allow_tf32: bool | None = None) -> float:
    """The compute peak a step's matmuls in ``dtype`` run at:
    bf16/fp16 on the tensor cores; float32 at TF32's rate when
    ``allow_tf32`` (default: ``torch.backends.cuda.matmul.allow_tf32``),
    else outside the tensor cores."""
    if dtype in (torch.bfloat16, torch.float16):
        return PEAK_FLOPS_BF16
    if allow_tf32 is None:
        allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    return PEAK_FLOPS_TF32 if allow_tf32 else PEAK_FLOPS_FP32


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    bytes_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    count_by_kind: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))


aten = torch.ops.aten


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _matmul_flops(func, args, out) -> float:
    """2·∏(result)·∏(contraction) of a matmul-class op, else 0."""
    if func in (aten.mm.default, aten.bmm.default, aten.mv.default):
        return 2.0 * out.numel() * args[0].shape[-1]
    if func in (aten.addmm.default, aten.baddbmm.default):
        return 2.0 * out.numel() * args[1].shape[-1]
    if func is aten.dot.default:
        return 2.0 * args[0].shape[0]
    if func is aten.convolution.default:
        # w: (C_out, C_in/groups, k...): each output sums C_in/groups·∏k
        return 2.0 * out.numel() * _numel(args[1].shape[1:])
    return 0.0


_NO_BYTES = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten._unsafe_view.default, aten.detach.default,
    aten.lift_fresh.default, aten.alias.default,
}
_WRITES_SLICE = {  # (op, index of the values written)
    aten.index_put_.default: 2, aten.index_put.default: 2,
    aten._index_put_impl_.default: 2, aten.scatter.src: 3,
    aten.scatter_.src: 3, aten.scatter_add.default: 3,
    aten.scatter_add_.default: 3, aten.index_add.default: 3,
    aten.index_add_.default: 3, aten.index_copy.default: 3,
    aten.index_copy_.default: 3, aten.select_scatter.default: 1,
    aten.slice_scatter.default: 1,
}
_READS_SLICE = {aten.index.Tensor, aten.index_select.default,
                aten.gather.default, aten.embedding.default}
# functional collective → (kind, wire bytes from (result bytes, group))
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", lambda b, g: b),
    "all_gather_into_tensor_coalesced": ("all-gather", lambda b, g: b),
    "reduce_scatter_tensor": ("reduce-scatter", lambda b, g: b * g),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                        lambda b, g: b * g),
    "all_reduce": ("all-reduce", lambda b, g: 2.0 * b),
    "all_reduce_coalesced": ("all-reduce", lambda b, g: 2.0 * b),
    "all_to_all_single": ("all-to-all", lambda b, g: b),
    "shard_dim_alltoall": ("all-to-all", lambda b, g: b),
    "broadcast": ("collective-permute", lambda b, g: b),
}
_NO_DATA = {"wait_tensor", "_wrap_tensor_autograd"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _nbytes(x) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(x)))


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in rets)


def _is_inplace(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and rets[0].alias_info is not None and \
        rets[0].alias_info.is_write


def _group_size(func, args) -> int:
    for a in args:
        if isinstance(a, int) and not isinstance(a, bool) and a > 0:
            return a
    return 1


class OpCounter(TorchDispatchMode):
    """Counts one device's FLOPs, HBM bytes and collective wire bytes of
    whatever runs under it, below DTensor (see the module's docstring),
    and the peak of the bytes it creates and holds (``temp_peak``)."""

    def __init__(self):
        super().__init__()
        self.stats = OpStats()
        self.temp_live = 0
        self.temp_peak = 0
        self._live: Dict[int, int] = {}
        self._paused = 0
        self._patched = []

    # -------------------------------------------- the all-to-all fallback
    def __enter__(self):
        from torch.distributed.tensor import _collective_utils, placement_types

        original = _collective_utils.shard_dim_alltoall
        counter = self

        def shard_dim_alltoall(input, gather_dim, shard_dim, mesh,
                               mesh_dim):
            counter._paused += 1
            try:
                out = original(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                counter._paused -= 1
            counter._collective("all-to-all", _nbytes(out),
                                _nbytes(input) + _nbytes(out))
            counter._track(out)
            return out

        for mod in (_collective_utils, placement_types):
            self._patched.append((mod, mod.shard_dim_alltoall))
            mod.shard_dim_alltoall = shard_dim_alltoall
        return super().__enter__()

    def __exit__(self, *exc):
        for mod, fn in self._patched:
            mod.shard_dim_alltoall = fn
        self._patched.clear()
        return super().__exit__(*exc)

    # -------------------------------------------------------- the counts
    def _collective(self, kind, wire, hbm):
        st = self.stats
        st.collective_bytes += wire
        st.bytes_by_kind[kind] += wire
        st.count_by_kind[kind] += 1
        st.bytes += hbm

    def _free(self, key):
        self.temp_live -= self._live.pop(key, 0)

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.temp_live += n
            self.temp_peak = max(self.temp_peak, self.temp_live)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented  # DTensor dispatches; its local ops come back
        out = func(*args, **kwargs)
        if self._paused or any(t.__name__ == "FakeTensor" for t in types) \
                or any(type(t).__name__ == "FakeTensor"
                       for t in _tensors(out)):
            return out
        self._count(func, args, kwargs, out)
        if not (_is_view(func) or _is_inplace(func)):
            self._track(out)
        return out

    def _count(self, func, args, kwargs, out):
        st = self.stats
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in ("_c10d_functional", "c10d_functional", "_dtensor"):
            if name in _NO_DATA:
                return
            if name in _COLLECTIVES:
                kind, wire = _COLLECTIVES[name]
                res = _nbytes(out)
                self._collective(kind, wire(res, _group_size(func, args)),
                                 res + _nbytes(args))
            return
        st.flops += _matmul_flops(func, args, out)
        if func in _NO_BYTES or _is_view(func):
            return
        if func in _WRITES_SLICE:
            vals = args[_WRITES_SLICE[func]] if len(args) > \
                _WRITES_SLICE[func] else kwargs.get("values")
            idx = _nbytes(args[1]) if func in (
                aten.index_put_.default, aten.index_put.default,
                aten._index_put_impl_.default) else _nbytes(
                args[2] if len(args) > 2 else ())
            st.bytes += 2.0 * _nbytes(vals) + idx
            return
        if func in _READS_SLICE:
            idx = [a for a in _tensors(args[1:])]
            st.bytes += 2.0 * _nbytes(out) + _nbytes(idx)
            return
        if func in (aten.copy_.default, aten.clone.default,
                    aten._to_copy.default, aten.copy.default):
            st.bytes += 2.0 * _nbytes(out)
            return
        if not any(True for _ in _tensors(args)):  # a factory: it writes
            st.bytes += _nbytes(out)
            return
        st.bytes += _nbytes(out) + _nbytes(args) + _nbytes(
            list(kwargs.values()))


def roofline_report(*, stats: OpStats, n_chips: int,
                    model_flops_total: float, torch_flops: float = 0.0,
                    peak_flops: float = PEAK_FLOPS) -> dict:
    """The reference's report under the H100's constants; ``peak_flops``
    is the step's compute peak (``peak_flops_for``)."""
    t_compute = stats.flops / peak_flops
    t_memory = stats.bytes / HBM_BW
    t_coll = stats.collective_bytes / (N_LINKS * LINK_BW)
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = (
        model_flops_total / (stats.flops * n_chips) if stats.flops else 0.0
    )
    mfu_bound = (
        model_flops_total / n_chips / max(bound, 1e-30) / peak_flops
        if bound else 0.0
    )
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "flops_per_device": stats.flops,
        "bytes_per_device": stats.bytes,
        "collective_bytes_per_device": stats.collective_bytes,
        "collective_bytes_by_kind": dict(stats.bytes_by_kind),
        "collective_count_by_kind": dict(stats.count_by_kind),
        "model_flops_total": model_flops_total,
        "useful_flops_fraction": useful,
        "roofline_mfu_bound": mfu_bound,
        "peak_flops": peak_flops,
        "torch_flop_counter_flops_raw": torch_flops,
    }


def save_report(path, report: dict):
    with open(path, "w") as f:
        json.dump(report, f, indent=2, default=str)

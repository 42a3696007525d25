"""Multi-pod dry-run: count one device's share of every (arch × shape ×
mesh) cell (the counterpart of ``repro/launch/dryrun.py``).

Per cell the dry-run:
  1. builds the production mesh (16×16, or 2×16×16 with --multi-pod) —
     a ``DeviceMesh`` over a ``fake`` process group, this process
     rank 0 (``dist.mesh.make_production_mesh``);
  2. builds the cell's state, batch and cache as meta DTensors with the
     policy's placements (``dist.sharding``), and its step (train_step /
     prefill / decode) with the baseline sharding rules;
  3. runs the step once, eagerly, on those stand-ins under
     ``launch.roofline.OpCounter`` (this device's FLOPs, HBM bytes,
     collective wire bytes and the peak of its live temporaries) and
     ``torch.utils.flop_counter`` above DTensor (the global FLOPs);
     meta tensors hold no storage, so no byte is allocated;
  4. writes the memory figures and the roofline report into
     out/dryrun/<arch>__<shape>__<mesh>__<tag>.json.

The reference lowers and compiles each cell with XLA; its ``lower_s``
and ``compile_s`` become ``build_s`` (the stand-ins and the step) and
``count_s`` (the counted run).  Memory, from the local shards:
``argument_bytes`` the step's inputs, ``output_bytes`` its outputs,
``alias_bytes`` what it donates (the state in train, the cache in
serving — the port's steps update them in place), ``temp_bytes`` the
peak of the bytes the step creates and holds, and ``peak_bytes_est`` =
argument + temp − alias, as the reference computes it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-780m \\
      --shape train_4k --multi-pod
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.configs.shapes import shape_applicable
from repro_torch.dist.mesh import make_production_mesh, mesh_axes
from repro_torch.dist.sharding import (
    ShardingRules,
    cache_shardings,
    param_shardings,
    place,
)
from repro_torch.launch.roofline import (
    OpCounter,
    peak_flops_for,
    roofline_report,
)
from repro_torch.launch.specs import (
    batch_shardings_for,
    batch_specs,
    cache_specs,
)
from repro_torch.models.transformer import cache_max_len, param_specs
from repro_torch.optim.schedules import make_schedule
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.train.step import (
    make_train_step,
    train_state_shardings,
    train_state_specs,
)
from repro_torch.tree import leaves


def microbatches_for(cfg, shape) -> int:
    n = cfg.n_params()
    if n >= 100e9:
        return 8
    if n >= 20e9:
        return 4
    if n >= 5e9:
        return 2
    # small models where activations/vocab dominate HBM
    if cfg.vocab_size > 100_000:
        return 4
    if cfg.family == "ssm":
        return 2
    return 1


def state_dtypes_for(cfg) -> dict:
    big = cfg.n_params() >= 20e9
    return {
        "dtype": torch.bfloat16,
        "m_dtype": torch.bfloat16 if big else torch.float32,
        "v_dtype": torch.float32,
        "master": False,
    }


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D_tokens (train) / 2·N_active·D (fwd)."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n_active * tokens


# ------------------------------------------------------- the stand-ins


def _local_bytes(tree) -> int:
    """One device's bytes of a tree of (DTensor or plain) tensors."""
    total = 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if hasattr(t, "to_local") else t
            total += t.numel() * t.element_size()
    return total


def distribute(specs, shardings):
    """``specs`` (meta tensors) as meta DTensors: each leaf this rank's
    shard under its ``NamedSharding`` (``dist.sharding.place`` of meta
    leaves), nothing allocated.  Non-tensor leaves (a cache's
    ``length``) pass through.  On a mesh of one device the shard is the
    tensor: ``specs`` come back as they are, and the cell runs the plain
    path one card runs."""
    mesh = next(sh.mesh for sh in leaves(shardings) if sh is not None)
    if math.prod(mesh_axes(mesh).values()) == 1:
        return specs
    return place(specs, shardings)


class Lowering(NamedTuple):
    """A cell ready to count: ``fn(*args)`` on meta DTensors; ``alias``
    is the part of ``args`` the step donates (updates in place)."""

    fn: Callable
    args: tuple
    alias: Any
    matmul_dtype: torch.dtype


def build_train_lowering(cfg, shape, mesh, *, microbatches=None,
                         rules=None, fsdp=True, zero1=True, dtypes=None):
    rules = rules or ShardingRules(mesh=mesh)
    mb = microbatches or microbatches_for(cfg, shape)
    schedule = make_schedule("cosine", peak_lr=3e-4, total_steps=10_000,
                             warmup_steps=100)
    dts = dtypes or state_dtypes_for(cfg)
    specs = train_state_specs(cfg, **dts)
    specs = specs._replace(opt=specs.opt._replace(master=None),
                           compress=None)
    sh = train_state_shardings(cfg, mesh, specs, fsdp=fsdp, zero1=zero1)
    step = make_train_step(cfg, schedule=schedule, rules=rules,
                           microbatches=mb, remat=True,
                           acc_shardings=(sh.opt.m if (zero1 and mb > 1)
                                          else None))
    state = distribute(specs, sh)
    batch = distribute(batch_specs(cfg, shape),
                       batch_shardings_for(cfg, shape, mesh))
    return Lowering(step, (state, batch), state, dts["dtype"])


def _serve_inputs(cfg, shape, mesh, fsdp):
    p_specs = param_specs(cfg, torch.bfloat16)
    params = distribute(p_specs, param_shardings(cfg, mesh, p_specs,
                                                 fsdp=fsdp))
    batch = distribute(batch_specs(cfg, shape),
                       batch_shardings_for(cfg, shape, mesh))
    c_specs = cache_specs(cfg, shape)
    cache = distribute(c_specs, cache_shardings(cfg, mesh, c_specs,
                                                shape.global_batch))
    return params, batch, cache


def build_prefill_lowering(cfg, shape, mesh, *, microbatches=None,
                           rules=None, fsdp=True, dtypes=None):
    del microbatches, dtypes
    rules = rules or ShardingRules(mesh=mesh)
    params, batch, cache = _serve_inputs(cfg, shape, mesh, fsdp)
    return Lowering(make_prefill_step(cfg, rules), (params, batch, cache),
                    cache, torch.bfloat16)


def build_decode_lowering(cfg, shape, mesh, *, microbatches=None,
                          rules=None, fsdp=True, dtypes=None):
    del microbatches, dtypes
    rules = rules or ShardingRules(mesh=mesh)
    params, batch, cache = _serve_inputs(cfg, shape, mesh, fsdp)
    # one new token after the seq_len the cache holds
    cache = cache._replace(length=shape.seq_len)
    assert shape.seq_len < cache_max_len(shape.seq_len)
    return Lowering(make_decode_step(cfg, rules), (params, batch, cache),
                    cache, torch.bfloat16)


BUILDERS = {
    "train": build_train_lowering,
    "prefill": build_prefill_lowering,
    "decode": build_decode_lowering,
}


# the cost a strategy is charged for each mesh dim it changes, where
# DTensor would plan the change by its graph search (see below); DTensor's
# own costs are of order 1–1000 (microseconds on its link model)
_SEARCHED_COST = 1e6


@contextlib.contextmanager
def quick_strategy_costs():
    """DTensor picks each op's strategy by the cost of redistributing its
    inputs into each candidate.  Where a spec holds a strided shard or a
    non-default shard order — a tensor dim split over two or three mesh
    dims that a reshape merged — it plans each such cost by a search over
    a graph of placements, for every candidate of every op: minutes a
    cell on a 3-D mesh.  Here such a candidate is charged
    ``_SEARCHED_COST`` a changed mesh dim instead, which steers DTensor
    to the candidates it can cost directly; the redistributions it then
    runs are planned by DTensor as always."""
    try:
        from torch.distributed.tensor import _redistribute as R
        from torch.distributed.tensor._dtensor_spec import DTensorSpec
        from torch.distributed.tensor._ops import utils as U

        exact = U.redistribute_cost
        strided = R._StridedShard
    except (ImportError, AttributeError):  # another torch: costs as they are
        yield
        return

    def direct(spec):
        return DTensorSpec.is_default_device_order(spec.shard_order) and \
            not any(isinstance(p, strided) for p in spec.placements)

    def cost(current, target):
        if direct(current) and direct(target):
            return exact(current, target)
        return _SEARCHED_COST * sum(
            a != b for a, b in zip(current.placements, target.placements))

    U.redistribute_cost = cost
    try:
        yield
    finally:
        U.redistribute_cost = exact


def count_lowering(low: Lowering):
    """Run the cell once under the counters: (outputs, ``OpCounter``,
    ``torch.utils.flop_counter``'s global FLOPs)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    # the flop counter above DTensor (entered last, so it sees each op
    # first), the OpCounter below it
    with quick_strategy_costs(), implicit_replication(), \
            OpCounter() as oc, FlopCounterMode(display=False) as fc:
        out = low.fn(*low.args)
    return out, oc, float(fc.get_total_flops())


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh_axes(mesh).values())


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: str = "", microbatches=None, fsdp=True, rules=None,
             tag="baseline", cfg_overrides=None, zero1=True, cfg=None,
             shape=None, mesh=None, dtypes=None) -> dict:
    """One cell's report.  ``cfg``, ``shape``, ``mesh`` and ``dtypes``
    replace the arch's published config, ``SHAPES[shape_name]``, the
    production mesh and ``state_dtypes_for`` (the tests' smoke cells,
    the card's one-device cell)."""
    cfg = cfg or get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = shape or SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    name = mesh_name(mesh)
    n_chips = math.prod(mesh_axes(mesh).values())
    t0 = time.time()
    kw = {"zero1": zero1} if shape.kind == "train" else {}
    low = BUILDERS[shape.kind](cfg, shape, mesh, microbatches=microbatches,
                               rules=rules, fsdp=fsdp, dtypes=dtypes, **kw)
    t_build = time.time() - t0
    arg_bytes = _local_bytes(low.args)
    alias_bytes = _local_bytes(low.alias)
    t0 = time.time()
    out, oc, torch_flops = count_lowering(low)
    t_count = time.time() - t0
    report = roofline_report(
        stats=oc.stats, n_chips=n_chips,
        model_flops_total=model_flops_for(cfg, shape),
        torch_flops=torch_flops,
        peak_flops=peak_flops_for(low.matmul_dtype))
    result = {
        "arch": arch,
        "shape": shape.name,
        "mesh": name,
        "tag": tag,
        "kind": shape.kind,
        "n_chips": n_chips,
        "build_s": round(t_build, 2),
        "count_s": round(t_count, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": _local_bytes(out),
            "temp_bytes": oc.temp_peak,
            "alias_bytes": alias_bytes,
            "peak_bytes_est": arg_bytes + oc.temp_peak - alias_bytes,
        },
        "roofline": report,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = f"{arch}__{shape.name}__{name}__{tag}.json"
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(result, f, indent=2)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="out/dryrun")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=["scatter", "einsum"])
    ap.add_argument("--no-ep-resident", action="store_true")
    ap.add_argument("--no-moe-remat", action="store_true")
    ap.add_argument("--no-zero1", action="store_true")
    args = ap.parse_args(argv)
    overrides = {}
    if args.moe_dispatch:
        overrides["moe_dispatch"] = args.moe_dispatch
    if args.no_ep_resident:
        overrides["moe_ep_resident"] = False
    if args.no_moe_remat:
        overrides["moe_remat_groups"] = False
    overrides = overrides or None

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                label = (f"{arch} × {shape_name} × "
                         f"{'2x16x16' if mp else '16x16'}")
                try:
                    r = run_cell(
                        arch, shape_name, multi_pod=mp, out_dir=args.out,
                        microbatches=args.microbatches,
                        fsdp=not args.no_fsdp, tag=args.tag,
                        cfg_overrides=overrides,
                        zero1=not args.no_zero1,
                    )
                    if r.get("skipped"):
                        print(f"SKIP {label}: {r['skipped']}", flush=True)
                        continue
                    rf = r["roofline"]
                    print(
                        f"OK   {label}: count={r['count_s']}s "
                        f"mem={r['memory']['peak_bytes_est']/2**30:.2f}GiB "
                        f"Tc={rf['t_compute_s']:.2e} "
                        f"Tm={rf['t_memory_s']:.2e} "
                        f"Tx={rf['t_collective_s']:.2e} "
                        f"dom={rf['dominant']} "
                        f"useful={rf['useful_flops_fraction']:.3f}",
                        flush=True,
                    )
                except Exception as e:  # noqa: BLE001
                    failures.append((label, repr(e)))
                    print(f"FAIL {label}: {e!r}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for label, err in failures:
            print(f"  {label}: {err[:200]}")
        sys.exit(1)
    print("\nALL CELLS PASSED")


if __name__ == "__main__":
    main()

"""Which collectives a ``gloo`` process group takes CUDA tensors for, in
the installed torch — the table ``repro_torch.dist.collectives`` keys its
host staging on — and which of the collectives ``torch.distributed.tensor``
issues under a ``DeviceMesh`` of device type ``cuda`` run there (the LM
stack on a live mesh: ``reduce_scatter_tensor``, ``all_to_all_single``,
``all_gather_into_tensor`` and the redistributions built on them).

Two ranks share ``cuda:0`` under a ``gloo`` group (a ``file://`` store in
a temporary directory), a new world for each op, so that an op that
kills its process is recorded as crashing and the others still run;
each tries one collective on a CUDA tensor and records whether it ran
and gave the right values.  Rank 0 prints one JSON line and writes it to
``chiprun_out/gloo_cuda_probe.json``.

    python3 scripts/gloo_cuda_probe.py

Each DTensor redistribution that crashes is tried again under
``repro_torch.dist.collectives.host_staged`` (``staged_*``), which must
give the right values through the host.

Needs a card.  On the CPU the answer is trivial (gloo takes CPU tensors).
"""

import json
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.dist.collectives import STAGED, host_staged  # noqa: E402


def _ops(dev, rank, world):
    """name → a callable that runs the collective and returns whether
    its values are right."""

    def all_gather():
        t = torch.full((3,), float(rank), device=dev)
        out = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(out, t)
        return all(bool((o == r).all()) for r, o in enumerate(out))

    def all_gather_into_tensor():
        t = torch.full((3,), float(rank), device=dev)
        out = torch.empty((world * 3,), device=dev)
        dist.all_gather_into_tensor(out, t)
        return bool((out.view(world, 3)
                     == torch.arange(world, device=dev)[:, None]).all())

    def all_reduce_sum_int64():
        t = torch.full((3,), rank + 1, dtype=torch.int64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return bool((t == world * (world + 1) // 2).all())

    def all_reduce_sum_int32():
        t = torch.full((3,), rank + 1, dtype=torch.int32, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return bool((t == world * (world + 1) // 2).all())

    def all_reduce_max_int64():
        t = torch.full((3,), rank, dtype=torch.int64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool((t == world - 1).all())

    def all_reduce_max_float():
        t = torch.full((3,), float(rank), device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool((t == world - 1).all())

    def broadcast():
        t = torch.full((3,), float(rank), device=dev)
        dist.broadcast(t, src=0)
        return bool((t == 0).all())

    def all_reduce_sum_float():
        t = torch.full((3,), float(rank + 1), device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return bool((t == world * (world + 1) / 2).all())

    def reduce_scatter_tensor():
        t = torch.arange(world * 3, dtype=torch.float32, device=dev) + rank
        out = torch.empty((3,), device=dev)
        dist.reduce_scatter_tensor(out, t)
        want = (world * (torch.arange(3, device=dev) + 3 * rank)
                + world * (world - 1) / 2)
        return bool((out == want).all())

    def all_to_all_single():
        t = torch.arange(world, dtype=torch.float32, device=dev) + 10 * rank
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        return bool((out == 10 * torch.arange(world, device=dev)
                     + rank).all())

    return {f.__name__: f for f in (all_gather, all_gather_into_tensor,
                                    all_reduce_sum_int64,
                                    all_reduce_sum_int32,
                                    all_reduce_max_int64,
                                    all_reduce_max_float, broadcast,
                                    all_reduce_sum_float,
                                    reduce_scatter_tensor,
                                    all_to_all_single)}


def _dtensor_ops(rank, world):
    """The redistributions DTensor plans for the LM stack, on a ``cuda``
    ``DeviceMesh`` of the gloo ranks: name → a callable returning
    whether the values are right."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (
        DTensor,
        Partial,
        Replicate,
        Shard,
        distribute_tensor,
    )

    mesh = full = None

    def setup():
        nonlocal mesh, full
        if mesh is not None:
            return
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("model",))
        full = torch.arange(8 * world * world, dtype=torch.float32,
                            device="cuda").reshape(4 * world, 2 * world)

    def shard_to_replicate():
        setup()
        t = distribute_tensor(full, mesh, [Shard(0)], src_data_rank=None)
        return bool((t.redistribute(mesh, [Replicate()]).to_local()
                     == full).all())

    def partial_to_shard():
        setup()
        t = DTensor.from_local(full * (rank + 1), mesh, [Partial()])
        got = t.redistribute(mesh, [Shard(0)]).full_tensor()
        return bool((got == full * world * (world + 1) / 2).all())

    def partial_to_replicate():
        setup()
        t = DTensor.from_local(full * (rank + 1), mesh, [Partial()])
        got = t.redistribute(mesh, [Replicate()]).to_local()
        return bool((got == full * world * (world + 1) / 2).all())

    def shard_to_shard():
        setup()
        t = distribute_tensor(full, mesh, [Shard(0)], src_data_rank=None)
        return bool((t.redistribute(mesh, [Shard(1)]).full_tensor()
                     == full).all())

    def matmul_row_parallel():
        setup()
        w = distribute_tensor(full.t().contiguous(), mesh, [Shard(1)],
                              src_data_rank=None)
        x = distribute_tensor(full, mesh, [Shard(0)], src_data_rank=None)
        got = torch.matmul(w, x).full_tensor()
        return bool(torch.allclose(got, full.t() @ full))

    plain = (shard_to_replicate, partial_to_shard, partial_to_replicate,
             shard_to_shard, matmul_row_parallel)

    def staged(fn):
        # the same redistribution under the port's host staging
        def run():
            setup()
            with host_staged(mesh):
                ok = fn()
            return ok and STAGED["calls"] > 0
        run.__name__ = "staged_" + fn.__name__
        return run

    return {f.__name__: f for f in plain + tuple(
        staged(f) for f in (shard_to_replicate, partial_to_shard,
                            shard_to_shard))}


def _rank(rank, world, store, kind, name, dest):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    fn = (_ops(torch.device("cuda:0"), rank, world) if kind == "gloo_cuda"
          else _dtensor_ops(rank, world))[name]
    try:  # the probe's point: which ops raise on a CUDA tensor
        got = "ok" if fn() else "wrong values"
    except Exception as exc:  # noqa: BLE001
        got = f"raises: {type(exc).__name__}: {str(exc)[:160]}"
    dist.barrier()
    if rank == 0:
        Path(dest).write_text(got)
    dist.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    names = {"gloo_cuda": list(_ops(torch.device("cpu"), 0, 2)),
             "dtensor_cuda": list(_dtensor_ops(0, 2))}
    result = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "card": torch.cuda.get_device_name(0)}
    for kind, ops in names.items():
        result[kind] = {}
        for name in ops:
            # a world of two ranks an op: an op that kills its process
            # (a crash in the backend) is recorded and the rest still run
            with tempfile.TemporaryDirectory() as tmp:
                dest = Path(tmp) / "result"
                try:
                    mp.spawn(_rank, args=(2, str(Path(tmp) / "store"), kind,
                                          name, str(dest)), nprocs=2)
                    got = dest.read_text()
                except mp.ProcessExitedException as exc:
                    got = f"crashes: {str(exc)[:160]}"
            result[kind][name] = got
            print(f"{kind} {name}: {got}", flush=True)
    line = json.dumps(result)
    print(line)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gloo_cuda_probe.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Which collectives a ``gloo`` process group takes CUDA tensors for, in
the installed torch — the table ``repro_torch.dist.collectives`` keys its
host staging on.

Two ranks share ``cuda:0`` under a ``gloo`` group (a ``file://`` store in
a temporary directory); each tries every collective the solver's layer
uses on a CUDA tensor and records whether it ran and gave the right
values.  Rank 0 prints one JSON line and writes it to
``chiprun_out/gloo_cuda_probe.json``.

    python3 scripts/gloo_cuda_probe.py

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

    return {f.__name__: f for f in (all_gather, all_gather_into_tensor,
                                    all_reduce_sum_int64,
                                    all_reduce_max_int64,
                                    all_reduce_max_float, broadcast)}


def _rank(rank, world, store):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda:0")
    out = {}
    for name, fn in _ops(dev, rank, world).items():
        try:  # the probe's point: which ops raise on a CUDA tensor
            out[name] = "ok" if fn() else "wrong values"
        except Exception as exc:  # noqa: BLE001
            out[name] = f"raises: {type(exc).__name__}: {str(exc)[:160]}"
        dist.barrier()
    if rank == 0:
        line = json.dumps({"torch": torch.__version__,
                           "cuda": torch.version.cuda,
                           "card": torch.cuda.get_device_name(0),
                           "gloo_cuda": out})
        print(line)
        dest = ROOT / "chiprun_out"
        dest.mkdir(exist_ok=True)
        (dest / "gloo_cuda_probe.json").write_text(line + "\n")
    dist.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(2, str(Path(tmp) / "store")), nprocs=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end SVM training with every PASSCoDe execution mode on the
PyTorch port, the twin of ``examples/train_svm_passcode.py``
(``repro_torch``, no jax): serial DCD, PASSCoDe-Lock/Atomic/Wild, the
data-parallel solver with its block engine, and the in-order epoch.

    PYTHONPATH=src python examples/train_svm_passcode_torch.py \\
        [--dataset rcv1] [--epochs 10] [--use-kernel on] [--device cuda]

On the card (the default) serial DCD and Lock run one indexed DCD kernel
launch per epoch (B1 on ELL, B2 on dense rows; this example feeds dense
rows), the sharded solver one B2 launch per block round, and the
in-order epoch B3.  ``--use-kernel`` offers "on" and "auto" only: the
reference's "off" (the plain engines) is the CPU path and is refused on
the card.  On the 1-D mesh the device alone picks the block engine (B2
on the card, its plain version on the CPU), so the reference's two
sharded lines, plain and fused, are one line here, and ``--use-kernel``
is taken for the reference's command line and changes nothing.

Under ``torchrun --nproc-per-node=W`` the sharded solve runs over a mesh
of the whole world (``solver_mesh()``, one data shard a rank, as the
reference's solve takes every device): a ``nccl`` group where each rank
has a card of its own, ``gloo`` otherwise (``--device cpu``, or W ranks
sharing fewer cards).  Every rank runs every line; rank 0 prints.

    torchrun --nproc-per-node=2 examples/train_svm_passcode_torch.py \\
        --device cpu --epochs 2
"""

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.core import (
    Hinge,
    dcd_solve,
    duality_gap,
    passcode_solve,
    predict_accuracy,
    sharded_passcode_solve,
)
from repro_torch.data.synthetic import DATASET_RECIPES, make_dataset
from repro_torch.dist.mesh import solver_mesh
from repro_torch.kernels import ops


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _join_world(dev):
    """Under torchrun (``WORLD_SIZE`` > 1) join the process group —
    ``nccl`` where every rank on this host has a card of its own, else
    ``gloo`` — and return (this rank's device, whether it prints)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return dev, True
    local = int(os.environ.get("LOCAL_RANK", "0"))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if dev.type == "cuda" and torch.cuda.device_count() >= per_host:
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return dev, dist.get_rank() == 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="tiny",
                    choices=sorted(DATASET_RECIPES))
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--use-kernel", default="on", choices=["on", "auto"],
                    help="the reference's flag, taken for its command "
                         "line: on the 1-D mesh the device picks the "
                         "engine")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    use_kernel = {"on": True, "auto": "auto"}[args.use_kernel]
    dev, lead = _join_world(torch.device(args.device))
    say = print if lead else (lambda *a, **k: None)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")

    ds = make_dataset(args.dataset, device=dev)
    X, Xt = ds.dense_train(), ds.dense_test()
    loss = Hinge(C=ds.recipe.C)
    say(f"device: {name}")
    say(f"dataset={args.dataset} n={X.shape[0]} d={X.shape[1]} "
        f"C={ds.recipe.C}")

    ep = args.epochs
    for label, fn in [
        ("serial DCD", lambda: dcd_solve(X, loss, epochs=ep, device=dev)),
        ("PASSCoDe-Lock(4)", lambda: passcode_solve(
            X, loss, n_threads=4, memory_model="lock", epochs=ep,
            device=dev)),
        ("PASSCoDe-Atomic(8)", lambda: passcode_solve(
            X, loss, n_threads=8, memory_model="atomic", epochs=ep,
            device=dev)),
        ("PASSCoDe-Wild(8)", lambda: passcode_solve(
            X, loss, n_threads=8, memory_model="wild", epochs=ep,
            device=dev)),
        ("sharded (1-D)", lambda: sharded_passcode_solve(
            X, loss, mesh=solver_mesh(), epochs=ep, block_size=16,
            use_kernel=use_kernel, device=dev)),
    ]:
        _sync(dev)
        t0 = time.time()
        r = fn()
        _sync(dev)
        w = getattr(r, "w_hat", getattr(r, "w", None))
        acc = float(predict_accuracy(w, Xt))
        say(f"{label:22s} gap={float(r.gaps[-1]):9.4f} "
            f"test_acc={acc:.3f}  ({time.time() - t0:.1f}s)")

    # the in-order epoch: B3 on the card, its plain version on the CPU
    n, d = X.shape
    q = torch.sum(X * X, dim=1)
    alpha = torch.zeros(n, device=dev)
    w = torch.zeros(d, device=dev)
    _sync(dev)
    t0 = time.time()
    for _ in range(ep):
        alpha, w = ops.dcd_epoch(X, alpha, w, q, c=ds.recipe.C)
    _sync(dev)
    say(f"{'in-order dcd_epoch':22s} "
        f"gap={float(duality_gap(alpha, X, loss)):9.4f} "
        f"test_acc={float(predict_accuracy(w, Xt)):.3f}  "
        f"({time.time() - t0:.1f}s)")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""Quickstart on the PyTorch port: train a linear SVM with PASSCoDe, the
twin of ``examples/quickstart.py`` (``repro_torch``, no jax).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda]
                                                       [--epochs 15]

On the card (the default) serial DCD runs one indexed DCD kernel launch
per epoch; ``--device cpu`` runs the kernels' plain versions.
"""

import argparse

import torch

from repro_torch.core import (
    Hinge,
    dcd_solve,
    passcode_solve,
    predict_accuracy,
)
from repro_torch.core.backward_error import backward_error_report
from repro_torch.data.synthetic import make_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--epochs", type=int, default=15)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}")

    # rcv1-like synthetic dataset (offline; stats in DESIGN.md)
    ds = make_dataset("tiny", device=dev)
    X, X_test = ds.dense_train(), ds.dense_test()
    loss = Hinge(C=1.0)

    # serial baseline (LIBLINEAR-style Algorithm 1)
    serial = dcd_solve(X, loss, epochs=args.epochs, device=dev)
    print(f"serial DCD      gap={float(serial.gaps[-1]):.4f} "
          f"test_acc={float(predict_accuracy(serial.w, X_test)):.3f}")

    # PASSCoDe-Atomic: 8 'threads', stale reads, lossless writes
    atomic = passcode_solve(X, loss, n_threads=8, memory_model="atomic",
                            epochs=args.epochs, device=dev)
    print(f"PASSCoDe-Atomic gap={float(atomic.gaps[-1]):.4f} "
          f"test_acc={float(predict_accuracy(atomic.w_hat, X_test)):.3f}")

    # PASSCoDe-Wild: lost updates → perturbed problem; predict with ŵ!
    wild = passcode_solve(X, loss, n_threads=8, memory_model="wild",
                          epochs=args.epochs, conflict_rate=0.5, device=dev)
    rep = backward_error_report(X, X_test, loss, wild)
    print(f"PASSCoDe-Wild   gap={float(wild.gaps[-1]):.4f} "
          f"eps={rep['eps_norm']:.3f} "
          f"acc(w_hat)={rep['test_acc_w_hat']:.3f} "
          f"acc(w_bar)={rep['test_acc_w_bar']:.3f}  <- use w_hat (Thm 3)")


if __name__ == "__main__":
    main()

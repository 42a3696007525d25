#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: build the DCD kernels,
hold each to its plain PyTorch version at the main path's shapes, then
drive the main path at the paper's Table-3 sizes and check what comes
out.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero before the
result line):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. the build of every kernel source, with nvcc's ``-Xptxas -v``
   register and spill report;
3. each kernel against its plain version at the shapes the main path
   gives it: B1 (ELL) on the rcv1-shape shard and B2 (dense indexed)
   on the covtype-shape shard, a few rounds of B = 64 ids each; B3
   (dense in-order) over one whole epoch of the covtype shard, and on
   a few rows for the other losses.  Each prints its max abs error
   against the tolerance and its time per launch from CUDA events;
   then the solver's kernel path against its CPU path on a small
   input;
4. the main path, with every launch count set to 0 just before and
   read just after: ``sharded_passcode_solve`` on rcv1 (n = 677,399,
   d = 47,236, 73 nnz per row, hinge C = 1, B = 64, 3 epochs, the gap
   every epoch) and on covtype (n = 581,012, d = 54 dense, C = 0.0625),
   and the in-order epoch entry point ``ops.dcd_epoch`` on covtype;
   each must go through its kernel, launch it the expected number of
   times, and give finite duality gaps that fall;
5. one JSON line of per-kernel numbers, then the result line
   ``{"ok": true, "device": {...}}``.

It needs one CUDA card and exits non-zero without one.  Data comes from
a fixed seed on the card; nothing is read from disk or the network.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
ATOL = 1e-5  # float32; dots sum in another order, atomics in no fixed one
B = 64
EPOCHS = 3
DEVICE = "cuda"


def fail(msg):
    raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, torch):
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events,
    after one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps, torch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound(n_bytes, n_ops):
    """The least time for the work: bytes over HBM bandwidth or float32
    operations over the float32 peak, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import duals
    from repro_torch.core.objective import duality_gap, predict_accuracy
    from repro_torch.core.sharded import _n_blocks, sharded_passcode_solve
    from repro_torch.data.synthetic import make_dataset, make_paper_split
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.dcd_block import (
        dcd_indexed_epoch,
        dcd_indexed_epoch_plain,
        dcd_tile_epoch,
        dcd_tile_epoch_plain,
    )
    from repro_torch.kernels.dcd_ell import dcd_ell_epoch, dcd_ell_epoch_plain

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------------ 1. card
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    reports = build.build(report=True)
    print(f"build: {len(build.SOURCES)} sources in "
          f"{time.perf_counter() - t0:.1f}s into {build.BUILD_DIR}")
    for name, text in reports.items():
        for line in text.splitlines():
            if line.strip():
                print(f"  {name}: {line.strip()}")

    # ------------------------------------------------------------ data
    t0 = time.perf_counter()
    X_rcv1, _ = make_paper_split("rcv1", seed=0, device=dev)
    X_cov, _ = make_paper_split("covtype", seed=1, device=dev)
    torch.cuda.synchronize()
    print(f"data: rcv1 cols/vals {tuple(X_rcv1.indices.shape)}, covtype "
          f"{tuple(X_cov.shape)} drawn in {time.perf_counter() - t0:.1f}s")
    n_r, k_r, d_r = X_rcv1.n_rows, X_rcv1.k_max, X_rcv1.n_features
    n_c, d_c = X_cov.shape
    q_r = X_rcv1.row_sq_norms()
    q_c = (X_cov * X_cov).sum(1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def blocks(n, rounds):
        return torch.randperm(n, generator=gen, device=dev)[
            : rounds * B].int().reshape(rounds, B)

    # ------------------------------------------------- 3. kernels vs plain
    results = {}

    def compare(name, kernel, plain, state0, rounds, losses, updates=None):
        """Run the same rounds (carrying α and w) through the kernel and
        its plain version; returns the max abs error over all of them."""
        updates = updates or rounds.numel()
        err = 0.0
        for lname in losses:
            loss = duals.make_loss(lname, 0.5 if lname == "logistic" else 1.0)
            ka, kw = state0()
            pa, pw = state0()
            for r in range(rounds.shape[0]):
                ka, kw = kernel(ka, kw, rounds[r], loss)
                pa, pw = plain(pa, pw, rounds[r], loss)
            torch.cuda.synchronize()
            e = max(float((ka - pa).abs().max()), float((kw - pw).abs().max()))
            print(f"  {name} {lname}: max abs err {e:.3g} over "
                  f"{updates} updates (tolerance {ATOL})")
            if not e <= ATOL:
                fail(f"{name} disagrees with its plain version ({lname})")
            err = max(err, e)
        return err

    losses = ["hinge", "squared_hinge", "logistic"]
    ids_r = blocks(n_r, 4)
    act_r = (torch.rand(n_r, generator=gen, device=dev) > 0.2).float()
    y_r = torch.where(torch.rand(n_r, generator=gen, device=dev) > 0.5,
                      1.0, -1.0)

    def zeros_r():
        return (torch.zeros(n_r, device=dev),
                torch.zeros(d_r + 1, device=dev))

    err_b1 = compare(
        "B1 dcd_ell", lambda a, w, i, L: dcd_ell_epoch(
            X_rcv1.indices, X_rcv1.values, a, w, q_r, loss=L, idx=i),
        lambda a, w, i, L: dcd_ell_epoch_plain(
            X_rcv1.indices, X_rcv1.values, a, w, q_r, loss=L, idx=i),
        zeros_r, ids_r, losses)
    err_b1 = max(err_b1, compare(
        "B1 dcd_ell (mask, labels)", lambda a, w, i, L: dcd_ell_epoch(
            X_rcv1.indices, X_rcv1.values, a, w, q_r, loss=L, idx=i,
            active=act_r, y=y_r),
        lambda a, w, i, L: dcd_ell_epoch_plain(
            X_rcv1.indices, X_rcv1.values, a, w, q_r, loss=L, idx=i,
            active=act_r, y=y_r),
        zeros_r, ids_r[:2], ["hinge"]))

    ids_c = blocks(n_c, 4)

    def zeros_c():
        return torch.zeros(n_c, device=dev), torch.zeros(d_c, device=dev)

    err_b2 = compare(
        "B2 dcd_indexed", lambda a, w, i, L: dcd_indexed_epoch(
            X_cov, a, w, q_c, loss=L, idx=i),
        lambda a, w, i, L: dcd_indexed_epoch_plain(
            X_cov, a, w, q_c, loss=L, idx=i),
        zeros_c, ids_c, losses)
    # B3 runs its rows in order.  The main path gives it the whole
    # covtype shard in one launch (ops.dcd_epoch, hinge C = 0.0625):
    # hold it to its plain version there, one epoch from α = 0, w = 0,
    # and time both on those inputs.  A few rows suffice for the other
    # two losses.
    hinge_c = duals.Hinge(0.0625)
    a0_c, w0_c = torch.zeros(n_c, device=dev), torch.zeros(d_c, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pa3, pw3 = dcd_tile_epoch_plain(X_cov, a0_c, w0_c, q_c, loss=hinge_c)
    torch.cuda.synchronize()
    plain_b3 = (time.perf_counter() - t0) * 1e3
    ka3, kw3 = dcd_tile_epoch(X_cov, a0_c, w0_c, q_c, loss=hinge_c)
    torch.cuda.synchronize()
    err_b3 = max(float((ka3 - pa3).abs().max()),
                 float((kw3 - pw3).abs().max()))
    moved_b3 = int((pa3 != a0_c).sum())  # rows whose update scattered
    print(f"  B3 dcd_tile hinge: max abs err {err_b3:.3g} over one epoch of "
          f"{n_c} rows ({moved_b3} scattered; |w| max "
          f"{float(pw3.abs().max()):.4g}; tolerance {ATOL})")
    if not err_b3 <= ATOL:
        fail("B3 dcd_tile disagrees with its plain version (hinge, full "
             "covtype epoch)")
    ms_b3 = cuda_ms(lambda: dcd_tile_epoch(X_cov, a0_c, w0_c, q_c,
                                           loss=hinge_c), 3, torch)
    tile = slice(1000, 1000 + 4 * B)

    def zeros_t():
        return (torch.zeros(4 * B, device=dev),
                torch.zeros(d_c, device=dev))

    err_b3 = max(err_b3, compare(
        "B3 dcd_tile", lambda a, w, i, L: dcd_tile_epoch(
            X_cov[tile], a, w, q_c[tile], loss=L),
        lambda a, w, i, L: dcd_tile_epoch_plain(
            X_cov[tile], a, w, q_c[tile], loss=L),
        zeros_t, ids_c[:1], ["squared_hinge", "logistic"], updates=4 * B))

    # times per launch at the main path's shapes (hinge, B = 64 ids)
    hinge = duals.Hinge(1.0)
    a_r, w_r = zeros_r()
    t_ids = blocks(n_r, 64)
    it = iter(range(10**9))
    ms_b1 = cuda_ms(lambda: dcd_ell_epoch(
        X_rcv1.indices, X_rcv1.values, a_r, w_r, q_r, loss=hinge,
        idx=t_ids[next(it) % 64]), 50, torch)
    plain_b1 = wall_ms(lambda: dcd_ell_epoch_plain(
        X_rcv1.indices, X_rcv1.values, a_r, w_r, q_r, loss=hinge,
        idx=t_ids[0]), 2, torch)
    a_c, w_c = zeros_c()
    c_ids = blocks(n_c, 64)
    ms_b2 = cuda_ms(lambda: dcd_indexed_epoch(
        X_cov, a_c, w_c, q_c, loss=hinge_c, idx=c_ids[next(it) % 64]), 50,
        torch)
    plain_b2 = wall_ms(lambda: dcd_indexed_epoch_plain(
        X_cov, a_c, w_c, q_c, loss=hinge_c, idx=c_ids[0]), 2, torch)

    # bytes each timed call must move: α and w in and out (the wrapper
    # returns new ones), and the visited rows with their q (and ids);
    # operations: a multiply-add per row entry for the dot, and one for
    # the axpy where the update scatters (every update from a cold
    # state in B1 and B2; the rows that moved in B3's epoch)
    by_b1 = 4 * (2 * n_r + 2 * (d_r + 1)) + B * (k_r * 8 + 2 * 4)
    by_b2 = 4 * (2 * n_c + 2 * d_c) + B * (d_c * 4 + 2 * 4)
    by_b3 = 4 * (2 * n_c + 2 * d_c) + n_c * (d_c * 4 + 4)
    for name, route_ms, pl_ms, by, ops_n, per, err, src, rep in [
        ("dcd_ell", ms_b1, plain_b1, by_b1, 4 * B * k_r,
         f"rcv1 shape, {B} ids", err_b1,
         "src/repro_torch/kernels/csrc/dcd_ell.cu",
         "src/repro/kernels/dcd_ell.py:51"),
        ("dcd_indexed", ms_b2, plain_b2, by_b2, 4 * B * d_c,
         f"covtype shape, {B} ids", err_b2,
         "src/repro_torch/kernels/csrc/dcd_block.cu",
         "src/repro/kernels/dcd_block.py:100"),
        ("dcd_tile", ms_b3, plain_b3, by_b3, 2 * d_c * (n_c + moved_b3),
         f"covtype shard, {n_c} rows", err_b3,
         "src/repro_torch/kernels/csrc/dcd_block.cu",
         "src/repro/kernels/dcd_block.py:70"),
    ]:
        b_ms, b_by = bound(by, ops_n)
        results[name] = dict(name=name, route="cuda", source=src,
                             replaces=rep, launches=0, max_abs_err=err,
                             ms=route_ms, plain_ms=pl_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None)
        print(f"  {name} ({per}): {route_ms:.4f} ms per "
              f"launch, plain {pl_ms:.2f} ms, bound {b_ms:.6f} ms "
              f"({b_by}), no library call computes it")

    # the solver's kernel path against its CPU path on a small input
    small = make_dataset("tiny", device="cpu")
    rng = torch.Generator().manual_seed(3)
    sched = torch.stack([torch.randperm(256, generator=rng).reshape(8, 32)
                         for _ in range(3)])
    for label, Xs in [("ELL", small.X_train), ("dense", small.dense_train())]:
        kw = dict(epochs=3, block_size=32, delay_rounds=1, blocks=sched)
        on_card = sharded_passcode_solve(Xs.to(dev), hinge, device=dev, **kw)
        on_cpu = sharded_passcode_solve(Xs, hinge, device="cpu", **kw)
        e = max(float((on_card.alpha.cpu() - on_cpu.alpha).abs().max()),
                float((on_card.w_hat.cpu() - on_cpu.w_hat).abs().max()))
        print(f"  solver {label} kernel path vs CPU path: max abs err "
              f"{e:.3g} (tolerance {ATOL})")
        if not e <= ATOL:
            fail(f"the solver's {label} kernel path disagrees with its CPU "
                 "path")

    # ------------------------------------------------------ 4. main path
    counters = {"dcd_ell": dcd_ell_epoch, "dcd_indexed": dcd_indexed_epoch,
                "dcd_tile": dcd_tile_epoch}
    for fn in counters.values():
        fn.launches = 0

    def solve(label, X, loss, n):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = sharded_passcode_solve(X, loss, epochs=EPOCHS, block_size=B,
                                   gap_every=1, seed=0, device=dev)
        gaps = r.gaps.tolist()  # the solve's one host sync
        sec = time.perf_counter() - t0
        nb = _n_blocks(n, B)
        print(f"  {label}: {sec / EPOCHS:.3f} s per epoch (gap included), "
              f"{EPOCHS * nb * B / sec:.4g} updates/s, {nb} launches per "
              f"epoch ({sec / EPOCHS / nb * 1e3:.4f} ms per round), peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        print(f"    gaps {gaps}")
        print(f"    eps  {r.eps.tolist()}")
        print(f"    train accuracy {float(predict_accuracy(r.w_hat, X)):.4f}")
        if r.alpha.shape != (n,) or not all(math.isfinite(g) for g in gaps):
            fail(f"{label}: result of the wrong shape or a non-finite gap")
        if not gaps[-1] < gaps[0]:
            fail(f"{label}: the duality gap did not fall: {gaps}")
        return EPOCHS * nb

    want_b1 = solve("rcv1 (ELL, B1)", X_rcv1, duals.Hinge(1.0), n_r)
    want_b2 = solve("covtype (dense, B2)", X_cov, duals.Hinge(0.0625), n_c)
    # the in-order epoch entry point (B3) on covtype, as the examples run it
    alpha, w = torch.zeros(n_c, device=dev), torch.zeros(d_c, device=dev)
    g0 = float(duality_gap(alpha, X_cov, hinge_c))
    t0 = time.perf_counter()
    for _ in range(2):
        alpha, w = ops.dcd_epoch(X_cov, alpha, w, q_c, c=0.0625)
    g2 = float(duality_gap(alpha, X_cov, hinge_c))
    print(f"  covtype in-order epochs (B3): 2 epochs in "
          f"{time.perf_counter() - t0:.3f} s, gap {g0:.6g} -> {g2:.6g}")
    if not (math.isfinite(g2) and g2 < g0):
        fail(f"in-order epochs: the gap did not fall ({g0} -> {g2})")
    want = {"dcd_ell": want_b1, "dcd_indexed": want_b2, "dcd_tile": 2}
    for name, fn in counters.items():
        results[name]["launches"] = fn.launches
        print(f"  launches {name}: {fn.launches} (expected {want[name]})")
        if fn.launches != want[name]:
            fail(f"{name} launched {fn.launches} times, expected "
                 f"{want[name]}")

    # ---------------------------------------------------------- 5. result
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

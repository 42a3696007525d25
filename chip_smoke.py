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
   gives it: B1 (ELL) on the rcv1-shape shard (its staged variant) and
   on webspam's rows (its wide variant), and B2 (dense indexed) on the
   covtype-shape shard (its staged variant, and its wide one as
   ``ms_before``), a few rounds of B = 64 ids each; B3
   (dense in-order, its stream variant) over one whole epoch of the
   covtype shard, and on a few rows for the other losses, from an
   aligned and an unaligned offset, with its wide variant re-timed on the
   whole shard as its ``ms_before`` and a logistic epoch timed
   (``ms_logistic``); B4 (block Gram) and B5 (Gram
   δ-recursion) on the webspam shape split into m = 4 feature shards,
   a few rounds of B = 64 ids per loss (B5 with B4's workspace, and
   alone with its own bucket pass, to the same bits).  Each prints its
   max abs error against the tolerance and its time per launch from
   CUDA events; B1, B2, B4 and B5 are also launched twice on the same
   block, and B3 on the same epoch, and must give the same bits.  B1's
   and B2's wide variants are also checked and timed at the rcv1 and
   covtype shapes (``ms_before``: the designs the staged variants
   replaced); B5 is timed alone (its own bucket pass) and on logistic;
   B1 and B4 are timed once more without the spin
   (host-gated).  ``torch.profiler`` views 20 rounds of the rcv1, the
   covtype and the webspam solve (wall time, device-busy time, idle
   share); then the
   solver's kernel paths against their CPU paths on a small input (1-D,
   and 2-D with the overlapped round);
4. the main paths, each with every launch count set to 0 just before
   it and read just after: ``sharded_passcode_solve`` on rcv1
   (n = 677,399, d = 47,236, 73 nnz per row, hinge C = 1, B = 64,
   3 epochs, the gap every epoch) and on covtype (n = 581,012, d = 54
   dense, C = 0.0625), the in-order epoch entry point ``ops.dcd_epoch``
   on covtype, and the 2-D solve on webspam (n = 280,000,
   d = 16,609,143, 3,728 nnz per row, hinge C = 1, B = 64, m = 4
   feature shards, 2 epochs), and webspam's rows on the 1-D mesh (2
   epochs, B1's wide variant); each must go through its kernels, launch
   them (and each variant of B1, B2 and B3) the expected number of
   times, and give finite duality gaps that fall;
5. one JSON line of per-kernel numbers (with each kernel's variant, and
   B1's, B2's and B3's ``ms_before``), then the result line
   ``{"ok": true, "device": {...}}``.

It needs one CUDA card and exits non-zero without one.  Data comes from
a fixed seed on the card; nothing is read from disk or the network.
"""

import functools
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
EPOCHS_2D = 2
SHARDS = 4  # webspam's feature shards (the reference's model axis)
DEVICE = "cuda"
SPIN_CYCLES = 40_000_000  # about 20 ms at the H100's 1,980 MHz


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


def cuda_ms(fn, reps, torch, spin=True):
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events,
    after one warm-up call).  The timed calls queue behind a spin kernel
    of about 20 ms, so the host's own time per call (Python, operand
    checks, ctypes) does not gate the device: the events time the device
    work of the calls alone, back to back.  ``spin=False`` times the
    calls as they are issued, so a launch shorter than its wrapper's
    host time is timed at the host's pace."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
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


def same_bits(label, fn, torch):
    """Launch ``fn`` twice on the same inputs; fail unless every output
    has the same bits."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"  {label}: second launch bit-identical: {same}")
    if not same:
        fail(f"{label}: two launches on the same inputs differ")


def profile_rounds(label, run, rounds, torch):
    """Device time by kernel of ``run()`` (``rounds`` solver rounds)
    under torch.profiler, against the rounds' wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / rounds
    dev_us = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        if t > 0 and not ev.key.startswith("aten::"):
            dev_us[ev.key[:40]] = dev_us.get(ev.key[:40], 0) + t
    busy = sum(dev_us.values()) / 1e3 / rounds
    print(f"  {label} round profile ({rounds} rounds): {wall:.4f} ms wall, "
          f"{busy:.4f} ms device busy, idle share "
          f"{max(0.0, 1 - busy / wall):.3f}")
    for key, t in sorted(dev_us.items(), key=lambda kv: -kv[1]):
        print(f"    {t / 1e3 / rounds:.4f} ms per round  {key}")
    if busy <= 0.0:
        fail(f"{label}: the profiler saw no device time")


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
    from repro_torch.core.sharded import (
        _block_update_1d,
        _block_update_2d,
        _n_blocks,
        _scan_rounds,
        sharded_passcode_solve,
    )
    from repro_torch.data.sparse import ell_column_split
    from repro_torch.data.synthetic import make_dataset, make_paper_split
    from repro_torch.dist.mesh import (
        dcd_dense_plan,
        dcd_ell_plan,
        dcd_tile_plan,
        feature_update_plan,
        gram_plan,
        solver_mesh_2d,
    )
    from repro_torch.kernels import build, dcd_feature as feat, ops
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
          f"{time.perf_counter() - t0:.1f}s into {build.build_dir()}")
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
    t0 = time.perf_counter()
    X_web, _ = make_paper_split("webspam", seed=2, device=dev)
    torch.cuda.synchronize()
    print(f"data: webspam cols/vals {tuple(X_web.indices.shape)} "
          f"({X_web.indices.numel() * 8 / 1e9:.2f} GB) drawn in "
          f"{time.perf_counter() - t0:.1f}s")
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
    print(f"  B1 at the rcv1 shape: {dcd_ell_plan(B, k_r)}")
    # the wide variant at the same shape, as the staged one's "before"
    err_b1_before = compare(
        "B1 dcd_ell wide at the rcv1 shape", lambda a, w, i, L: dcd_ell_epoch(
            X_rcv1.indices, X_rcv1.values, a, w, q_r, loss=L, idx=i,
            wide=True),
        lambda a, w, i, L: dcd_ell_epoch_plain(
            X_rcv1.indices, X_rcv1.values, a, w, q_r, loss=L, idx=i),
        zeros_r, ids_r[:2], ["hinge"])
    a_r0, w_r0 = zeros_r()
    same_bits("B1 dcd_ell staged (rcv1, hinge, mask, labels)",
              lambda: dcd_ell_epoch(X_rcv1.indices, X_rcv1.values, a_r0,
                                    w_r0, q_r, loss=duals.Hinge(1.0),
                                    idx=ids_r[0], active=act_r, y=y_r),
              torch)

    # B1's wide variant on webspam's rows (k = 3,728: a block too large
    # to stage), the 1-D webspam path's shape
    n_w1, k_w1, d_w1 = X_web.n_rows, X_web.k_max, X_web.n_features
    q_w1 = X_web.row_sq_norms()
    ids_w1 = blocks(n_w1, 2)
    print(f"  B1 at webspam's rows: {dcd_ell_plan(B, k_w1)}")

    def zeros_w1():
        return (torch.zeros(n_w1, device=dev),
                torch.zeros(d_w1 + 1, device=dev))

    err_b1w = compare(
        "B1 dcd_ell wide", lambda a, w, i, L: dcd_ell_epoch(
            X_web.indices, X_web.values, a, w, q_w1, loss=L, idx=i),
        lambda a, w, i, L: dcd_ell_epoch_plain(
            X_web.indices, X_web.values, a, w, q_w1, loss=L, idx=i),
        zeros_w1, ids_w1, losses)
    a_w1, w_w1 = zeros_w1()
    same_bits("B1 dcd_ell wide (webspam rows, hinge)",
              lambda: dcd_ell_epoch(X_web.indices, X_web.values, a_w1, w_w1,
                                    q_w1, loss=duals.Hinge(1.0),
                                    idx=ids_w1[0]), torch)

    ids_c = blocks(n_c, 4)

    def zeros_c():
        return torch.zeros(n_c, device=dev), torch.zeros(d_c, device=dev)

    act_c = (torch.rand(n_c, generator=gen, device=dev) > 0.2).float()
    y_c = torch.where(torch.rand(n_c, generator=gen, device=dev) > 0.5,
                      1.0, -1.0)
    print(f"  B2 at the covtype shape: {dcd_dense_plan(B, d_c)}")
    err_b2 = compare(
        "B2 dcd_indexed", lambda a, w, i, L: dcd_indexed_epoch(
            X_cov, a, w, q_c, loss=L, idx=i),
        lambda a, w, i, L: dcd_indexed_epoch_plain(
            X_cov, a, w, q_c, loss=L, idx=i),
        zeros_c, ids_c, losses)
    err_b2 = max(err_b2, compare(
        "B2 dcd_indexed (mask, labels)", lambda a, w, i, L: dcd_indexed_epoch(
            X_cov, a, w, q_c, loss=L, idx=i, active=act_c, y=y_c),
        lambda a, w, i, L: dcd_indexed_epoch_plain(
            X_cov, a, w, q_c, loss=L, idx=i, active=act_c, y=y_c),
        zeros_c, ids_c[:2], ["hinge"]))
    # the wide variant at the same shape, as the staged one's "before"
    err_b2_before = compare(
        "B2 dcd_indexed wide at the covtype shape",
        lambda a, w, i, L: dcd_indexed_epoch(X_cov, a, w, q_c, loss=L, idx=i,
                                             wide=True),
        lambda a, w, i, L: dcd_indexed_epoch_plain(
            X_cov, a, w, q_c, loss=L, idx=i),
        zeros_c, ids_c[:2], ["hinge"])
    a_c0, w_c0 = zeros_c()
    for wide in (False, True):
        same_bits(f"B2 dcd_indexed {'wide' if wide else 'staged'} (covtype, "
                  "hinge, mask, labels)",
                  lambda: dcd_indexed_epoch(X_cov, a_c0, w_c0, q_c,
                                            loss=duals.Hinge(1.0),
                                            idx=ids_c[0], active=act_c,
                                            y=y_c, wide=wide), torch)
    # B3 runs its rows in order.  The main path gives it the whole
    # covtype shard in one launch (ops.dcd_epoch, hinge C = 0.0625), which
    # takes its stream variant: hold it to its plain version there, one
    # epoch from α = 0, w = 0, and time both on those inputs, with the
    # wide variant (the design the stream one replaced) re-timed on the
    # same inputs as its "before".  A few rows suffice for the other two
    # losses, from an aligned and from an unaligned offset (a view whose
    # base and q are not 16-byte aligned: the stages are copied in 4-byte
    # units).
    hinge_c = duals.Hinge(0.0625)
    print(f"  B3 at the covtype shape: {dcd_tile_plan(n_c, d_c)}")
    a0_c, w0_c = torch.zeros(n_c, device=dev), torch.zeros(d_c, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pa3, pw3 = dcd_tile_epoch_plain(X_cov, a0_c, w0_c, q_c, loss=hinge_c)
    torch.cuda.synchronize()
    plain_b3 = (time.perf_counter() - t0) * 1e3
    moved_b3 = int((pa3 != a0_c).sum())  # rows whose update scattered
    err_b3 = err_b3_before = 0.0
    for wide in (False, True):
        ka3, kw3 = dcd_tile_epoch(X_cov, a0_c, w0_c, q_c, loss=hinge_c,
                                  wide=wide)
        torch.cuda.synchronize()
        e = max(float((ka3 - pa3).abs().max()),
                float((kw3 - pw3).abs().max()))
        what = "wide" if wide else "stream"
        print(f"  B3 dcd_tile {what} hinge: max abs err {e:.3g} over one "
              f"epoch of {n_c} rows ({moved_b3} scattered; |w| max "
              f"{float(pw3.abs().max()):.4g}; tolerance {ATOL})")
        if not e <= ATOL:
            fail(f"B3 dcd_tile {what} disagrees with its plain version "
                 "(hinge, full covtype epoch)")
        if wide:
            err_b3_before = e
        else:
            err_b3 = e
    same_bits("B3 dcd_tile stream (covtype epoch, hinge)",
              lambda: dcd_tile_epoch(X_cov, a0_c, w0_c, q_c, loss=hinge_c),
              torch)
    ms_b3 = cuda_ms(lambda: dcd_tile_epoch(X_cov, a0_c, w0_c, q_c,
                                           loss=hinge_c), 3, torch)
    ms_b3_before = cuda_ms(lambda: dcd_tile_epoch(
        X_cov, a0_c, w0_c, q_c, loss=hinge_c, wide=True), 2, torch)
    a_lc = torch.full((n_c,), 0.25, device=dev)  # inside logistic's domain
    ms_b3_logistic = cuda_ms(lambda: dcd_tile_epoch(
        X_cov, a_lc, w0_c, q_c, loss=duals.Logistic(1.0)), 2, torch)
    print(f"  B3 dcd_tile ms per epoch: stream {ms_b3:.4f}, wide (before) "
          f"{ms_b3_before:.4f} ({ms_b3 / ms_b3_before:.3f} of it), stream "
          f"logistic {ms_b3_logistic:.4f}")

    def zeros_t():
        return (torch.zeros(4 * B, device=dev),
                torch.zeros(d_c, device=dev))

    for first in (1000, 1001):  # 1001: X's and q's views unaligned
        tile = slice(first, first + 4 * B)
        err_b3 = max(err_b3, compare(
            f"B3 dcd_tile (rows {first}..{first + 4 * B - 1})",
            lambda a, w, i, L: dcd_tile_epoch(X_cov[tile], a, w, q_c[tile],
                                              loss=L),
            lambda a, w, i, L: dcd_tile_epoch_plain(
                X_cov[tile], a, w, q_c[tile], loss=L),
            zeros_t, ids_c[:1], ["squared_hinge", "logistic"],
            updates=4 * B))

    # times per launch at the main path's shapes (hinge, B = 64 ids)
    hinge = duals.Hinge(1.0)
    a_r, w_r = zeros_r()
    t_ids = blocks(n_r, 64)
    it = iter(range(10**9))
    ms_b1 = cuda_ms(lambda: dcd_ell_epoch(
        X_rcv1.indices, X_rcv1.values, a_r, w_r, q_r, loss=hinge,
        idx=t_ids[next(it) % 64]), 50, torch)
    # the design B1 had before its staged variant (the wide kernel) at
    # the same shape, timed the same way
    ms_b1_before = cuda_ms(lambda: dcd_ell_epoch(
        X_rcv1.indices, X_rcv1.values, a_r, w_r, q_r, loss=hinge,
        idx=t_ids[next(it) % 64], wide=True), 50, torch)
    plain_b1 = wall_ms(lambda: dcd_ell_epoch_plain(
        X_rcv1.indices, X_rcv1.values, a_r, w_r, q_r, loss=hinge,
        idx=t_ids[0]), 2, torch)
    w_ids = blocks(n_w1, 16)
    ms_b1w = cuda_ms(lambda: dcd_ell_epoch(
        X_web.indices, X_web.values, a_w1, w_w1, q_w1, loss=hinge,
        idx=w_ids[next(it) % 16]), 20, torch)
    plain_b1w = wall_ms(lambda: dcd_ell_epoch_plain(
        X_web.indices, X_web.values, a_w1, w_w1, q_w1, loss=hinge,
        idx=w_ids[0]), 2, torch)
    a_c, w_c = zeros_c()
    c_ids = blocks(n_c, 64)
    ms_b2 = cuda_ms(lambda: dcd_indexed_epoch(
        X_cov, a_c, w_c, q_c, loss=hinge_c, idx=c_ids[next(it) % 64]), 50,
        torch)
    # the design B2 had before its staged variant (the wide kernel) at the
    # same shape, timed the same way
    ms_b2_before = cuda_ms(lambda: dcd_indexed_epoch(
        X_cov, a_c, w_c, q_c, loss=hinge_c, idx=c_ids[next(it) % 64],
        wide=True), 50, torch)
    plain_b2 = wall_ms(lambda: dcd_indexed_epoch_plain(
        X_cov, a_c, w_c, q_c, loss=hinge_c, idx=c_ids[0]), 2, torch)

    # bytes each timed call must move: α and w in and out (the wrapper
    # returns new ones), and the visited rows with their q (and ids);
    # operations: a multiply-add per row entry for the dot, and one for
    # the axpy where the update scatters (every update from a cold
    # state in B1 and B2; the rows that moved in B3's epoch)
    by_b1 = 4 * (2 * n_r + 2 * (d_r + 1)) + B * (k_r * 8 + 2 * 4)
    by_b1w = 4 * (2 * n_w1 + 2 * (d_w1 + 1)) + B * (k_w1 * 8 + 2 * 4)
    by_b2 = 4 * (2 * n_c + 2 * d_c) + B * (d_c * 4 + 2 * 4)
    by_b3 = 4 * (2 * n_c + 2 * d_c) + n_c * (d_c * 4 + 4)
    for name, variant, route_ms, pl_ms, by, ops_n, per, err, src, rep in [
        ("dcd_ell", "staged", ms_b1, plain_b1, by_b1, 4 * B * k_r,
         f"rcv1 shape, {B} ids", err_b1,
         "src/repro_torch/kernels/csrc/dcd_ell.cu",
         "src/repro/kernels/dcd_ell.py:51"),
        ("dcd_ell_wide", "wide", ms_b1w, plain_b1w, by_b1w, 4 * B * k_w1,
         f"webspam rows, {B} ids", err_b1w,
         "src/repro_torch/kernels/csrc/dcd_ell.cu",
         "src/repro/kernels/dcd_ell.py:51"),
        ("dcd_indexed", "staged", ms_b2, plain_b2, by_b2, 4 * B * d_c,
         f"covtype shape, {B} ids", err_b2,
         "src/repro_torch/kernels/csrc/dcd_block.cu",
         "src/repro/kernels/dcd_block.py:100"),
        ("dcd_tile", "stream", ms_b3, plain_b3, by_b3,
         2 * d_c * (n_c + moved_b3), f"covtype shard, {n_c} rows", err_b3,
         "src/repro_torch/kernels/csrc/dcd_block.cu",
         "src/repro/kernels/dcd_block.py:70"),
    ]:
        b_ms, b_by = bound(by, ops_n)
        results[name] = dict(name=name, route="cuda", source=src,
                             replaces=rep, variant=variant, launches=0,
                             max_abs_err=err, ms=route_ms, plain_ms=pl_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=None)
        print(f"  {name} ({per}): {route_ms:.4f} ms per "
              f"launch, plain {pl_ms:.2f} ms, bound {b_ms:.6f} ms "
              f"({b_by}), no library call computes it")
    results["dcd_ell"]["ms_before"] = ms_b1_before
    results["dcd_indexed"]["ms_before"] = ms_b2_before
    results["dcd_tile"].update(ms_before=ms_b3_before,
                               ms_logistic=ms_b3_logistic)
    for name, what, ms, e in [
            ("dcd_ell", f"its staged variant (the wide kernel at the rcv1 "
             f"shape, {B} ids", ms_b1_before, err_b1_before),
            ("dcd_indexed", f"its staged variant (the wide kernel at the "
             f"covtype shape, {B} ids", ms_b2_before, err_b2_before),
            ("dcd_tile", "its stream variant (the wide kernel, one covtype "
             "epoch", ms_b3_before, err_b3_before)]:
        print(f"  {name} before {what}; max abs err {e:.3g}): {ms:.4f} ms "
              "per launch")

    # B4 and B5 at the webspam shape: the (n, 4, k_loc) split the 2-D
    # solve makes of it, a few rounds of B = 64 ids per loss, (α, w)
    # carried through each chain; the kernel chain and the plain chain
    # each feed B5 their own B4's (base, Gram), summed over shards
    t0 = time.perf_counter()
    fse = ell_column_split(X_web, SHARDS)
    torch.cuda.synchronize()
    n_w, k_loc, d_loc = fse.n_rows, fse.k_loc, fse.d_loc
    d1_w, split_gb = d_loc + 1, fse.indices.numel() * 8 / 1e9
    print(f"  webspam split into {SHARDS} shards in "
          f"{time.perf_counter() - t0:.1f}s: k_loc {k_loc}, d_loc {d_loc}, "
          f"{split_gb:.2f} GB")
    cols_w, vals_w = fse.indices, fse.values
    q_w = fse.row_sq_norms()
    ws = feat.gram_workspace(SHARDS, B, k_loc, d1_w, dev)
    print(f"  B4 at the webspam split: {gram_plan(SHARDS, B, k_loc, d1_w)}; "
          f"workspace {sum(t.numel() for t in ws) * 4 / 1e6:.2f} MB")
    print(f"  B5 at the webspam split: "
          f"{feature_update_plan(SHARDS, B, k_loc, d1_w)}")
    ids_w = blocks(n_w, 4)
    act_w = (torch.rand(n_w, generator=gen, device=dev) > 0.2).float()
    y_w = torch.where(torch.rand(n_w, generator=gen, device=dev) > 0.5,
                      1.0, -1.0)

    def state_w():
        w = torch.randn((SHARDS, d1_w), generator=gen, device=dev) * 1e-3
        w[:, d_loc] = 0.0
        return torch.zeros(n_w, device=dev), w

    err_b4 = err_b5 = 0.0
    for lname, rounds, masked in [("hinge", 4, False),
                                  ("squared_hinge", 2, False),
                                  ("logistic", 2, False), ("hinge", 2, True)]:
        loss = duals.make_loss(lname, 0.5 if lname == "logistic" else 1.0)
        extra = dict(active=act_w, y=y_w) if masked else {}
        ka, kw = pa, pw = state_w()
        e4 = 0.0
        for r in range(rounds):
            kb, kg = feat.dcd_feature_gram(cols_w, vals_w, kw, ids_w[r],
                                           workspace=ws)
            pb, pg = feat.dcd_feature_gram_plain(cols_w, vals_w, pw,
                                                 ids_w[r])
            e4 = max(e4, float((kb - pb).abs().max()),
                     float((kg - pg).abs().max()))
            # B5 with the buckets B4 just left for this block, and alone
            # (its own bucket pass): the same bits
            sa, sw = feat.dcd_feature_update(
                cols_w, vals_w, ka, q_w, kw, ids_w[r], kb.sum(0), kg.sum(0),
                loss=loss, **extra)
            ka, kw = feat.dcd_feature_update(
                cols_w, vals_w, ka, q_w, kw, ids_w[r], kb.sum(0), kg.sum(0),
                loss=loss, workspace=ws, **extra)
            torch.cuda.synchronize()
            if not (torch.equal(sa, ka) and torch.equal(sw, kw)):
                fail("B5 alone and B5 with B4's workspace differ")
            pa, pw = feat.dcd_feature_update_plain(
                cols_w, vals_w, pa, q_w, pw, ids_w[r], pb.sum(0), pg.sum(0),
                loss=loss, **extra)
        torch.cuda.synchronize()
        e5 = max(float((ka - pa).abs().max()), float((kw - pw).abs().max()))
        what = f"{lname}{' (mask, labels)' if masked else ''}"
        print(f"  B4 dcd_feature_gram {what}: max abs err {e4:.3g} over "
              f"{rounds} blocks of {B}; B5 dcd_feature_update: {e5:.3g} "
              f"over {rounds * B} updates (tolerance {ATOL})")
        if not (e4 <= ATOL and e5 <= ATOL):
            fail(f"B4/B5 disagree with their plain versions ({what})")
        err_b4, err_b5 = max(err_b4, e4), max(err_b5, e5)
    w_same = state_w()[1]
    same_bits("B4 dcd_feature_gram (webspam split)",
              lambda: feat.dcd_feature_gram(cols_w, vals_w, w_same, ids_w[0],
                                            workspace=ws), torch)
    a_same = torch.zeros(n_w, device=dev)
    b_same, g_same = ops.dcd_feature_gram(cols_w, vals_w, w_same, ids_w[0],
                                          workspace=ws)
    same_bits("B5 dcd_feature_update (webspam split, hinge, mask, labels)",
              lambda: feat.dcd_feature_update(
                  cols_w, vals_w, a_same, q_w, w_same, ids_w[0], b_same,
                  g_same, loss=duals.Hinge(1.0), active=act_w, y=y_w,
                  workspace=ws), torch)

    # times per launch at the main path's shape (hinge, B = 64 ids, from
    # α = 0 and a small w, where every update scatters)
    a_w, w_w = state_w()
    t_ids_w = blocks(n_w, 64)
    ms_b4 = cuda_ms(lambda: feat.dcd_feature_gram(
        cols_w, vals_w, w_w, t_ids_w[next(it) % 64], workspace=ws), 50,
        torch)
    plain_b4 = wall_ms(lambda: feat.dcd_feature_gram_plain(
        cols_w, vals_w, w_w, t_ids_w[0]), 2, torch)
    # B5 as the main path calls it: with the buckets B4 left for this block
    base_w, gram_w = ops.dcd_feature_gram(cols_w, vals_w, w_w, ids_w[0],
                                          workspace=ws)
    a_l = torch.full((n_w,), 0.25, device=dev)  # inside logistic's domain
    ms_b5 = cuda_ms(lambda: feat.dcd_feature_update(
        cols_w, vals_w, a_w, q_w, w_w, ids_w[0], base_w, gram_w,
        loss=hinge, workspace=ws), 50, torch)
    b5_more = {
        "alone (own bucket pass)": cuda_ms(lambda: feat.dcd_feature_update(
            cols_w, vals_w, a_w, q_w, w_w, ids_w[0], base_w, gram_w,
            loss=hinge), 50, torch),
        "logistic": cuda_ms(lambda: feat.dcd_feature_update(
            cols_w, vals_w, a_l, q_w, w_w, ids_w[0], base_w, gram_w,
            loss=duals.Logistic(1.0), workspace=ws), 50, torch)}
    print("  B5 dcd_feature_update ms per launch, also: " + ", ".join(
        f"{k} {v:.4f}" for k, v in b5_more.items()))
    plain_b5 = wall_ms(lambda: feat.dcd_feature_update_plain(
        cols_w, vals_w, a_w, q_w, w_w, ids_w[0], base_w, gram_w,
        loss=hinge), 2, torch)
    # the same calls timed as they are issued, without the spin (how the
    # earlier times were taken): B1 staged and wide at the rcv1 shape, B4
    gated = {
        "B1 staged": cuda_ms(lambda: dcd_ell_epoch(
            X_rcv1.indices, X_rcv1.values, a_r, w_r, q_r, loss=hinge,
            idx=t_ids[next(it) % 64]), 50, torch, spin=False),
        "B1 wide": cuda_ms(lambda: dcd_ell_epoch(
            X_rcv1.indices, X_rcv1.values, a_r, w_r, q_r, loss=hinge,
            idx=t_ids[next(it) % 64], wide=True), 50, torch, spin=False),
        "B4": cuda_ms(lambda: feat.dcd_feature_gram(
            cols_w, vals_w, w_w, t_ids_w[next(it) % 64], workspace=ws), 50,
            torch, spin=False)}
    print("  host-gated ms per launch (no spin): " + ", ".join(
        f"{k} {v:.4f}" for k, v in gated.items()))

    # B4's library yardstick: each shard's block as a (B, d_loc + 1)
    # sparse matrix times its transpose, torch.sparse.mm, built outside
    # the timed region; the port never calls it
    def sparse_block(j, ids):
        c, v = cols_w[ids.long(), j], vals_w[ids.long(), j]
        real = c < d_loc
        rows = torch.arange(B, device=dev)[:, None].expand_as(c)[real]
        cr = c[real].long()
        return (torch.sparse_coo_tensor(torch.stack([rows, cr]), v[real],
                                        (B, d1_w)).coalesce(),
                torch.sparse_coo_tensor(torch.stack([cr, rows]), v[real],
                                        (d1_w, B)).coalesce())

    mats = [sparse_block(j, t_ids_w[0]) for j in range(SHARDS)]
    lib_b4 = cuda_ms(lambda: [torch.sparse.mm(S, St) for S, St in mats], 20,
                     torch)
    # bytes each timed call must move and its float32 operations, from
    # this run's blocks (real entries only where the work skips padding)
    nnz4 = int((cols_w[t_ids_w[0].long()] < d_loc).sum())
    nnz5 = int((cols_w[ids_w[0].long()] < d_loc).sum())
    by_b4 = (4 * B * SHARDS * k_loc + 8 * nnz4 + 4 * B
             + 4 * SHARDS * (B + B * B))
    by_b5 = (8 * n_w + 8 * SHARDS * d1_w + 4 * B * SHARDS * k_loc
             + 4 * nnz5 + 12 * B + 4 * B * B)
    for name, variant, route_ms, pl_ms, lib_ms, by, ops_n, per, err, rep in [
        ("dcd_feature_gram", "column-class", ms_b4, plain_b4, lib_b4,
         by_b4, 2 * B * nnz4 + 2 * nnz4, f"webspam shards, {B} ids", err_b4,
         "src/repro/kernels/dcd_feature.py:60"),
        ("dcd_feature_update", "column-class", ms_b5, plain_b5, None, by_b5,
         2 * nnz5 + B * B, f"webspam shards, {B} ids", err_b5,
         "src/repro/kernels/dcd_feature.py:106"),
    ]:
        b_ms, b_by = bound(by, ops_n)
        results[name] = dict(name=name, route="cuda",
                             source="src/repro_torch/kernels/csrc/"
                                    "dcd_feature.cu",
                             replaces=rep, variant=variant, launches=0,
                             max_abs_err=err, ms=route_ms, plain_ms=pl_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        if name == "dcd_feature_update":
            results[name].update(
                ms_alone=b5_more["alone (own bucket pass)"],
                ms_logistic=b5_more["logistic"])
        lib = ("no library call computes it" if lib_ms is None
               else f"torch.sparse.mm {lib_ms:.4f} ms")
        print(f"  {name} ({per}): {route_ms:.4f} ms per launch, plain "
              f"{pl_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by}), {lib}")
    # where a round's time goes: 20 rounds of the solver's fused 2-D
    # engine on webspam (B4, the sum over shards, B5, the Δw round trip)
    # and of its 1-D engine on rcv1 (B1 and the wrapper's copies, Δw and
    # w + Δw), under torch.profiler
    engine = functools.partial(
        _block_update_2d(hinge, True, ws), cols_w, vals_w, q_w)
    w_p = torch.zeros_like(w_w)
    _scan_rounds(engine, a_w, w_p, w_p, t_ids_w[:2], 0)  # warm
    profile_rounds("webspam (2-D, fused)", lambda: _scan_rounds(
        engine, a_w, w_p, w_p, t_ids_w[:20], 0), 20, torch)
    engine_1d = functools.partial(
        _block_update_1d(hinge, True), (X_rcv1.indices, X_rcv1.values), q_r)
    a_p, w_p1 = zeros_r()
    _scan_rounds(engine_1d, a_p, w_p1, w_p1, t_ids[:2], 0)  # warm
    profile_rounds("rcv1 (1-D, B1 staged)", lambda: _scan_rounds(
        engine_1d, a_p, w_p1, w_p1, t_ids[:20], 0), 20, torch)
    engine_c = functools.partial(_block_update_1d(hinge_c, False), X_cov, q_c)
    a_pc, w_pc = zeros_c()
    _scan_rounds(engine_c, a_pc, w_pc, w_pc, c_ids[:2], 0)  # warm
    profile_rounds("covtype (1-D, B2 staged)", lambda: _scan_rounds(
        engine_c, a_pc, w_pc, w_pc, c_ids[:20], 0), 20, torch)
    del fse, cols_w, vals_w, q_w, ws, mats, a_w, w_w, ka, kw, pa, pw
    del engine, w_p, w_same, a_w1, w_w1, a_same, b_same, g_same, a_l
    torch.cuda.empty_cache()

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
    # the 2-D solve: B4 → sum → B5 on the card, overlapped (delay 1),
    # against the same fused engine's plain versions on the CPU
    kw = dict(mesh=solver_mesh_2d(model=2), epochs=3, block_size=32,
              delay_rounds=1, blocks=sched)
    on_card = sharded_passcode_solve(small.X_train.to(dev), hinge,
                                     device=dev, **kw)
    on_cpu = sharded_passcode_solve(small.X_train, hinge, device="cpu",
                                    use_kernel=True, **kw)
    e = max(float((on_card.alpha.cpu() - on_cpu.alpha).abs().max()),
            float((on_card.w_hat.cpu() - on_cpu.w_hat).abs().max()))
    print(f"  solver 2-D (m = 2, overlapped) kernel path vs CPU path: max "
          f"abs err {e:.3g} (tolerance {ATOL})")
    if not e <= ATOL:
        fail("the solver's 2-D kernel path disagrees with its CPU path")

    # ----------------------------------------------------- 4. main paths
    # each kernel's launch count; B1's, B2's and B3's two variants count
    # apart
    counters = {"dcd_ell": (dcd_ell_epoch, "staged"),
                "dcd_ell_wide": (dcd_ell_epoch, "wide"),
                "dcd_indexed": (dcd_indexed_epoch, "staged"),
                "dcd_indexed_wide": (dcd_indexed_epoch, "wide"),
                "dcd_tile": (dcd_tile_epoch, "stream"),
                "dcd_tile_wide": (dcd_tile_epoch, "wide"),
                "dcd_feature_gram": (feat.dcd_feature_gram, None),
                "dcd_feature_update": (feat.dcd_feature_update, None)}

    def launches(f, variant):
        return f.variant_launches[variant] if variant else f.launches

    def run_path(label, want, fn):
        """Run one main path with every launch count set to 0 just before
        it; read the counts just after and hold them to ``want`` (every
        other kernel: 0 launches)."""
        for f, _ in counters.values():
            f.launches = 0
            for v in getattr(f, "variant_launches", {}):
                f.variant_launches[v] = 0
        fn()
        for name, (f, variant) in counters.items():
            got, expect = launches(f, variant), want.get(name, 0)
            if name in want:
                results[name]["launches"] = got
                print(f"  launches {name} ({label}): {got} (expected "
                      f"{expect})")
            if got != expect:
                fail(f"{label}: {name} launched {got} times, expected "
                     f"{expect}")

    def solve(label, X, loss, n, epochs, accuracy=True, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = sharded_passcode_solve(X, loss, epochs=epochs, block_size=B,
                                   gap_every=1, seed=0, device=dev, **kw)
        gaps = r.gaps.tolist()  # the solve's one host sync
        sec = time.perf_counter() - t0
        nb = _n_blocks(n, B)
        print(f"  {label}: {sec / epochs:.3f} s per epoch (gap included), "
              f"{epochs * nb * B / sec:.4g} updates/s, {nb} rounds per "
              f"epoch ({sec / epochs / nb * 1e3:.4f} ms per round), peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        print(f"    gaps {gaps}")
        print(f"    eps  {r.eps.tolist()}")
        if accuracy:
            print(f"    train accuracy "
                  f"{float(predict_accuracy(r.w_hat, X)):.4f}")
        if r.alpha.shape != (n,) or not all(math.isfinite(g) for g in gaps):
            fail(f"{label}: result of the wrong shape or a non-finite gap")
        if not gaps[-1] < gaps[0]:
            fail(f"{label}: the duality gap did not fall: {gaps}")

    nb_r, nb_c = EPOCHS * _n_blocks(n_r, B), EPOCHS * _n_blocks(n_c, B)
    run_path("rcv1", {"dcd_ell": nb_r}, lambda: solve(
        "rcv1 (ELL, B1)", X_rcv1, duals.Hinge(1.0), n_r, EPOCHS))
    run_path("covtype", {"dcd_indexed": nb_c}, lambda: solve(
        "covtype (dense, B2 staged)", X_cov, duals.Hinge(0.0625), n_c,
        EPOCHS))

    def in_order():
        # the in-order epoch entry point (B3) on covtype, as the examples
        # run it
        alpha = torch.zeros(n_c, device=dev)
        w = torch.zeros(d_c, device=dev)
        g0 = float(duality_gap(alpha, X_cov, hinge_c))
        t0 = time.perf_counter()
        for _ in range(2):
            alpha, w = ops.dcd_epoch(X_cov, alpha, w, q_c, c=0.0625)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        g2 = float(duality_gap(alpha, X_cov, hinge_c))
        print(f"  covtype in-order epochs (B3 stream): 2 epochs in "
              f"{sec:.4f} s ({sec / 2:.4f} s per epoch), gap {g0:.6g} -> "
              f"{g2:.6g}")
        if not (math.isfinite(g2) and g2 < g0):
            fail(f"in-order epochs: the gap did not fall ({g0} -> {g2})")

    run_path("covtype in order", {"dcd_tile": 2}, in_order)
    nb_w = EPOCHS_2D * _n_blocks(X_web.n_rows, B)
    print(f"  webspam 2-D: m = {SHARDS} shards, k_loc {k_loc}, split "
          f"{split_gb:.2f} GB (cols and vals)")
    run_path("webspam", {"dcd_feature_gram": nb_w, "dcd_feature_update": nb_w},
             lambda: solve("webspam (2-D, B4 + B5)", X_web, duals.Hinge(1.0),
                           X_web.n_rows, EPOCHS_2D, accuracy=False,
                           mesh=solver_mesh_2d(model=SHARDS)))
    nb_w1 = EPOCHS_2D * _n_blocks(n_w1, B)
    run_path("webspam 1-D", {"dcd_ell_wide": nb_w1},
             lambda: solve("webspam (1-D, ELL, B1 wide)", X_web,
                           duals.Hinge(1.0), n_w1, EPOCHS_2D,
                           accuracy=False))

    # ---------------------------------------------------------- 5. result
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   a few rows for the other losses; B4 (block Gram) and B5 (Gram
   δ-recursion) on the webspam shape split into m = 4 feature shards,
   a few rounds of B = 64 ids per loss.  Each prints its max abs error
   against the tolerance and its time per launch from CUDA events;
   then the solver's kernel paths against their CPU paths on a small
   input (1-D, and 2-D with the overlapped round);
4. the main paths, each with every launch count set to 0 just before
   it and read just after: ``sharded_passcode_solve`` on rcv1
   (n = 677,399, d = 47,236, 73 nnz per row, hinge C = 1, B = 64,
   3 epochs, the gap every epoch) and on covtype (n = 581,012, d = 54
   dense, C = 0.0625), the in-order epoch entry point ``ops.dcd_epoch``
   on covtype, and the 2-D solve on webspam (n = 280,000,
   d = 16,609,143, 3,728 nnz per row, hinge C = 1, B = 64, m = 4
   feature shards, 2 epochs); each must go through its kernels, launch
   them the expected number of times, and give finite duality gaps that
   fall;
5. one JSON line of per-kernel numbers, then the result line
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
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import duals
    from repro_torch.core.objective import duality_gap, predict_accuracy
    from repro_torch.core.sharded import (
        _block_update_2d,
        _n_blocks,
        _scan_rounds,
        sharded_passcode_solve,
    )
    from repro_torch.data.sparse import ell_column_split
    from repro_torch.data.synthetic import make_dataset, make_paper_split
    from repro_torch.dist.mesh import solver_mesh_2d
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
    scratch = feat.gram_scratch(SHARDS, d1_w, dev)
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
                                           scratch=scratch)
            pb, pg = feat.dcd_feature_gram_plain(cols_w, vals_w, pw,
                                                 ids_w[r])
            e4 = max(e4, float((kb - pb).abs().max()),
                     float((kg - pg).abs().max()))
            ka, kw = feat.dcd_feature_update(
                cols_w, vals_w, ka, q_w, kw, ids_w[r], kb.sum(0), kg.sum(0),
                loss=loss, **extra)
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
    if float(scratch.abs().max()) != 0.0:
        fail("B4 left its scratch dirty")

    # times per launch at the main path's shape (hinge, B = 64 ids, from
    # α = 0 and a small w, where every update scatters)
    a_w, w_w = state_w()
    t_ids_w = blocks(n_w, 64)
    base_w, gram_w = ops.dcd_feature_gram(cols_w, vals_w, w_w, ids_w[0],
                                          scratch=scratch)
    ms_b4 = cuda_ms(lambda: feat.dcd_feature_gram(
        cols_w, vals_w, w_w, t_ids_w[next(it) % 64], scratch=scratch), 50,
        torch)
    plain_b4 = wall_ms(lambda: feat.dcd_feature_gram_plain(
        cols_w, vals_w, w_w, t_ids_w[0]), 2, torch)
    ms_b5 = cuda_ms(lambda: feat.dcd_feature_update(
        cols_w, vals_w, a_w, q_w, w_w, ids_w[0], base_w, gram_w,
        loss=hinge), 50, torch)
    plain_b5 = wall_ms(lambda: feat.dcd_feature_update_plain(
        cols_w, vals_w, a_w, q_w, w_w, ids_w[0], base_w, gram_w,
        loss=hinge), 2, torch)

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
    for name, route_ms, pl_ms, lib_ms, by, ops_n, per, err, rep in [
        ("dcd_feature_gram", ms_b4, plain_b4, lib_b4, by_b4,
         2 * B * nnz4 + 2 * nnz4, f"webspam shards, {B} ids", err_b4,
         "src/repro/kernels/dcd_feature.py:60"),
        ("dcd_feature_update", ms_b5, plain_b5, None, by_b5,
         2 * nnz5 + B * B, f"webspam shards, {B} ids", err_b5,
         "src/repro/kernels/dcd_feature.py:106"),
    ]:
        b_ms, b_by = bound(by, ops_n)
        results[name] = dict(name=name, route="cuda",
                             source="src/repro_torch/kernels/csrc/"
                                    "dcd_feature.cu",
                             replaces=rep, launches=0, max_abs_err=err,
                             ms=route_ms, plain_ms=pl_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms)
        lib = ("no library call computes it" if lib_ms is None
               else f"torch.sparse.mm {lib_ms:.4f} ms")
        print(f"  {name} ({per}): {route_ms:.4f} ms per launch, plain "
              f"{pl_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by}), {lib}")
    # where a webspam round's time goes: 20 rounds of the solver's fused
    # 2-D engine (B4, the sum over shards, B5, the Δw round trip) under
    # torch.profiler; device time by kernel against the rounds' wall time
    engine = functools.partial(
        _block_update_2d(hinge, True, scratch), cols_w, vals_w, q_w)
    w_p = torch.zeros_like(w_w)
    _scan_rounds(engine, a_w, w_p, w_p, t_ids_w[:2], 0)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _scan_rounds(engine, a_w, w_p, w_p, t_ids_w[:20], 0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 20
    dev_us = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        if t > 0 and not ev.key.startswith("aten::"):
            dev_us[ev.key[:40]] = dev_us.get(ev.key[:40], 0) + t
    busy = sum(dev_us.values()) / 1e3 / 20
    print(f"  webspam round profile (20 fused rounds): {wall:.4f} ms wall, "
          f"{busy:.4f} ms device busy, idle share "
          f"{max(0.0, 1 - busy / wall):.3f}")
    for key, t in sorted(dev_us.items(), key=lambda kv: -kv[1]):
        print(f"    {t / 1e3 / 20:.4f} ms per round  {key}")
    del fse, cols_w, vals_w, q_w, scratch, mats, a_w, w_w, ka, kw, pa, pw
    del engine, w_p, prof
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
    counters = {"dcd_ell": dcd_ell_epoch, "dcd_indexed": dcd_indexed_epoch,
                "dcd_tile": dcd_tile_epoch,
                "dcd_feature_gram": feat.dcd_feature_gram,
                "dcd_feature_update": feat.dcd_feature_update}

    def run_path(label, want, fn):
        """Run one main path with every launch count set to 0 just before
        it; read the counts just after and hold them to ``want`` (every
        other kernel: 0 launches)."""
        for f in counters.values():
            f.launches = 0
        fn()
        for name, f in counters.items():
            expect = want.get(name, 0)
            if name in want:
                results[name]["launches"] = f.launches
                print(f"  launches {name} ({label}): {f.launches} (expected "
                      f"{expect})")
            if f.launches != expect:
                fail(f"{label}: {name} launched {f.launches} times, "
                     f"expected {expect}")

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
        "covtype (dense, B2)", X_cov, duals.Hinge(0.0625), n_c, EPOCHS))

    def in_order():
        # the in-order epoch entry point (B3) on covtype, as the examples
        # run it
        alpha = torch.zeros(n_c, device=dev)
        w = torch.zeros(d_c, device=dev)
        g0 = float(duality_gap(alpha, X_cov, hinge_c))
        t0 = time.perf_counter()
        for _ in range(2):
            alpha, w = ops.dcd_epoch(X_cov, alpha, w, q_c, c=0.0625)
        g2 = float(duality_gap(alpha, X_cov, hinge_c))
        print(f"  covtype in-order epochs (B3): 2 epochs in "
              f"{time.perf_counter() - t0:.3f} s, gap {g0:.6g} -> {g2:.6g}")
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

    # ---------------------------------------------------------- 5. result
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

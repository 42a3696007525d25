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
   register and spill report; then phases 7 and 8 (below), first in
   time so that their children have the card's memory to themselves,
   then the data, then phase 9 (below);
3. each kernel against its plain version at the shapes the main path
   gives it: B1 (ELL) on the rcv1-shape shard (its staged variant) and
   on webspam's rows (its wide variant), and B2 (dense indexed) on the
   covtype-shape shard (its staged variant, and its wide one as
   ``ms_before``), a few rounds of B = 64 ids each, through the
   shard-grid wrappers over a grid of one shard, as the p = 1 solver
   round calls them; B3
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
   (host-gated).  The shard grid: B1 (staged at rcv1's rows, p = 8;
   wide at webspam's rows, p = 2), B2 (staged at covtype's rows, p = 8)
   and B4 + B5 (webspam split, data = 2, m = 4), each launch a grid of
   p data shards laid out as the solver lays them out (the tail padded),
   held to its plain version over a few rounds from α = 0 (each shard's
   Δw, α and w; hinge, and squared hinge and logistic on one round), its
   second launch to the same bits, and timed.  The task grid of the
   multi-task (one-vs-rest) solve: B1 at rcv1 with K = 53 classes over
   p = 8 shards (424 CTAs), B2 at covtype with K = 7 over p = 8, and B4 +
   B5 at the webspam split with K = 4 (m = 4), each launch K tasks with
   their own α, w and labels on the shared rows, held to its plain
   version over 2 rounds from α = 0, its second launch to the same bits,
   and timed.  The pod grid of the pod solve (Hybrid-DCA): B1 at rcv1
   with P = 2 pods of p = 4 shards, B2 at covtype (2, 4) (each pod's rows
   padded to its own p·n_loc slots, as the solver lays them out) and B4 +
   B5 at the webspam split (2, 1) with m = 4, each launch every pod's
   shards, pod k's reading pod k's own w, held to its plain version over
   2 rounds from α = 0 with hinge and one round with squared hinge and
   logistic, its second launch to the same bits, and timed.  The
   baselines' wide launches at their full shapes: B2 over the first
   outer round of ``cocoa_solve`` on covtype (8 CTAs of 72,626 ids, the
   partitions' whole local epochs) and B1 over the first epoch of
   ``cocoa_pod_solve`` on rcv1's first ``PASSCODE_ROWS`` rows (2 CTAs of
   50,048 ids, each pod's drawn blocks), each laid out and drawn as its
   solve does, held to its plain version over the whole round with
   hinge and over each CTA's first ``PREFIX`` ids with the other two
   losses, its second launch to the same bits, and timed.  Each
   whole-round launch (B3's epoch, the whole-epoch orders below, these
   rounds) is held to its plain version replayed on CPU copies of the
   same inputs, and the plain version is timed on the card over the
   round's first ``PLAIN_IDS`` updates.  ``torch.profiler`` views
   20 rounds of the rcv1, the covtype and the webspam solve, at p = 1
   and over the shard grid (wall time, device-busy time, idle share);
   then the solver's kernel paths against their CPU paths on a small
   input (1-D, and 2-D with the overlapped round; p = 2 and 8, data =
   2, with shrinking and repacking, and p = 4 with an adaptive delay
   whose flag latches to 0; and the multi-task solve with K = 3 classes,
   1-D ELL at p = 2 with shrinking and repacking, dense at p = 4 with an
   adaptive delay, 2-D data = 2, m = 2 overlapped, each task's records
   equal); one p = 1 epoch of the rcv1, covtype and
   webspam-rows solves against the single-block round the solver ran
   before the shard grid, α and ŵ bit for bit; B1's and B2's wide variants over
   a whole epoch's order, the launch ``dcd_solve`` and PASSCoDe-Lock
   make (all n ids, timed; held to the plain version over the whole
   order with hinge, and over its first ``PREFIX`` ids with the other
   two losses; each launched twice to the same bits);
   B4 and B5 past 1,024 ids, in their rows layout, on one block of all
   ``SHIM_ROWS`` rows of rcv1's first rows split into m = 4 feature
   shards (held to their plain versions, B5 with each loss; each
   launched twice to the same bits; the rows ``dcd_feature_gram_rows``
   and ``dcd_feature_update_rows``);
4. the main paths, each with every launch count set to 0 just before
   it and read just after: ``sharded_passcode_solve`` on rcv1
   (n = 677,399, d = 47,236, 73 nnz per row, hinge C = 1, B = 64,
   3 epochs, the gap every epoch) and on covtype (n = 581,012, d = 54
   dense, C = 0.0625), the in-order epoch entry point ``ops.dcd_epoch``
   on covtype, and the 2-D solve on webspam (n = 280,000,
   d = 16,609,143, 3,728 nnz per row, hinge C = 1, B = 64, m = 4
   feature shards, 2 epochs), and webspam's rows on the 1-D mesh (2
   epochs, B1's wide variant); the same solves over p > 1 data shards
   (rcv1 and covtype at p = 8, webspam on the 2-D mesh at data = 2 and
   on the 1-D mesh at p = 2) and with the self-tuning (rcv1 at p = 8
   with shrinking and repacking, and again with the adaptive delay from
   delay_rounds = 1 at a gap-trend ratio of 0.3, its recorded flags held
   to the latch rule from its recorded gaps; webspam at data = 2 with
   shrinking), each printing
   its active fractions, delay flags, rounds run per epoch (the final
   epoch's all of them) and host reads of the round count, and calling
   no plain version; the multi-task (one-vs-rest) solve, its classes the
   argmax of x_iᵀV over a random (d, K) V drawn from the seed + 1: rcv1
   K = 53 at p = 8 (3 epochs, and again with shrinking and repacking
   below 0.8 active), covtype K = 7 at p = 8 (3 epochs), webspam on the
   2-D mesh with K = 4, m = 4 (2 epochs), each printing its seconds per
   epoch, each epoch's gaps over the tasks (min / median / max), rounds,
   peak memory and top-1 accuracy against the majority share (with
   shrinking the active fractions, rounds and host reads); K = 1 held
   bit for bit to the binary solve on folded rows (rcv1 and covtype,
   p = 8, one epoch), and the one solve to the loop over K binary solves
   (covtype's 7 classes, rcv1's classes 0, 26 and 52) at atol 1e-5;
   the pod solve (each epoch a Hybrid-DCA outer round, P = 2): rcv1 at
   (pod = 2, data = 4), 3 epochs at ``pod_delay_rounds`` 0 and 2 and at 2
   with the adaptive pod latch (ratio 0.3, its flags held to the latch
   rule from its gaps), ε at delay 0 at most 1e-4·‖ŵ‖ and at delay 2
   above it; covtype at (2, 4), delay 1, binary and with K = 7 classes;
   webspam at (2, 1, 4), 2 epochs, delay 1; each printing seconds per
   epoch, gaps and ε epoch by epoch, flags and peak memory; the rcv1 pod
   solve at (2, 1) held to the port's ``cocoa_pod_solve`` on the first
   ``PASSCODE_ROWS`` rows (2 epochs at delays 0 and 1, 3 at delay 2,
   atol 1e-5) and its error at full size printed; the paper's §5 comparison on covtype,
   PASSCoDe at p = 8, ``cocoa_solve`` (8 partitions, 3 rounds of one
   local epoch, one wide B2 launch of 8 CTAs a round) and
   ``asyscd_solve`` (8 threads, one epoch: on all rows, or the first
   ``PASSCODE_ROWS`` if its first 200 rounds put a full epoch past 60 s),
   their gaps and seconds per epoch, and all three (and the pod oracle)
   on the card against their CPU paths on ``tiny``;
   serial DCD (``dcd_solve``) and
   PASSCoDe-Lock (``passcode_solve``, 8 threads) on rcv1 and covtype, 3
   epochs each, one wide B1 (B2) launch per epoch, Lock's first epoch
   held to ``dcd_epoch`` over the same seeded order; PASSCoDe-Atomic and
   -Wild (8 threads, conflict rate 0.5, no delay) one epoch each on
   rcv1's first ``PASSCODE_ROWS`` rows with the backward-error report,
   each held to its CPU path on the same rows, and 20 Atomic rounds of
   the full rcv1 under ``torch.profiler``; all three memory models on the
   card against their CPU path on ``tiny``; and both example twins
   (``examples/quickstart_torch.py``, ``train_svm_passcode_torch.py``)
   as subprocesses on the card; the per-epoch host driver
   (``pipeline=False``, 2 epochs) against the pipelined solve at the
   same seed — rcv1 at p = 8 at delays 0 and 1, webspam on the 2-D mesh
   (m = 4) fused at delay 0 and overlapped at delay 1 — α and ŵ within
   1e-5, the gaps within 1e-3, s/epoch of both; and the
   ``sharded_passcode_feature`` shim on those ``SHIM_ROWS`` rows (1 and
   3 epochs, its gap falling).  Each must go through its kernels,
   launch them (and each variant of B1, B2 and B3) the expected number
   of times, and give finite duality gaps that fall (Wild, whose
   nominal gap is that of w̄: a finite gap, and the primal at ŵ below
   the primal at 0; its ε above Atomic's, and Atomic's at most
   1e-4·‖w̄‖);
5. the resilience phase (``resilience_phase``; ``repro_torch.resilience``
   at full Table-3 width, each path counted as a main path): rcv1 at
   p = 8 (B1's staged shard grid), 3 epochs, whole (twice: the second
   timed), segmented at ``checkpoint_every=1`` without and with
   checkpoints into ``build/chip_smoke_ckpt/`` (seconds per epoch each,
   a checkpoint's bytes, each save's seconds) and resumed from the last
   boundary but one (its load's seconds), α and ŵ bit for bit and the
   gaps at rtol 1e-6 against the whole solve; the fault harness on the
   same solve — a NaN in w at epoch 1 with ``delay_rounds=1`` (attempts
   (1, 2, 1), a code-2 trip, a bit-clean replay), NaN values in X for
   segment 1 (a code-2 trip, a bit-clean replay), the NaN kept armed
   (``SolverDiverged`` with a finite result) and armed only under
   asynchrony (rung 1 latched, healthy); rcv1 pods (2, 4) with the merge
   of epoch 1 dropped (a trip, a bit-clean replay); covtype K = 7 at
   p = 8 (B2's task grid) resumed from ``ckpt_1`` after the later ones
   are wiped, bit for bit; webspam on the 2-D mesh, m = 4,
   ``delay_rounds=1`` (the overlapped B4 + B5 round, its in-flight
   (base, Gram) rebuilt at each segment's entry), 2 epochs whole,
   segmented and segmented with checkpoints, bit for bit; a K = 53 rcv1
   checkpoint at p = 8 (its bytes, save and load seconds); and rcv1 pods
   (2, 4) in child processes on the card: killed by SIGKILL after its
   second segment (exit −9, only ``ckpt_1`` left), resumed on the same
   mesh (its uninterrupted run's bits) and onto (4, 2) (its last gap at
   most 2× the uninterrupted (4, 2) run's + 1e-3); then the phase's
   seconds;
6. the serving phase (``serve_phase``; ``repro_torch.serve`` at rcv1's
   full width, each path counted as a main path): a snapshot booted by
   ``load_snapshot`` from the checkpoint of a 2-epoch segmented rcv1
   solve at p = 8 (its ``w_pad[:d]`` and α the solve's bits);
   ``SERVE_ROWS`` rcv1 rows picked by the seed scored through ``submit``
   and ``step`` and held to a float64 host dot product at atol 1e-5 +
   1e-6·Σ|w_j x_j|; the threaded engine under a closed loop of 192
   requests in flight (20,000 requests, ``max_batch`` 64, queue depth
   512: p50, p99, requests/s, batches, rung steps; one dispatch's device
   time from CUDA events and one ``step()``'s wall time); a flood of
   3,000 requests at queue depth 32 and a 10 ms deadline (every ticket
   terminal, served + shed = submitted); 10 publishes of ŵ plus a seeded
   perturbation during 11,000 requests (nothing dropped, every version a
   published one, no batch version-mixed, every score held to its
   version's w on the host; the pauses) and one publish at webspam's
   width (d = 16,609,143) during 256 webspam rows; an
   ``IncrementalTrainer`` over rcv1 at p = 8 fitted for 2 epochs, the
   ``SERVE_ROWS`` rows ingested with flipped labels tripping the drift
   re-solve over 681,495 rows (its gap below a 2-epoch solve from
   scratch, the append's time); a persistent NaN on rcv1's first
   ``PASSCODE_ROWS`` rows giving up (nothing published, X, α and w kept,
   the reference's ledger) and a transient one recovering in one retry;
   the one-vs-rest trainer, K = 53 at p = 8, fitted for 1 epoch, 1,024
   rows scored in one dispatch against the (53, d + 1) stack (labels the
   argmax, margins held to the host), the ``SERVE_ROWS`` rows appended
   with their class ids and re-solved (α (53, 681,495)), published and
   scored again; then the phase's seconds;
7. the LM stack (``lm_phase``, in a child process: ``chip_smoke.py
   --lm-phase``): every arch of ``repro_torch.configs`` at its full
   published width in float32 and at full depth where the card holds it
   (qwen2-vl-72b and deepseek-coder-33b cut to 8 layers, phi3.5-moe to
   4, jamba on its smoke config: each cut and its reason printed), B = 2
   and S = 64: ``forward_train`` (finite logits), ``prefill`` of S
   tokens then ``decode_step`` of one against ``forward_train(moe_no_drop
   =True)`` at positions S − 1 and S (rtol/atol 2e-3), ``lm_features``
   for the decoder-only families; init seconds, forward, prefill and
   decode ms (CUDA events) and peak memory an arch; then the linear
   probe (``examples/linear_probe_lm_torch.py``) on the full-width
   mistral-nemo-12b's features (256 × 5120; B2's task grid and its wide
   epoch launch counted, added to the ``dcd_indexed_tasks`` and
   ``dcd_indexed_epoch`` rows) and on its smoke config, each above the
   majority share; the child's nonzero exit fails the script;
8. LM training and serving (``lm_train_phase``, in a second child
   process: ``chip_smoke.py --lm-train-phase``), in float32: (a) four
   train steps with remat on of minicpm-2b (WSD), mamba2-780m and
   granite-moe-3b-a800m at full published width and depth, B = 2,
   S = 64, on the Markov corpus — step 0's loss against the
   cross-entropy of an inference forward (1e-5 relative), every loss and
   grad norm finite, one step with remat off from the same parameters
   (loss and grad norm within 1e-4), ms a step (CUDA events), AdamW's
   time alone and its share, peak memory; then each arch's counted
   bound (``train_bound``): the port's dry-run cell
   (``repro_torch.launch.dryrun.run_cell``) on a 1 × 1 mesh at the same
   shape and float32 state, run on meta tensors under the per-device
   counter in this child (no byte allocated, its seconds printed) — one
   line beside the measured step with the FLOPs and HBM bytes a step,
   t_compute at 67 TFLOP/s, t_memory at 3.35 TB/s and the dominant
   term, the roofline share (bound over the mean of steps 1–3), the
   model FLOPs (6·N·tokens) and their share of the step at 67 TFLOP/s,
   the counted ``peak_bytes_est`` (and argument + temp) against
   ``torch.cuda.max_memory_allocated()``, and the card's name and power
   limit; the phase fails if the cell's ``argument_bytes`` are not the
   card's state and batch to the byte, if a measured step beats the
   bound, or if a figure is not finite and nonzero; (b) ``examples/
   train_lm_torch.py``'s LM_100M through the fault-tolerant loop, 60
   steps at B = 8, S = 256, a checkpoint every 20 steps and one fault
   injected at step 30 — one failure and one restart, the loss falling,
   ms a step, a checkpoint's save and restore seconds, the final
   checkpoint read back bit for bit; (c) ``repro_torch.launch.train``
   for 8 steps and ``repro_torch.launch.serve`` on mistral-nemo-12b and
   the hybrid, smoke configs — tokens in the vocabulary, the cache S +
   the decode steps long.  No kernel of B1–B5 runs here; the child's
   nonzero exit fails the script;
9. the solver across processes (``DistRun``, children of this script
   started after the data is drawn, which leaves them the card's memory
   but about 10 GB, and run while this process replays phase 3's
   whole-round plain versions on the host: two ``--dist-rank`` children
   in a ``gloo`` group, both on ``cuda:0``, then one ``--dist-one``
   child), at the full Table-3 widths, each rank
   placing only its part: rcv1 at p = 8 over the ``data`` axis (4
   shards a rank, B1 staged), 2 epochs, and again with shrinking and
   repacking below 0.8 over 3; webspam on the 2-D mesh, data = 1, m = 4
   over the ``model`` axis (2 feature shards a rank, B4 + B5, its ELL
   split from the host a row chunk at a time), 1 epoch; rcv1 pods
   (2, 4) over the ``pod`` axis (a pod a rank), ``pod_delay_rounds`` 1,
   2 epochs; rcv1 p = 8 segmented, checkpointed by rank 0 each epoch
   and resumed from epoch 1 by the one-process child.  Every child
   draws its data on the card and moves it to the host before it
   solves, so a peak is the solver's own.  Every run is held bit for
   bit (α, ŵ and every gap record) to the same solve in one process at
   the same mesh and seed, each rank's launches to the rounds it ran,
   each rank's peak memory to at most 0.6 of the one process's, and at
   rcv1 p = 8 each rank's placed X to half of the one process's; each
   prints s/epoch against the one process, the collective layer's ms a
   round, calls and bytes, and each rank's peak memory, beside the
   card's name and power limit.  Last, in the one-process child, a
   one-rank ``nccl`` group (NCCL refuses two ranks on one device): a
   solve on it would be the one-process path (one rank spreads
   nothing, and no collective runs), so it checks the transport alone —
   the layer's all_gather of a round's (1, 8, d + 1) Δw, the int64 SUM
   of the gap's d + 1 fixed-point words and of the active count, and
   the MAX of a scalar, each through NCCL at rcv1's shapes, back
   unchanged, with its ms (``--dist-phase`` runs the build and this
   phase alone);
10. one JSON line of per-kernel numbers (with each kernel's variant, and
   B1's, B2's and B3's ``ms_before``; the shard-grid kernels' rows are
   ``dcd_ell_shards``, ``dcd_ell_shards_wide``, ``dcd_indexed_shards``,
   ``dcd_feature_gram_data`` and ``dcd_feature_update_data``, the task
   grids' ``dcd_ell_tasks``, ``dcd_indexed_tasks``,
   ``dcd_feature_gram_tasks`` and ``dcd_feature_update_tasks``, the pod
   grids' ``dcd_ell_pods``, ``dcd_indexed_pods``,
   ``dcd_feature_gram_pods`` and ``dcd_feature_update_pods``, the
   baselines' wide launches ``dcd_indexed_cocoa`` and
   ``dcd_ell_cocoa_pods``, the rows layout's ``dcd_feature_gram_rows`` and
   ``dcd_feature_update_rows``; every row launched on a main path), then
   the result line
   ``{"ok": true, "device": {...}}``.

It needs one CUDA card and exits non-zero without one.  Data comes from
a fixed seed on the card; nothing is read from disk or the network.
"""

import functools
import json
import math
import os
import re
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
PREFIX = 4096  # ids of an epoch's order for the other losses' check
ADAPTIVE_RATIO = 0.3  # the full-size adaptive path's gap-trend ratio
THREADS = 8  # PASSCoDe's simulated threads (the examples' Atomic/Wild(8))
PASSCODE_ROWS = 100_000  # rcv1 rows of the Atomic and Wild epochs
TWIN_EPOCHS = 3
SEED = 0  # the solves' seed; the multi-task classes draw V from SEED + 1
# the multi-task paths' class counts: LIBSVM's rcv1.multiclass has 53
# classes, covtype 7 cover types; webspam's 4 keep its 2-D state small
K_R, K_C, K_W = 53, 7, 4
SHIM_ROWS = 4096  # the shim's rcv1 rows: one block, a 64 MB Gram
# the whole-round launches (B3's covtype epoch, B1's and B2's whole-epoch
# orders, CoCoA's rounds) are held to their plain version over the whole
# round, replayed on CPU copies of the same inputs (``replay_on_host``:
# each update's few torch ops cost about 0.04–0.07 ms there against
# 0.11–0.15 ms of launches on the card, where the whole rounds took
# 280–380 s of the run); the plain version on the card is timed over the
# round's first PLAIN_IDS updates (each CTA's first PLAIN_IDS / CTAs)
PLAIN_IDS = 32_768


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


def replay_on_host(plain, *args):
    """``plain(*args)`` with every tensor of ``args`` copied to the CPU
    (``plain`` closes over CPU copies of the rows it reads).  Returns its
    outputs, on the CPU, and its seconds."""
    args = [a.cpu() if hasattr(a, "cpu") else a for a in args]
    t0 = time.perf_counter()
    out = plain(*args)
    return out, time.perf_counter() - t0


def max_err(kernel_out, plain_out):
    """The largest |kernel − plain| over paired outputs, compared on the
    plain outputs' device."""
    return max(float((k.to(p.device) - p).abs().max())
               for k, p in zip(kernel_out, plain_out))


def same_bits(label, fn, torch):
    """Launch ``fn`` twice on the same inputs; fail unless every output
    has the same bits."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"  {label}: second launch bit-identical: {same}")
    if not same:
        fail(f"{label}: two launches on the same inputs differ")


PROFILED_TWICE = []  # the windows profile_rounds had to take again


def profile_rounds(label, run, rounds, torch):
    """Device time by kernel of ``run()`` (``rounds`` solver rounds)
    under torch.profiler, against the rounds' wall time.  A window in
    which the profiler delivered no device activity at all (its CUPTI
    buffers lost it: seen once, on rounds whose kernels the other
    windows of the same run saw) is profiled once more; a second empty
    window fails."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in (1, 2):
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
        if busy > 0.0:
            break
        print(f"  {label}: the profiler saw no device time in window "
              f"{attempt}")
        PROFILED_TWICE.append(label)
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


# a child of the resilience phase's kill check: rcv1 drawn as the parent
# draws it, solved on a pod mesh; "kill" dies by the fault harness after
# its second segment and before its save, "resume" resumes on the same
# mesh beside an uninterrupted run, "elastic" resumes onto (4, 2) beside
# an uninterrupted (4, 2) run; the last two print one JSON line
KILL_CHILD = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.core.duals import Hinge
from repro_torch.data.synthetic import make_paper_split
from repro_torch.dist.mesh import SolverMesh
from repro_torch.resilience import FaultPlan, solve_segmented

mode, ckpt = sys.argv[2], sys.argv[3]
X, _ = make_paper_split("rcv1", seed=0, device="cuda")
kw = dict(epochs=3, checkpoint_every=1, block_size=64, seed=0,
          device="cuda")
mesh = SolverMesh(("pod", "data"), (4, 2) if mode == "elastic" else (2, 4))
if mode == "kill":
    solve_segmented(X, Hinge(1.0), mesh=mesh, ckpt_dir=ckpt,
                    fault_plan=FaultPlan(sigkill_segment=1), **kw)
    print("UNREACHABLE")
    sys.exit(0)
full = solve_segmented(X, Hinge(1.0), mesh=mesh, **kw)
res = solve_segmented(X, Hinge(1.0), mesh=mesh, ckpt_dir=ckpt, resume=True,
                      **kw)
print(json.dumps({
    "resumed_from": res.resumed_from, "attempts": list(res.attempts),
    "bits": bool(torch.equal(full.result.alpha, res.result.alpha)
                 and torch.equal(full.result.w_hat, res.result.w_hat)),
    "gaps": res.result.gaps.tolist(), "full_gaps": full.result.gaps.tolist()}))
"""


def resilience_phase(torch, dev, run_path, X_rcv1, X_cov, X_web, Y_cov,
                     Y_rcv1):
    """The segmented solve (``repro_torch.resilience``) at full Table-3
    width through the kernels its meshes launch: rcv1 at p = 8 (B1's
    staged shard grid) segmented against whole, its checkpoints' bytes
    and save and load seconds, and every fault of the harness with its
    recovery; rcv1 pods (2, 4) with a dropped merge and killed in a child
    process (a bit resume, and an elastic one onto (4, 2)); covtype
    K = 7 at p = 8 (B2's task grid) resumed; webspam on the 2-D mesh
    (B4 + B5, the overlapped round) segmented; a K = 53 rcv1 checkpoint.
    α and ŵ bit for bit against the uninterrupted or clean run, the gaps
    at rtol 1e-6 (the gap's sum adds with float atomics)."""
    import shutil

    from repro_torch.core import duals
    from repro_torch.core.sharded import _n_blocks, sharded_passcode_solve
    from repro_torch.dist.mesh import SolverMesh, solver_mesh, solver_mesh_2d
    from repro_torch.resilience import (
        FaultPlan,
        SolverDiverged,
        solve_segmented,
    )
    from repro_torch.resilience import segmented as seg_mod

    t_phase = time.perf_counter()
    hinge1, hinge_c = duals.Hinge(1.0), duals.Hinge(0.0625)
    n_r, n_c, n_w = X_rcv1.n_rows, X_cov.shape[0], X_web.n_rows
    nb_r8 = _n_blocks(-(-n_r // 8), B)
    nb_c8 = _n_blocks(-(-n_c // 8), B)
    nb_rp = _n_blocks(-(-(-(-n_r // 2)) // 4), B)
    nb_w = _n_blocks(n_w, B)
    mesh_r8, mesh_c8 = solver_mesh(n_devices=8), solver_mesh(n_devices=8)
    mesh_rp = SolverMesh(("pod", "data"), (2, 4))
    ckroot = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckroot, ignore_errors=True)
    ckroot.mkdir(parents=True)

    # the boundaries' saves and the resumes' restores, timed where the
    # solve makes them; the watchdog's codes as the host reads them
    io = {"save": [], "load": []}
    codes = []
    save, restore, health = (seg_mod._save_boundary, seg_mod._restore,
                             seg_mod._health)

    def timed_io(kind, f):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*a, **k)
            torch.cuda.synchronize()
            io[kind].append(time.perf_counter() - t0)
            return out
        return call

    def read_health(st):
        codes.append(health(st))
        return codes[-1]

    seg_mod._save_boundary = timed_io("save", save)
    seg_mod._restore = timed_io("load", restore)
    seg_mod._health = read_health

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def bits(label, a, b):
        same = torch.equal(a.alpha, b.alpha) and torch.equal(a.w_hat,
                                                             b.w_hat)
        ga, gb = a.gaps.cpu().double(), b.gaps.cpu().double()
        diff = (ga - gb).abs()
        rel = float((diff / gb.abs().clamp(min=1e-30)).max())
        print(f"    {label}: α and ŵ bit-identical: {same}; gaps "
              f"{a.gaps.tolist()} (largest relative difference {rel:.3g}, "
              "tolerance 1e-6)")
        if not same:
            fail(f"resilience: {label}: α or ŵ differ")
        if not bool((diff <= 1e-6 * gb.abs()).all()):
            fail(f"resilience: {label}: the gaps differ past rtol 1e-6")

    def ckpt_bytes(d):
        return sum(f.stat().st_size for f in Path(d).rglob("*")
                   if f.is_file())

    def recovery(label, r):
        print(f"    {label}: health {r.health}, attempts {r.attempts}, "
              f"rollbacks {r.rollbacks}, rung {r.rung}, epochs lost "
              f"{r.epochs_lost}, resumed from {r.resumed_from}")

    kw_r = dict(epochs=EPOCHS, block_size=B, seed=SEED, device=dev,
                mesh=mesh_r8)
    out = {}

    def rcv1_segmented():
        # the whole solve twice: the first warms the path, the second is
        # timed
        for _ in range(2):
            out["whole"], t_w = wall(lambda: sharded_passcode_solve(
                X_rcv1, hinge1, **kw_r))
        seg, t_s = wall(lambda: solve_segmented(
            X_rcv1, hinge1, checkpoint_every=1, **kw_r))
        d = str(ckroot / "rcv1")
        ck, t_c = wall(lambda: solve_segmented(
            X_rcv1, hinge1, checkpoint_every=1, ckpt_dir=d, keep=EPOCHS,
            **kw_r))
        print(f"  rcv1 p = 8, {EPOCHS} epochs: {t_w / EPOCHS:.4f} s per "
              f"epoch whole, {t_s / EPOCHS:.4f} segmented at "
              f"checkpoint_every=1, {t_c / EPOCHS:.4f} with its "
              f"checkpoints ({t_s / t_w:.3f}× and {t_c / t_w:.3f}× the "
              "whole solve)")
        recovery("segmented", seg)
        bits("segmented vs whole", seg.result, out["whole"])
        bits("checkpointed vs whole", ck.result, out["whole"])
        if seg.attempts != (1,) * EPOCHS or seg.health != 0:
            fail("resilience: the clean segmented run did not pass clean")
        n_b = ckpt_bytes(Path(d) / "ckpt_1")
        print(f"    a checkpoint takes {n_b} bytes; saves "
              f"{[round(s, 4) for s in io['save']]} s")
        shutil.rmtree(Path(d) / f"ckpt_{EPOCHS}")
        io["load"].clear()
        res = solve_segmented(X_rcv1, hinge1, checkpoint_every=1, ckpt_dir=d,
                              resume=True, keep=EPOCHS, **kw_r)
        recovery("resumed from the wiped last boundary", res)
        print(f"    load (read, convert, place): {io['load'][0]:.4f} s")
        bits("resumed vs whole", res.result, out["whole"])
        if res.resumed_from != EPOCHS - 1:
            fail(f"resilience: resumed from {res.resumed_from}")

    run_path("resilience: rcv1 p = 8 segmented",
             {"dcd_ell_shards": (4 * EPOCHS + 1) * nb_r8}, rcv1_segmented)

    def nan_fault():
        kw = dict(kw_r, delay_rounds=1, checkpoint_every=1)
        clean = sharded_passcode_solve(X_rcv1, hinge1, **{
            k: v for k, v in kw.items() if k != "checkpoint_every"})
        del codes[:]
        r = solve_segmented(X_rcv1, hinge1,
                            fault_plan=FaultPlan(nan_psum_epoch=1), **kw)
        recovery("NaN in w at epoch 1, delay_rounds 1", r)
        print(f"    watchdog codes read {codes}")
        if r.attempts != (1, 2, 1) or r.health != 0 or 2 not in codes:
            fail("resilience: the NaN fault did not trip code 2 and replay")
        bits("replayed vs clean", r.result, clean)

    run_path("resilience: rcv1 p = 8 NaN fault",
             {"dcd_ell_shards": (EPOCHS + 4) * nb_r8}, nan_fault)

    def payload_fault():
        del codes[:]
        r = solve_segmented(X_rcv1, hinge1, checkpoint_every=1,
                            fault_plan=FaultPlan(corrupt_payload_segment=1),
                            **kw_r)
        recovery("NaN values in X for segment 1 (5 %)", r)
        print(f"    watchdog codes read {codes}")
        if r.attempts != (1, 2, 1) or 2 not in codes:
            fail("resilience: the payload fault did not trip code 2")
        bits("replayed vs whole", r.result, out["whole"])

    run_path("resilience: rcv1 p = 8 payload fault",
             {"dcd_ell_shards": (EPOCHS + 1) * nb_r8}, payload_fault)

    def persistent():
        try:
            solve_segmented(X_rcv1, hinge1, checkpoint_every=1,
                            delay_rounds=1, fault_plan=FaultPlan(
                                nan_psum_epoch=1, persistent=True), **kw_r)
        except SolverDiverged as ex:
            fin = bool(torch.isfinite(ex.result.alpha).all()
                       and torch.isfinite(ex.result.w_hat).all())
            print(f"    SolverDiverged at epoch {ex.epoch}, history "
                  f"{ex.history}, its result finite: {fin}, rounds "
                  f"{ex.result.rounds}")
            if not fin or ex.epoch != 1 or ex.history != (1, 4):
                fail("resilience: SolverDiverged's result or record")
            return
        fail("resilience: a persistent fault did not raise SolverDiverged")

    run_path("resilience: rcv1 p = 8 persistent fault",
             {"dcd_ell_shards": 5 * nb_r8}, persistent)

    def async_only():
        r = solve_segmented(X_rcv1, hinge1, checkpoint_every=1,
                            delay_rounds=1, fault_plan=FaultPlan(
                                nan_psum_epoch=1, persistent=True,
                                async_only=True), **kw_r)
        recovery("a fault only under asynchrony", r)
        if r.rung != 1 or r.health != 0 or r.attempts != (1, 3, 1):
            fail("resilience: the ladder did not latch rung 1 and recover")

    run_path("resilience: rcv1 p = 8 async-only fault",
             {"dcd_ell_shards": 5 * nb_r8}, async_only)

    def drop_merge():
        kw = dict(kw_r, mesh=mesh_rp, checkpoint_every=1)
        clean = solve_segmented(X_rcv1, hinge1, **kw)
        del codes[:]
        r = solve_segmented(X_rcv1, hinge1,
                            fault_plan=FaultPlan(drop_merge_epoch=1), **kw)
        recovery("the merge of epoch 1 dropped, pods (2, 4)", r)
        print(f"    watchdog codes read {codes}; ε of the clean run "
              f"{clean.result.eps.tolist()}")
        if r.rollbacks < 1 or r.attempts != (1, 2, 1):
            fail("resilience: the dropped merge did not trip and replay")
        bits("replayed vs clean", r.result, clean.result)

    run_path("resilience: rcv1 pods (2, 4) dropped merge",
             {"dcd_ell_shards": (EPOCHS + 4) * nb_rp,
              "dcd_ell_pods": (EPOCHS + 4) * nb_rp}, drop_merge,
             {"dcd_ell_shards": None})

    def covtype_resume():
        d = str(ckroot / "covtype")
        kw = dict(kw_r, mesh=mesh_c8, y=Y_cov, checkpoint_every=1,
                  ckpt_dir=d, keep=EPOCHS)
        full = solve_segmented(X_cov, hinge_c, **kw)
        for s in range(2, EPOCHS + 1):
            shutil.rmtree(Path(d) / f"ckpt_{s}")
        io["load"].clear()
        res = solve_segmented(X_cov, hinge_c, resume=True, **kw)
        recovery(f"covtype K = {Y_cov.shape[0]}, p = 8, resumed from "
                 "ckpt_1", res)
        print(f"    checkpoint {ckpt_bytes(Path(d) / 'ckpt_1')} bytes, load "
              f"{io['load'][0]:.4f} s")
        if res.resumed_from != 1:
            fail("resilience: covtype did not resume from ckpt_1")
        bits("resumed vs uninterrupted", res.result, full.result)

    run_path(f"resilience: covtype K = {Y_cov.shape[0]} p = 8 resume",
             {"dcd_indexed_shards": (2 * EPOCHS - 1) * nb_c8,
              "dcd_indexed_tasks": (2 * EPOCHS - 1) * nb_c8},
             covtype_resume, {"dcd_indexed_shards": None})

    def webspam_segmented():
        kw = dict(epochs=EPOCHS_2D, block_size=B, seed=SEED, device=dev,
                  mesh=solver_mesh_2d(model=SHARDS), delay_rounds=1)
        whole, t_w = wall(lambda: sharded_passcode_solve(X_web, hinge1,
                                                         **kw))
        seg, t_s = wall(lambda: solve_segmented(
            X_web, hinge1, checkpoint_every=1, **kw))
        del io["save"][:]
        d = str(ckroot / "webspam")
        ck, t_c = wall(lambda: solve_segmented(
            X_web, hinge1, checkpoint_every=1, ckpt_dir=d, keep=EPOCHS_2D,
            **kw))
        print(f"  webspam 2-D m = {SHARDS}, delay_rounds 1 (overlapped): "
              f"{t_w / EPOCHS_2D:.4f} s per epoch whole, "
              f"{t_s / EPOCHS_2D:.4f} segmented at checkpoint_every=1, "
              f"{t_c / EPOCHS_2D:.4f} with its checkpoints (each solve's "
              f"column split included); a checkpoint "
              f"{ckpt_bytes(Path(d) / 'ckpt_1')} bytes, saves "
              f"{[round(s, 4) for s in io['save']]} s")
        recovery("segmented", seg)
        bits("segmented vs whole", seg.result, whole)
        bits("checkpointed vs whole", ck.result, whole)
        shutil.rmtree(d)

    # B4: one a round, plus the prologue a segment (the whole solve's one)
    run_path(f"resilience: webspam 2-D m = {SHARDS} segmented",
             {"dcd_feature_gram": 3 * EPOCHS_2D * nb_w + 1 + 2 * EPOCHS_2D,
              "dcd_feature_update": 3 * EPOCHS_2D * nb_w},
             webspam_segmented)

    def rcv1_k53_checkpoint():
        d = str(ckroot / "rcv1_k53")
        del io["save"][:]
        r = solve_segmented(X_rcv1, hinge1, epochs=1, checkpoint_every=1,
                            y=Y_rcv1, ckpt_dir=d, block_size=B, seed=SEED,
                            device=dev, mesh=mesh_r8)
        recovery(f"rcv1 K = {Y_rcv1.shape[0]}, p = 8, 1 epoch", r)
        print(f"    a K = {Y_rcv1.shape[0]} checkpoint takes "
              f"{ckpt_bytes(Path(d) / 'ckpt_1')} bytes, its save "
              f"{io['save'][0]:.4f} s")
        st, _, _ = seg_mod._restore(
            seg_mod.solver_mouth(X_rcv1, hinge1, y=Y_rcv1, device=dev,
                                 mesh=mesh_r8, block_size=B, seed=SEED),
            d, 1, 1, watchdog=True)
        print(f"    its load (read, convert, place) {io['load'][-1]:.4f} s")
        if st["alpha"].shape[0] != Y_rcv1.shape[0] or not all(
                v.device.type == ("cpu" if k in ("epoch", "slot") else dev.type)
                for k, v in st.items()):
            fail("resilience: the K-task state did not land on the card")
        shutil.rmtree(d)

    run_path(f"resilience: rcv1 K = {Y_rcv1.shape[0]} checkpoint",
             {"dcd_ell_shards": nb_r8, "dcd_ell_tasks": nb_r8},
             rcv1_k53_checkpoint, {"dcd_ell_shards": None})

    def kills():
        d = str(ckroot / "kill")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

        def child(mode, where=d):
            t0 = time.perf_counter()
            done = subprocess.run(
                [sys.executable, "-c", KILL_CHILD, str(ROOT / "src"), mode,
                 where], env=env, capture_output=True, text=True,
                timeout=300)
            print(f"    child {mode}: exit {done.returncode} in "
                  f"{time.perf_counter() - t0:.1f} s")
            return done

        k = child("kill")
        have = sorted(p.name for p in Path(d).iterdir())
        print(f"    checkpoints left by the killed child: {have}")
        if k.returncode != -9 or "UNREACHABLE" in k.stdout or have != [
                "ckpt_1"]:
            fail(f"resilience: the killed child exited {k.returncode} "
                 f"leaving {have}: {k.stderr[-2000:]}")
        # each resume from what the killed child left (a resume saves the
        # boundaries it runs)
        shutil.copytree(d, d + "_elastic")
        for mode in ("resume", "elastic"):
            c = child(mode, d if mode == "resume" else d + "_elastic")
            if c.returncode != 0:
                fail(f"resilience: the {mode} child failed: "
                     f"{c.stderr[-2000:]}")
            rep = json.loads(c.stdout.strip().splitlines()[-1])
            print(f"    {mode}: resumed from {rep['resumed_from']}, "
                  f"attempts {rep['attempts']}, gaps {rep['gaps']}, the "
                  f"uninterrupted run's {rep['full_gaps']}, α and ŵ "
                  f"bit-identical: {rep['bits']}")
            if rep["resumed_from"] != 1 or rep["attempts"] != [1, 1]:
                fail(f"resilience: the {mode} child did not resume from 1")
            if mode == "resume" and not rep["bits"]:
                fail("resilience: the resume after the kill is not the "
                     "uninterrupted run's bits")
            g, g_ref = rep["gaps"][-1], rep["full_gaps"][-1]
            if mode == "elastic" and not (math.isfinite(g)
                                          and g <= 2.0 * g_ref + 1e-3):
                fail(f"resilience: the elastic resume's gap {g} is past "
                     f"2 × {g_ref} + 1e-3")

    run_path("resilience: rcv1 pods (2, 4) killed and resumed", {}, kills)

    seg_mod._save_boundary, seg_mod._restore, seg_mod._health = (
        save, restore, health)
    shutil.rmtree(ckroot, ignore_errors=True)
    print(f"  resilience phase: {time.perf_counter() - t_phase:.1f} s")


SERVE_ROWS = 4096  # rcv1 rows scored against the host, and appended


def serve_phase(torch, dev, run_path, X_rcv1, X_web, ids_rcv1):
    """The serving engine (``repro_torch.serve``) at rcv1's full width:
    a snapshot booted from a checkpoint of the segmented solve, scores
    held to a float64 host dot product, the threaded engine's latency
    under a closed loop, an overload flood, hot-swaps under live traffic
    (and one publish at webspam's width), a drift-triggered warm-start
    re-solve against a solve from scratch, the watchdog's give-up and
    the transient retry, and the one-vs-rest model (K = 53).  Every
    re-solve is B1 over the shard grid (p = 8) or the task grid, counted
    through ``run_path``; the scoring is the engine's plain gather and
    sum, which launches no kernel of the port."""
    import shutil
    from collections import deque

    import numpy as np

    from repro_torch.core import duals
    from repro_torch.core.sharded import _n_blocks
    from repro_torch.data.sparse import EllMatrix, ell_append
    from repro_torch.dist.mesh import solver_mesh
    from repro_torch.resilience import FaultPlan, solve_segmented
    from repro_torch.serve import (
        IncrementalTrainer,
        RequestShed,
        ScoreOutcome,
        ServeEngine,
        SnapshotStore,
        load_snapshot,
        make_snapshot,
        snapshot_from_result,
    )
    from repro_torch.serve.engine import score_batch

    t_phase = time.perf_counter()
    hinge1 = duals.Hinge(1.0)
    n_r, k_r, d_r = X_rcv1.n_rows, X_rcv1.k_max, X_rcv1.n_features
    mesh8 = solver_mesh(n_devices=8)

    def nb8(n):
        return _n_blocks(-(-n // 8), B)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    pick = torch.randperm(n_r, generator=gen, device=dev)[:SERVE_ROWS]
    picked = EllMatrix(X_rcv1.indices[pick], X_rcv1.values[pick], d_r)

    def host_rows(X, rows=None):
        """[(cols, vals), ...] of X's rows on the host, padding dropped."""
        idx = (X.indices if rows is None else X.indices[rows]).cpu().numpy()
        val = (X.values if rows is None else X.values[rows]).cpu().numpy()
        keep = idx < X.n_features
        return [(i[m], v[m]) for i, v, m in zip(idx, val, keep)]

    def host_w(snap):
        return snap.w_pad.double().cpu().numpy()

    def held(outs, reqs, w_of):
        """Largest error of each outcome's score (and margins) against a
        float64 host dot product with the w of its version, failing past
        atol 1e-5 + 1e-6·Σ|w_j x_j|."""
        err = 0.0
        for o, (c, v) in zip(outs, reqs):
            w = w_of(o.version)
            w2 = w if w.ndim == 2 else w[None]
            prod = w2[:, c] * v.astype(np.float64)
            ref, mag = prod.sum(1), np.abs(prod).sum(1)
            got = np.asarray(o.margins if w.ndim == 2 else [o.score])
            e = np.abs(got - ref)
            if not bool((e <= 1e-5 + 1e-6 * mag).all()):
                fail(f"serve: a score differs from the host's by "
                     f"{float(e.max())} (version {o.version})")
            err = max(err, float(e.max()))
        return err

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    root = ROOT / "build" / "chip_smoke_serve"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    kw8 = dict(mesh=mesh8, block_size=B, seed=SEED)
    reqs = host_rows(picked)
    out = {}

    # ---- boot: the segmented solve's checkpoint → a snapshot ------------
    def boot():
        res, t = wall(lambda: solve_segmented(
            X_rcv1, hinge1, epochs=2, checkpoint_every=2,
            ckpt_dir=str(root / "boot"), device=dev, **kw8))
        snap, t_l = wall(lambda: load_snapshot(str(root / "boot"), 1,
                                               device=dev))
        same = (torch.equal(snap.w_pad[:d_r], res.result.w_hat)
                and torch.equal(snap.alpha, res.result.alpha))
        print(f"  boot: rcv1 p = 8, 2 epochs segmented in {t:.3f} s, gaps "
              f"{res.result.gaps.tolist()}; load_snapshot in {t_l:.4f} s "
              f"(step {snap.meta['ckpt_step']}, w_pad "
              f"{tuple(snap.w_pad.shape)} on {snap.w_pad.device}); "
              f"w_pad[:d] and α equal the solve's: {same}")
        if not same or snap.meta != {"ckpt_step": 2}:
            fail("serve: the booted snapshot is not the solve's ŵ and α")
        out["snap"] = snap

    run_path("serve: boot from a checkpoint", {"dcd_ell_shards": 2 * nb8(n_r)},
             boot)
    snap = out["snap"]
    w_boot = host_w(snap)

    # ---- scoring against the host ---------------------------------------
    def scoring():
        # a queue deep enough that the ladder stays at full batches
        eng = ServeEngine(SnapshotStore(snap), k_max=k_r, max_batch=64,
                          queue_depth=4 * SERVE_ROWS,
                          default_deadline_s=60.0, device=dev)
        tickets = [eng.submit(cols=c, vals=v) for c, v in reqs]
        while len(eng.queue):
            eng.step()
        outs = [t.result(1.0) for t in tickets]
        if not all(isinstance(o, ScoreOutcome) for o in outs):
            fail("serve: a scoring request was shed")
        err = held(outs, reqs, lambda v: w_boot)
        print(f"  scoring: {len(outs)} rcv1 rows through submit and step "
              f"({eng.health()['batches']} batches), largest error against "
              f"the float64 host dot {err:.3g} (tolerance 1e-5 + "
              "1e-6·Σ|w_j x_j|)")

    run_path("serve: scoring against the host", {}, scoring)

    # ---- latency under a closed loop ------------------------------------
    def closed_loop(eng, rows, n_req, window, publish=None):
        inflight, tickets = deque(), []
        for i in range(n_req):
            if len(inflight) >= window:
                inflight.popleft().result(60.0)
            if publish is not None:
                publish(i)
            c, v = rows[i % len(rows)]
            t = eng.submit(cols=c, vals=v)
            inflight.append(t)
            tickets.append((t, (c, v)))
        for t in inflight:
            t.result(60.0)
        return tickets

    def latency():
        eng = ServeEngine(SnapshotStore(snap), k_max=k_r, max_batch=64,
                          queue_depth=512, default_deadline_s=60.0,
                          device=dev).start()
        try:
            _, t = wall(lambda: closed_loop(eng, reqs, 20_000, 192))
        finally:
            eng.stop()
        h = eng.health()
        print(f"  latency, closed loop of 192 in flight, 20,000 rcv1 "
              f"requests, max_batch 64, queue_depth 512: p50 "
              f"{h['p50_ms']:.4f} ms, p99 {h['p99_ms']:.4f} ms, "
              f"{h['served'] / t:.1f} requests/s over the loop "
              f"({h['qps']:.1f} by the engine's own clock), "
              f"{h['batches']} batches, rung steps {h['rung_steps']}, "
              f"shed {h['shed']}")
        if h["served"] != 20_000 or h["shed_total"]:
            fail("serve: the closed loop lost or shed a request")
        # one dispatch on the device (staging copy, gather and sum,
        # margins back to a pinned buffer), behind the spin
        eng = ServeEngine(SnapshotStore(snap), k_max=k_r, max_batch=64,
                          queue_depth=512, default_deadline_s=60.0,
                          device=dev)
        eng._cols[:], eng._vals[:] = d_r, 0.0
        for i, (c, v) in enumerate(reqs[:64]):
            eng._cols[i, :len(c)], eng._vals[i, :len(c)] = c, v
        back = torch.empty((1, 64), pin_memory=True)
        on_dev = eng._stage.to(dev)

        def dispatch():
            st = eng._stage.to(dev, non_blocking=True)
            m = score_batch(snap.w_pad, st[0], st[1].view(torch.float32))
            back.copy_(m, non_blocking=True)

        ms = cuda_ms(dispatch, 200, torch)
        ms_gather = cuda_ms(lambda: score_batch(
            snap.w_pad, on_dev[0], on_dev[1].view(torch.float32)), 200,
            torch)
        steps = []
        for _ in range(50):
            for c, v in reqs[:64]:
                eng.submit(cols=c, vals=v)
            t0 = time.perf_counter()
            eng.step()
            steps.append((time.perf_counter() - t0) * 1e3)
        print(f"  one scoring dispatch (64 × {k_r}): {ms:.4f} ms of device "
              f"time (copy in, gather and sum, margins out; the gather and "
              f"sum alone {ms_gather:.4f} ms); one step() {np.mean(steps):.4f} "
              f"ms wall (median {np.median(steps):.4f})")

    run_path("serve: latency under load", {}, latency)

    # ---- an overload flood ----------------------------------------------
    def flood():
        eng = ServeEngine(SnapshotStore(snap), k_max=k_r, max_batch=64,
                          queue_depth=32, default_deadline_s=0.010,
                          batch_wait_s=0.001, device=dev).start()
        tickets = []
        try:
            for i in range(3000):
                c, v = reqs[i % len(reqs)]
                tickets.append(eng.submit(cols=c, vals=v))
                if len(eng.queue) > 32:
                    fail("serve: the queue grew past its bound")
        finally:
            eng.stop()
        outs = [t.result(5.0) for t in tickets]
        served = sum(isinstance(o, ScoreOutcome) for o in outs)
        shed = [o for o in outs if isinstance(o, RequestShed)]
        h = eng.health()
        reasons = {r: sum(o.reason == r for o in shed)
                   for r in ("deadline", "backpressure", "shutdown",
                             "invalid")}
        print(f"  flood: 3,000 requests at queue_depth 32, 10 ms deadline: "
              f"served {served}, shed {len(shed)} {reasons}, every ticket "
              f"terminal: {all(t.done() for t in tickets)}; rung steps "
              f"{h['rung_steps']}")
        if (served + len(shed) != 3000 or not all(t.done() for t in tickets)
                or served != h["served"] or len(shed) != h["shed_total"]
                or not shed):
            fail("serve: the flood lost a request or miscounted")

    run_path("serve: overload flood", {}, flood)

    # ---- hot-swap under live traffic ------------------------------------
    def hot_swap():
        base = snap.w_pad[:d_r]
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 4)
        store = SnapshotStore(snap)
        eng = ServeEngine(store, k_max=k_r, max_batch=64, queue_depth=512,
                          default_deadline_s=60.0, device=dev)
        batches = []
        take = eng.queue.take

        def recording_take(*a, **k):
            live, expired = take(*a, **k)
            if live:
                batches.append([r.rid for r in live])
            return live, expired

        eng.queue.take = recording_take
        ws, builds = {1: w_boot}, []

        def publish(i):
            if i and i % 1000 == 0 and len(ws) <= 10:
                v = len(ws) + 1
                w = base + 1e-3 * torch.randn(d_r, generator=g, device=dev)
                s, t_b = wall(lambda: make_snapshot(w, v, device=dev))
                builds.append(t_b)
                ws[v] = host_w(s)
                eng.publish(s)

        eng.start()
        try:
            tickets = closed_loop(eng, reqs, 11_000, 192, publish)
        finally:
            eng.stop()
        outs = [t.result(1.0) for t, _ in tickets]
        by_rid = {o.rid: o for o in outs if isinstance(o, ScoreOutcome)}
        mixed = sum(len({by_rid[r].version for r in b}) != 1
                    for b in batches)
        h = eng.health()
        versions = sorted({o.version for o in by_rid.values()})
        print(f"  hot-swap: {h['swaps']} publishes during 11,000 requests: "
              f"served {len(by_rid)}, versions seen {versions}, batches "
              f"{len(batches)} (version-mixed {mixed}); pause largest "
              f"{h['swap_pause_max_s'] * 1e3:.4f} ms, mean "
              f"{h['swap_pause_mean_s'] * 1e3:.4f} ms; a snapshot's build "
              f"{np.mean(builds) * 1e3:.4f} ms")
        if len(by_rid) != len(outs) or h["swaps"] != 10:
            fail("serve: a request was dropped across the hot-swaps")
        if not set(versions) <= set(ws) or mixed:
            fail("serve: an outcome's version was never published, or a "
                 "batch mixed versions")
        err = held(outs, [r for _, r in tickets], ws.__getitem__)
        print(f"    every score against its version's w on the host: "
              f"largest error {err:.3g}")

    run_path("serve: hot-swap under traffic", {}, hot_swap)

    # ---- one publish at webspam's width ---------------------------------
    def webspam_swap():
        d_w, k_w = X_web.n_features, X_web.k_max
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 5)
        rows = torch.randperm(X_web.n_rows, generator=g, device=dev)[:256]
        wreq = host_rows(X_web, rows)
        zero = make_snapshot(torch.zeros(d_w, device=dev), 1, device=dev)
        eng = ServeEngine(SnapshotStore(zero), k_max=k_w, max_batch=64,
                          queue_depth=512, default_deadline_s=60.0,
                          device=dev).start()
        w = torch.randn(d_w, generator=g, device=dev)
        new, t_b = wall(lambda: make_snapshot(w, 2, device=dev))
        pause = []

        def publish(i):
            if i == 128:
                pause.append(eng.publish(new))

        try:
            tickets = closed_loop(eng, wreq, 256, 64, publish)
        finally:
            eng.stop()
        pause = pause[0]
        outs = [t.result(5.0) for t, _ in tickets]
        if not all(isinstance(o, ScoreOutcome) for o in outs):
            fail("serve: a webspam-width request was dropped")
        ws = {1: host_w(zero), 2: host_w(new)}
        err = held(outs, [r for _, r in tickets], ws.__getitem__)
        print(f"  webspam width (d = {d_w}): the snapshot built in "
              f"{t_b * 1e3:.4f} ms, its publish paused {pause * 1e3:.4f} "
              f"ms under traffic; 256 rows of {k_w} nonzeros scored, "
              f"versions {sorted({o.version for o in outs})}, largest "
              f"error against the host {err:.3g}")

    run_path("serve: webspam-width publish", {}, webspam_swap)

    # ---- drift and the warm start ---------------------------------------
    n_app = n_r + SERVE_ROWS

    def drift():
        tr = IncrementalTrainer(X_rcv1, hinge1, epochs=2, device=dev,
                                solver_kwargs=dict(kw8))
        res0, t_fit = wall(tr.fit)
        store = SnapshotStore(snapshot_from_result(res0, 1))
        eng = ServeEngine(store, k_max=k_r, trainer=tr, device=dev)
        eng.ingest(picked, -torch.ones(SERVE_ROWS, device=dev))
        base0 = tr.err_base
        err_new = tr.error_on(tr._pending_matrix(), tr.w)
        app, t_app = wall(lambda: ell_append(tr.X, tr._pending_matrix()))
        del app
        res, t_re = wall(eng.train_if_drifted)
        if res is None or store.version != 2:
            fail("serve: the flipped rows did not trip the drift re-solve")
        if tr.X.n_rows != n_app or tr.alpha.shape != (n_app,):
            fail(f"serve: the re-solve ran over {tr.X.n_rows} rows")
        scratch, t_s = wall(lambda: solve_segmented(
            tr.X, hinge1, epochs=2, device=dev, **kw8))
        g_w = float(res.result.gaps[-1])
        g_s = float(scratch.result.gaps[-1])
        print(f"  drift: fit rcv1 p = 8, 2 epochs ({t_fit / 2:.4f} s per "
              f"epoch), its error {base0:.4f} on its rows and {err_new:.4f} "
              f"on the {SERVE_ROWS} rows ingested with flipped labels "
              f"({tr.err_base:.4f} after the re-solve), ledger "
              f"{tr.ledger}; the append to {n_app} rows {t_app * 1e3:.4f} ms "
              f"alone; the warm re-solve and publish {t_re:.3f} s "
              f"({t_re / 2:.4f} s per epoch, the drift check and append "
              f"included); from scratch {t_s / 2:.4f} s per epoch")
        print(f"    gaps: warm {res.result.gaps.tolist()}, scratch "
              f"{scratch.result.gaps.tolist()} (warm / scratch at 2 epochs "
              f"{g_w / g_s:.4f})")
        if tr.ledger["drift_trips"] != 1 or not g_w < g_s:
            fail("serve: the warm gap is not below the scratch gap")

    run_path("serve: drift and warm start",
             {"dcd_ell_shards": 2 * nb8(n_r) + 4 * nb8(n_app)}, drift)

    # ---- the watchdog gives up; a transient fault recovers --------------
    n_w = PASSCODE_ROWS
    X_w = EllMatrix(X_rcv1.indices[:n_w], X_rcv1.values[:n_w], d_r)
    extra = EllMatrix(X_rcv1.indices[n_w:n_w + 512],
                      X_rcv1.values[n_w:n_w + 512], d_r)

    def watchdog():
        tr = IncrementalTrainer(
            X_w, hinge1, epochs=2, retries=1, backoff_s=0.001, device=dev,
            solver_kwargs=dict(kw8, max_retries=0))
        store = SnapshotStore(snapshot_from_result(tr.fit(), 1))
        eng = ServeEngine(store, k_max=k_r, trainer=tr, device=dev)
        eng.ingest(extra, torch.ones(512, device=dev))
        X0, a0, w0 = tr.X, tr.alpha.clone(), tr.w.clone()
        tr.fault_plan = FaultPlan(nan_psum_epoch=1, persistent=True)
        gave_up = eng.train_if_drifted(force=True)
        want = {"solves": 1, "diverged": 2, "retries": 1, "gave_up": 1,
                "drift_trips": 0}
        kept = (tr.X is X0 and torch.equal(tr.alpha, a0)
                and torch.equal(tr.w, w0) and tr.pending_rows == 512)
        print(f"  watchdog: a persistent NaN at epoch 1 on {n_w} rows + 512 "
              f"pending: resolve gave {gave_up}, version {store.version}, "
              f"X, α and w kept: {kept}, ledger {tr.ledger}")
        if gave_up is not None or store.version != 1 or not kept or \
                tr.ledger != want:
            fail("serve: the tripped re-solve published or moved state")
        t2 = IncrementalTrainer(
            X_w, hinge1, epochs=2, retries=2, backoff_s=0.001, device=dev,
            fault_plan=FaultPlan(nan_psum_epoch=1),
            solver_kwargs=dict(kw8, max_retries=0))
        res = t2.fit()
        print(f"    a transient NaN: fit {'recovered' if res else 'failed'}"
              f", ledger {t2.ledger}")
        if res is None or t2.ledger != {"solves": 1, "diverged": 1,
                                        "retries": 1, "gave_up": 0,
                                        "drift_trips": 0}:
            fail("serve: the transient fault did not recover in one retry")

    run_path("serve: watchdog give-up and transient retry",
             {"dcd_ell_shards": 2 * nb8(n_w) + 4 * nb8(n_w + 512)
              + 4 * nb8(n_w)}, watchdog)

    # ---- one-vs-rest, K = 53 --------------------------------------------
    K = int(ids_rcv1.max()) + 1

    def one_vs_rest():
        torch.cuda.reset_peak_memory_stats()
        tr = IncrementalTrainer(X_rcv1, hinge1, n_classes=K, y0=ids_rcv1,
                                epochs=1, device=dev,
                                solver_kwargs=dict(kw8))
        res, t_fit = wall(tr.fit)
        store = SnapshotStore(snapshot_from_result(res, 1))
        eng = ServeEngine(store, k_max=k_r, max_batch=1024,
                          queue_depth=4096, default_deadline_s=60.0,
                          device=dev)

        batch = [reqs[i % len(reqs)] for i in range(1024)]

        def score(version):
            tickets = [eng.submit(cols=c, vals=v) for c, v in batch]
            if eng.step() != 1024:
                fail("serve: 1,024 rows did not go in one dispatch")
            outs = [t.result(1.0) for t in tickets]
            w = host_w(store.current())
            bad = sum(o.label != int(np.argmax(o.margins))
                      or o.version != version for o in outs)
            if bad:
                fail(f"serve: {bad} K-class outcomes with a wrong label "
                     "or version")
            return held(outs, batch, lambda v: w)

        e1 = score(1)
        tr.add_labeled(picked, ids_rcv1[pick])
        res2, t_re = wall(tr.resolve)
        if res2 is None or tuple(tr.alpha.shape) != (K, n_app):
            fail(f"serve: the K-class re-solve gave α "
                 f"{tuple(tr.alpha.shape)}")
        eng.publish(snapshot_from_result(res2, 2))
        e2 = score(2)
        print(f"  one-vs-rest K = {K}: fit 1 epoch {t_fit:.3f} s, the "
              f"{SERVE_ROWS}-row append and re-solve {t_re:.3f} s (α "
              f"{tuple(tr.alpha.shape)}), gaps min/max "
              f"{float(res2.result.gaps[:, -1].min()):.4g} / "
              f"{float(res2.result.gaps[:, -1].max()):.4g}; 1,024 rows in "
              f"one dispatch against the ({K}, {d_r + 1}) stack, labels the "
              f"argmax, largest margin error {max(e1, e2):.3g}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    run_path(f"serve: one-vs-rest K = {K}",
             {"dcd_ell_shards": nb8(n_r) + nb8(n_app),
              "dcd_ell_tasks": nb8(n_r) + nb8(n_app)}, one_vs_rest,
             {"dcd_ell_shards": None})

    shutil.rmtree(root, ignore_errors=True)
    print(f"  serve phase: {time.perf_counter() - t_phase:.1f} s")


# phase 7: each arch at its full published width in float32, at full
# depth where one card holds it; these three cut in depth (the layers
# run), jamba on its smoke config (one full-width period does not fit)
LM_DEPTH = {"qwen2-vl-72b": 8, "deepseek-coder-33b": 8,
            "phi3.5-moe-42b-a6.6b": 4}
LM_SMOKE = ("jamba-1.5-large-398b",)
LM_B, LM_S = 2, 64
LM_RTOL = LM_ATOL = 2e-3  # the reference's prefill/decode smoke check
PROBE_ARCH = "mistral-nemo-12b"


def lm_phase(torch, dev):
    """Phase 7, in a child process (``chip_smoke.py --lm-phase``): the LM
    stack's three smoke steps for every arch, then the linear probe at
    full width.  Prints a line per arch and, last, one JSON line of the
    probe's kernel launches."""
    import dataclasses

    from repro_torch.configs import ARCHS, get_config, get_smoke_config
    from repro_torch.kernels import dcd_block
    from repro_torch.models import (
        decode_step,
        forward_train,
        init_cache,
        init_params,
        lm_features,
        prefill,
    )
    from repro_torch.models.transformer import cache_max_len, vocab_padded
    sys.path.insert(0, str(ROOT / "examples"))
    from linear_probe_lm_torch import linear_probe

    def events_ms(fn, reps=2):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def err(a, b):
        """max |a − b| − rtol·|b|: ≤ atol passes."""
        return float(((a - b).abs() - LM_RTOL * b.abs()).max())

    card = card_line()
    launches = {}
    for arch in ARCHS:
        cfg, full = get_config(arch), get_config(arch)
        if arch in LM_SMOKE:
            cfg = get_smoke_config(arch)
            period = dataclasses.replace(full, n_layers=full.attn_period)
            embed = full.vocab_size * full.d_model * (
                1 if full.tie_embeddings else 2)
            print(f"  {arch}: its smoke config ({cfg.n_layers} layers, "
                  f"d_model {cfg.d_model}): one full-width period of "
                  f"{full.attn_period} layers is "
                  f"{(period.n_params() - embed) * 4 / 1e9:.0f} GB of "
                  "float32 weights, past the card's 80 GB")
        elif arch in LM_DEPTH:
            cfg = dataclasses.replace(full, n_layers=LM_DEPTH[arch])
            print(f"  {arch}: depth cut from {full.n_layers} to "
                  f"{cfg.n_layers} layers at full width (the full depth, "
                  f"{full.n_params() * 4 / 1e9:.0f} GB of float32 "
                  "weights, does not fit the card)")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(cfg, gen, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_par = sum(t.numel() for t in _leaves(params))
        # the batch: S + 1 positions, the prompt its first S
        S = LM_S
        full_b = {}
        if cfg.embeds_in and cfg.family != "encdec":
            full_b["embeds"] = torch.randn((LM_B, S + 1, cfg.d_model),
                                           generator=gen, device=dev) * 0.1
        else:
            full_b["tokens"] = torch.randint(0, cfg.vocab_size,
                                             (LM_B, S + 1), generator=gen,
                                             device=dev)
        if cfg.mrope_sections:
            full_b["positions"] = torch.arange(S + 1, device=dev)[
                None, None].expand(3, LM_B, S + 1)
        if cfg.family == "encdec":
            full_b["enc_embeds"] = torch.randn(
                (LM_B, cfg.enc_len, cfg.d_model), generator=gen,
                device=dev) * 0.1
        pre = {k: (v[..., :S] if k == "positions" else
                   v[:, :S] if k in ("tokens", "embeds") else v)
               for k, v in full_b.items()}
        step = {k: v[:, S:S + 1] for k, v in full_b.items()
                if k in ("tokens", "embeds")}
        if cfg.mrope_sections:
            step["positions"] = torch.full((3, LM_B, 1), S, device=dev)
        with torch.inference_mode():
            logits, aux = forward_train(cfg, params, full_b)
            if (logits.shape != (LM_B, S + 1, vocab_padded(cfg))
                    or not bool(torch.isfinite(logits).all())
                    or not math.isfinite(float(aux))):
                fail(f"{arch}: forward_train gave non-finite logits or "
                     "the wrong shape")
            fwd_ms = events_ms(lambda: forward_train(cfg, params, full_b))
            ref = (forward_train(cfg, params, full_b, moe_no_drop=True)[0]
                   if cfg.n_experts else logits)
            cache = init_cache(cfg, LM_B, cache_max_len(S),
                               dtype=torch.float32, device=dev)
            pl, cache = prefill(cfg, params, pre, cache)
            e_pre = err(pl[:, 0], ref[:, S - 1])
            dl, _ = decode_step(cfg, params, step, cache)
            e_dec = err(dl[:, 0], ref[:, S])
            pre_ms = events_ms(lambda: prefill(cfg, params, pre, cache))
            dec_ms = events_ms(lambda: decode_step(cfg, params, step, cache))
            feat_note = "lm_features: "
            if cfg.family == "encdec":
                feat_note += "none (encdec, as the reference)"
            elif cfg.mrope_sections:
                feat_note += ("none (M-RoPE needs (3, B, S) positions, "
                              "which lm_features does not take; ROADMAP "
                              "C.14)")
            else:
                f = lm_features(cfg, params, full_b["tokens"][:, :S])
                if f.shape != (LM_B, cfg.d_model) or not bool(
                        torch.isfinite(f).all()):
                    fail(f"{arch}: lm_features non-finite or misshapen")
                feat_note += f"{tuple(f.shape)} finite"
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  {arch}: {cfg.n_layers} of {full.n_layers} layers, "
              f"d_model {cfg.d_model}, {n_par / 1e9:.3f}B parameters "
              f"(float32); init {init_s:.2f} s; forward {fwd_ms:.2f} ms, "
              f"prefill {pre_ms:.2f} ms, decode {dec_ms:.2f} ms (B = "
              f"{LM_B}, S = {S}; CUDA events); peak {peak:.2f} GiB; "
              f"prefill/decode vs forward: {e_pre:.3g}, {e_dec:.3g} (≤ "
              f"{LM_ATOL} at rtol {LM_RTOL}); {feat_note}; {card}")
        if not (e_pre <= LM_ATOL and e_dec <= LM_ATOL):
            fail(f"{arch}: prefill → decode disagrees with forward_train")
        if arch == PROBE_ARCH:
            # the linear probe on this full-width model's features, its
            # solves' kernel launches counted (the plain versions, none)
            sh, ep = dcd_block.dcd_indexed_shards, dcd_block.dcd_indexed_epoch
            for f in (sh, ep):
                f.launches = f.task_launches = 0
                for v in f.variant_launches:
                    f.variant_launches[v] = 0
            t0 = time.perf_counter()
            r = linear_probe(cfg, params, device=dev)
            print(f"  linear probe on {arch} (full width, {cfg.n_layers} "
                  f"layers), n = 256 sequences, X = 256 × {r['d']}: "
                  f"multi-task PASSCoDe top-1 {r['acc']:.4f}, loop-over-K "
                  f"dcd_solve top-1 {r['acc_ref']:.4f}, max |ΔW| "
                  f"{r['head_gap']:.3g}, majority share {r['majority']:.4f}"
                  f" ({time.perf_counter() - t0:.1f} s)")
            if not (r["acc"] > r["majority"] and r["acc_ref"]
                    > r["majority"]):
                fail("the full-width probe does not beat the majority")
            launches = {"dcd_indexed_tasks": sh.task_launches,
                        "dcd_indexed_shards_wide":
                            sh.variant_launches["wide"],
                        "dcd_indexed_epoch": ep.variant_launches["wide"]}
            print(f"  probe launches: {launches}")
            if not (launches["dcd_indexed_tasks"] and
                    launches["dcd_indexed_epoch"]):
                fail("the probe's solves launched no B2 kernel")
        del params, cache, logits, ref
        torch.cuda.empty_cache()
    smoke = get_smoke_config(PROBE_ARCH)
    r = linear_probe(smoke, init_params(
        smoke, torch.Generator(device=dev).manual_seed(SEED), device=dev),
        device=dev)
    print(f"  linear probe on the smoke {PROBE_ARCH}: top-1 {r['acc']:.4f}"
          f" (loop over K {r['acc_ref']:.4f}, majority {r['majority']:.4f};"
          " the reference example's floor of 0.7: ROADMAP C.15)")
    if not r["acc"] > r["majority"]:
        fail("the smoke probe does not beat the majority")
    print(json.dumps({"lm_probe_launches": launches}))


# phase 8: LM training and serving.  (a) train steps at full published
# width and depth in float32 with remat on; (b) the example's LM_100M
# through the fault-tolerant loop with one injected fault; (c) both
# launchers on the smoke configs
TRAIN_ARCHS = ("minicpm-2b", "mamba2-780m", "granite-moe-3b-a800m")
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 64, 4
TRAIN_LOSS_RTOL = 1e-5  # step 0's loss against the inference forward's CE
TRAIN_NOREMAT_RTOL = 1e-4  # remat off against on: loss and grad_norm
LOOP_STEPS, LOOP_B, LOOP_S, LOOP_CKPT_EVERY, LOOP_FAULT_AT = 60, 8, 256, 20, 30


def lm_train_phase(torch, dev):
    """Phase 8, in a child process (``chip_smoke.py --lm-train-phase``).
    Prints a line a check and, last, one JSON line of the numbers."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.configs.registry import get_schedule
    from repro_torch.data.lm_data import MarkovCorpus, make_lm_batch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import forward_train, init_params
    from repro_torch.optim import adamw_update, make_schedule
    from repro_torch.train import (
        cross_entropy,
        make_train_step,
        restore_checkpoint,
        save_checkpoint,
        train_state_for,
    )
    from repro_torch.tree import leaves, tree_map
    sys.path.insert(0, str(ROOT / "examples"))
    from train_lm_torch import LM_100M, train

    card = card_line()
    out = {"archs": {}}

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    def live_bytes(tree):
        return sum(t.numel() * t.element_size() for t in leaves(tree)
                   if isinstance(t, torch.Tensor))

    # ---- (a) full-width train steps
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        def fresh():
            """Step 0's state: the parameters from SEED, zero moments."""
            return train_state_for(init_params(
                cfg, torch.Generator(device=dev).manual_seed(SEED),
                device=dev))

        state = fresh()
        params = state.params
        n_par = sum(t.numel() for t in leaves(params))
        state_bytes = live_bytes(state)
        sched = make_schedule(get_schedule(arch), peak_lr=1e-4,
                              total_steps=100, warmup_steps=2)
        corpus = MarkovCorpus(cfg.vocab_size, seed=SEED, device=dev)
        batches = [make_lm_batch(corpus, t, TRAIN_B, TRAIN_S)
                   for t in range(TRAIN_STEPS)]
        batch_bytes = live_bytes(batches[0])
        with torch.inference_mode():
            logits, _ = forward_train(cfg, params, batches[0])
            ce_ref = float(cross_entropy(logits, batches[0]["labels"],
                                         cfg.vocab_size))
            del logits
        step = make_train_step(cfg, schedule=sched, remat=True)
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
        metrics = []
        ev[0].record()
        for t in range(TRAIN_STEPS):
            state, m = step(state, batches[t])
            ev[t + 1].record()
            metrics.append(m)
        torch.cuda.synchronize()
        step_ms = [ev[t].elapsed_time(ev[t + 1]) for t in range(TRAIN_STEPS)]
        losses = [float(m["loss"]) for m in metrics]
        gnorms = [float(m["grad_norm"]) for m in metrics]
        if not all(math.isfinite(v) for v in losses + gnorms):
            fail(f"{arch}: a train step's loss or grad_norm is not finite")
        if rel(losses[0], ce_ref) > TRAIN_LOSS_RTOL:
            fail(f"{arch}: step 0's loss {losses[0]} against the forward's "
                 f"cross-entropy {ce_ref}")
        # the optimizer alone on the same state: one more AdamW update
        grads = tree_map(torch.zeros_like, state.params)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        adamw_update(state.params, grads, state.opt, lr=1e-4)
        e1.record()
        torch.cuda.synchronize()
        opt_ms = e0.elapsed_time(e1)
        del grads
        peak = torch.cuda.max_memory_allocated() / 2**30
        # remat off from the same parameters (drawn again from SEED) and a
        # fresh optimizer
        del state, params
        torch.cuda.empty_cache()
        state, m_off = make_train_step(cfg, schedule=sched, remat=False)(
            fresh(), batches[0])
        e_loss = rel(float(m_off["loss"]), losses[0])
        e_gn = rel(float(m_off["grad_norm"]), gnorms[0])
        ms = sum(step_ms[1:]) / (TRAIN_STEPS - 1)
        print(f"  {arch}: {cfg.n_layers} of {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {n_par / 1e9:.3f}B parameters (float32, "
              f"remat on, B = {TRAIN_B}, S = {TRAIN_S}, {get_schedule(arch)}"
              f" schedule): step 0 {step_ms[0]:.1f} ms, then "
              f"{ms:.1f} ms a step (CUDA events, steps 1–"
              f"{TRAIN_STEPS - 1}); AdamW alone {opt_ms:.1f} ms "
              f"({opt_ms / ms:.3f} of a step); peak {peak:.2f} GiB; losses "
              f"{[round(v, 4) for v in losses]}, grad_norm "
              f"{[round(v, 4) for v in gnorms]}; step 0 vs the forward's CE "
              f"{rel(losses[0], ce_ref):.2e} (≤ {TRAIN_LOSS_RTOL}); remat "
              f"off: loss {e_loss:.2e}, grad_norm {e_gn:.2e} (≤ "
              f"{TRAIN_NOREMAT_RTOL}); {card}")
        if e_loss > TRAIN_NOREMAT_RTOL or e_gn > TRAIN_NOREMAT_RTOL:
            fail(f"{arch}: the step without remat parts from the step "
                 "with it")
        out["archs"][arch] = {"params": n_par, "step_ms": step_ms,
                              "opt_ms": opt_ms, "peak_gib": peak,
                              "losses": losses, "grad_norms": gnorms,
                              "dryrun": train_bound(
                                  arch, cfg, step_ms, peak,
                                  state_bytes + batch_bytes, card)}
        del state, m, m_off, metrics, batches
        torch.cuda.empty_cache()
        if torch.cuda.memory_allocated() > 2**30:
            fail(f"{arch}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                 "still allocated after its train steps")

    # ---- (b) the LM_100M loop with one injected fault
    ckpt = ROOT / "build" / "chip_smoke_lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    fired = []

    def fault_hook(t):
        if t == LOOP_FAULT_AT and not fired:
            fired.append(t)
            raise RuntimeError(f"injected fault at step {t}")

    step_dt = {}
    t0 = time.perf_counter()
    state, report, first, last = train(
        LM_100M, steps=LOOP_STEPS, batch=LOOP_B, seq=LOOP_S, lr=3e-3,
        ckpt_dir=str(ckpt), device=dev, ckpt_every=LOOP_CKPT_EVERY,
        step_deadline_s=1e-9, fault_hook=fault_hook,
        on_straggler=lambda t, dt: step_dt.setdefault(t, []).append(dt),
        log=lambda msg: print(f"    {msg}"))
    loop_s = time.perf_counter() - t0
    dts = sorted(d for v in step_dt.values() for d in v)
    restarts = [r for r in report.restarts if r[0] == "failure"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_checkpoint(str(ckpt), 10_000, state)
    save_s = time.perf_counter() - t0
    ck_bytes = os.path.getsize(os.path.join(path, "arrays.npz"))
    t0 = time.perf_counter()
    back, back_step = restore_checkpoint(str(ckpt), LOOP_STEPS, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(leaves(state), leaves(back)))
    print(f"  LM_100M loop ({LM_100M.n_params() / 1e6:.1f}M parameters, "
          f"B = {LOOP_B}, S = {LOOP_S}, WSD, a checkpoint every "
          f"{LOOP_CKPT_EVERY} steps, a fault at step {LOOP_FAULT_AT}): "
          f"{report.final_step} steps, {report.n_failures} failure, "
          f"restarts {report.restarts}; loss {first:.4f} → {last:.4f}; "
          f"{len(dts)} steps timed, median {dts[len(dts) // 2] * 1e3:.1f} "
          f"ms, mean {sum(dts) / len(dts) * 1e3:.1f} ms a step (host clock,"
          f" one loss read a step); the whole loop {loop_s:.1f} s; a "
          f"checkpoint of {ck_bytes / 1e9:.3f} GB saved in {save_s:.3f} s, "
          f"restored in {restore_s:.3f} s; the final checkpoint (step "
          f"{back_step}) read back {'bit-equal' if same else 'DIFFERENT'};"
          f" {card}")
    if report.n_failures != 1 or len(restarts) != 1:
        fail(f"the loop reported {report.n_failures} failures and "
             f"{restarts} restarts, not one")
    if not last < first:
        fail(f"the LM_100M loss did not fall: {first} → {last}")
    if not same or back_step != LOOP_STEPS:
        fail("the final checkpoint does not read back the final state")
    out["loop"] = {"steps": report.final_step, "failures": report.n_failures,
                   "first": first, "last": last,
                   "step_ms_median": dts[len(dts) // 2] * 1e3,
                   "step_ms_mean": sum(dts) / len(dts) * 1e3,
                   "loop_s": loop_s, "ckpt_gb": ck_bytes / 1e9,
                   "save_s": save_s, "restore_s": restore_s}
    del state, back
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- (c) the launchers on the card, smoke configs
    lckpt = ROOT / "build" / "chip_smoke_launch_ckpt"
    shutil.rmtree(lckpt, ignore_errors=True)
    t0 = time.perf_counter()
    rep = launch_train.main(["--arch", "minitron-4b", "--steps", "8",
                             "--batch", "2", "--seq", "32", "--ckpt-dir",
                             str(lckpt)])
    print(f"  launch.train minitron-4b (smoke): {rep.final_step} steps, "
          f"losses {[round(v, 4) for v in rep.losses]} "
          f"({time.perf_counter() - t0:.1f} s)")
    if rep.final_step != 8 or not all(math.isfinite(v) for v in rep.losses):
        fail("the train launcher did not run 8 finite steps")
    shutil.rmtree(lckpt, ignore_errors=True)
    out["launch"] = {}
    for arch, S, gen in (("mistral-nemo-12b", 16, 6),
                         ("jamba-1.5-large-398b", 16, 4)):
        from repro_torch.configs import get_smoke_config
        t0 = time.perf_counter()
        r = launch_serve.main(["--arch", arch, "--requests", "2",
                               "--prompt-len", str(S), "--gen", str(gen)])
        V = get_smoke_config(arch).vocab_size
        toks = r["tokens"]
        ok = (toks.shape == (2, gen) and int(toks.min()) >= 0
              and int(toks.max()) < V and r["cache_length"] == S + gen - 1)
        print(f"  launch.serve {arch} (smoke): tokens {toks.tolist()}, "
              f"cache length {r['cache_length']} (S + {gen - 1} decode "
              f"steps), {'in the vocabulary' if ok else 'WRONG'} "
              f"({time.perf_counter() - t0:.1f} s)")
        if not ok:
            fail(f"the serve launcher on {arch} gave {toks} and a cache "
                 f"of {r['cache_length']}")
        out["launch"][arch] = toks.tolist()
    print(json.dumps({"lm_train": out}))


def train_bound(arch, cfg, step_ms, peak_gib, card_bytes, card):
    """Phase 8's counted bound on one arch's train step: the port's
    dry-run cell on a 1 × 1 mesh (``repro_torch.launch.dryrun.run_cell``:
    the step run on meta tensors under the per-device counter, no byte
    allocated) at phase 8's shape and float32 state, beside the measured
    steps.  Fails the phase when the cell's arguments are not, to the
    byte, the state and batch the card holds, when a measured step beats
    the counted bound, or when a figure is not finite and nonzero."""
    import torch

    from repro_torch.configs.shapes import InputShape
    from repro_torch.dist.mesh import SolverMesh
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.roofline import peak_flops_for

    t0 = time.perf_counter()
    # one device: the cell runs the plain path on meta tensors, no
    # process group or DTensor needed
    mesh = SolverMesh(("data", "model"), (1, 1))
    dtypes = dict(dtype=torch.float32, m_dtype=torch.float32,
                  v_dtype=torch.float32, master=False)  # phase 8's state
    cell = run_cell(arch, "phase8_train", cfg=cfg, mesh=mesh,
                    shape=InputShape("phase8_train", TRAIN_S, TRAIN_B,
                                     "train"),
                    microbatches=1, dtypes=dtypes)
    dry_s = time.perf_counter() - t0
    rf, mem = cell["roofline"], cell["memory"]
    peak = peak_flops_for(torch.float32)  # TF32 is off in this phase
    bound = max(rf["t_compute_s"], rf["t_memory_s"], rf["t_collective_s"])
    ms = sum(step_ms[1:]) / (len(step_ms) - 1)
    fastest = min(step_ms[1:])
    mf_share = rf["model_flops_total"] / (ms / 1e3 * peak)
    share = bound / (ms / 1e3)
    live_gib = (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30
    print(f"  {arch}: counted (dry-run cell, 1 × 1 mesh, meta, "
          f"{dry_s:.1f} s): {rf['flops_per_device']:.4e} FLOP and "
          f"{rf['bytes_per_device']:.4e} B of HBM a step; t_compute "
          f"{rf['t_compute_s'] * 1e3:.1f} ms at {peak / 1e12:.0f} TFLOP/s, "
          f"t_memory {rf['t_memory_s'] * 1e3:.1f} ms at 3.35 TB/s, "
          f"dominant {rf['dominant']}; bound {bound * 1e3:.1f} ms against "
          f"{ms:.1f} ms measured (fastest {fastest:.1f}): roofline share "
          f"{share:.3f}; model FLOPs {rf['model_flops_total']:.4e} = "
          f"{mf_share:.3f} of the measured step at {peak / 1e12:.0f} "
          f"TFLOP/s; peak_bytes_est {mem['peak_bytes_est'] / 2**30:.2f} "
          f"GiB (argument + temp {live_gib:.2f} GiB) against "
          f"max_memory_allocated "
          f"{peak_gib:.2f} GiB; argument_bytes {mem['argument_bytes']} = "
          f"the state and batch on the card {card_bytes}: "
          f"{'equal' if mem['argument_bytes'] == card_bytes else 'DIFFER'};"
          f" {card}")
    figures = [rf["flops_per_device"], rf["bytes_per_device"],
               rf["t_compute_s"], rf["t_memory_s"], bound,
               rf["model_flops_total"], mem["peak_bytes_est"],
               mem["temp_bytes"], mf_share, share]
    if not all(math.isfinite(v) and v > 0 for v in figures):
        fail(f"{arch}: a dry-run figure is not finite and nonzero: "
             f"{figures}")
    if mem["argument_bytes"] != card_bytes:
        fail(f"{arch}: the dry-run's argument_bytes "
             f"{mem['argument_bytes']} are not the {card_bytes} bytes of "
             "the state and batch on the card")
    if fastest / 1e3 < bound:
        fail(f"{arch}: a measured step ({fastest:.1f} ms) beats its "
             f"counted bound ({bound * 1e3:.1f} ms): the count is wrong")
    return {"flops": rf["flops_per_device"], "bytes": rf["bytes_per_device"],
            "t_compute_ms": rf["t_compute_s"] * 1e3,
            "t_memory_ms": rf["t_memory_s"] * 1e3,
            "dominant": rf["dominant"], "bound_ms": bound * 1e3,
            "measured_ms": ms, "roofline_share": share,
            "model_flops": rf["model_flops_total"],
            "model_flops_share": mf_share,
            "peak_bytes_est": mem["peak_bytes_est"],
            "argument_bytes": mem["argument_bytes"],
            "temp_bytes": mem["temp_bytes"], "card_bytes": card_bytes,
            "max_memory_allocated_gib": peak_gib, "dry_s": dry_s}


def lm_train_main():
    """The child's entry: phase 8 alone, on the card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lm_train_phase(torch, torch.device(DEVICE))
    return 0


def run_lm_train_phase():
    """Phase 8 in a child process; a nonzero exit fails the script."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--lm-train-phase"], capture_output=True,
                         text=True, timeout=600)
    lines = out.stdout.splitlines()
    for line in lines[:-1] + out.stderr.splitlines()[-40:]:
        print(f"  {line}" if not line.startswith("  ") else line)
    print(f"  LM training phase: {time.perf_counter() - t0:.1f} s")
    if out.returncode != 0 or not lines:
        fail(f"the LM training phase exited {out.returncode}")
    return json.loads(lines[-1])["lm_train"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def lm_main():
    """The child's entry: phase 7 alone, on the card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lm_phase(torch, torch.device(DEVICE))
    return 0


def _ws_mb(ws):
    """B4's workspace in MB: its four buffers of 4-byte words."""
    return sum(t.numel() for t in (ws.lc, ws.v, ws.roff, ws.part)) * 4 / 1e6


def run_lm_phase():
    """Phase 7 in a child process; returns the probe's kernel launches.
    A nonzero exit fails the script."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--lm-phase"], capture_output=True, text=True,
                         timeout=600)
    lines = out.stdout.splitlines()
    for line in lines[:-1] + out.stderr.splitlines()[-40:]:
        print(f"  {line}" if not line.startswith("  ") else line)
    print(f"  LM phase: {time.perf_counter() - t0:.1f} s")
    if out.returncode != 0 or not lines:
        fail(f"the LM phase exited {out.returncode}")
    return json.loads(lines[-1])["lm_probe_launches"]


# --------------------------------------- 9. the solver across processes
#
# Two ranks of a gloo group share cuda:0, each holding its part of the
# solve and launching its own B1, B4 and B5 grids.  Every run is held bit
# for bit (α, ŵ and every gap record) to the same solve in one process at
# the same mesh and seed.  A one-rank nccl group checks the collectives'
# transport through NCCL at the solve's shapes (a solve at one rank is
# the one-process path: no collective runs).

DIST_DIR = ROOT / "build" / "chip_smoke_dist"
DIST_WORLD = 2
DIST_B = 64
# name → (dataset, mesh kind and sizes, the ranks over the mesh, epochs,
# solver keywords); every run at the paper's full Table-3 widths
DIST_CASES = {
    "rcv1 p = 8": ("rcv1", ("data", 8), {"data": 2}, 2, {}),
    "rcv1 p = 8 shrink + repack": (
        "rcv1", ("data", 8), {"data": 2}, 3,
        dict(shrink_every=1, repack="auto", repack_threshold=0.8)),
    "webspam 2-D m = 4": ("webspam", ("2d", 1, SHARDS), {"model": 2}, 1,
                          {}),
    "rcv1 pods (2, 4)": ("rcv1", ("pod", 2, 4), {"pod": 2}, 2,
                         dict(pod_delay_rounds=1)),
}
DIST_SEG = ("rcv1 p = 8 segmented", "rcv1", ("data", 8), {"data": 2}, 2)
DIST_FIELDS = ("alpha", "w_hat", "gaps", "eps")
# the case whose placed X is measured, and the most of the one process's
# peak a rank may take
DIST_PLACED = "rcv1 p = 8"
DIST_PEAK_SHARE = 0.6


def _dist_mesh(kind, ranks=None):
    from repro_torch.dist.mesh import (
        SolverMesh,
        solver_mesh_2d,
        with_ranks,
    )

    if kind[0] == "data":
        mesh = SolverMesh(("data",), (kind[1],))
    elif kind[0] == "pod":
        mesh = SolverMesh(("pod", "data"), kind[1:])
    else:
        mesh = solver_mesh_2d(data=kind[1], model=kind[2])
    return mesh if ranks is None else with_ranks(mesh, ranks)


def _dist_data(torch, dev, name):
    """A Table-3 training split drawn on the card from the smoke test's
    seed (rcv1 0, webspam 2) and moved to the host, where a solve across
    ranks copies only its rank's part to the card (and a one-process
    solve all of it)."""
    from repro_torch.data.sparse import EllMatrix
    from repro_torch.data.synthetic import make_paper_split

    X, _ = make_paper_split(name, seed={"rcv1": 0, "webspam": 2}[name],
                            device=dev)
    X = EllMatrix(X.indices.cpu(), X.values.cpu(), X.n_features)
    torch.cuda.empty_cache()
    return X


def _dist_placed(torch, X, kind, ranks, kw):
    """The bytes of X that a solve on this mesh places on the card."""
    from repro_torch.core import Hinge
    from repro_torch.core.sharded import solver_mouth

    setup = solver_mouth(X, Hinge(), mesh=_dist_mesh(kind, ranks),
                         block_size=DIST_B, seed=SEED, **kw)
    nbytes = sum(t.numel() * t.element_size() for t in setup.X)
    del setup
    torch.cuda.empty_cache()
    return nbytes


def _dist_save(tag, res):
    import numpy as np

    np.savez(DIST_DIR / f"{tag}.npz",
             **{k: np.asarray(getattr(res, k).cpu()) for k in DIST_FIELDS})


def _dist_solve(torch, tag, X, kind, ranks, epochs, kw, segmented=None):
    """One solve, its result saved under ``tag``; returns its line of
    numbers (s/epoch, the collective layer's ms a round, the peak memory,
    the kernels' launches)."""
    from repro_torch.core import Hinge, sharded_passcode_solve
    from repro_torch.dist import collectives as tc
    from repro_torch.kernels.dcd_ell import dcd_ell_shards
    from repro_torch.kernels.dcd_feature import (
        dcd_feature_gram,
        dcd_feature_update,
    )
    from repro_torch.resilience import solve_segmented

    mesh = _dist_mesh(kind, ranks)
    for f in (dcd_ell_shards, dcd_feature_gram, dcd_feature_update):
        f.launches = f.pod_launches = 0
    tc.reset_stats(timed=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if segmented is None:
        res = sharded_passcode_solve(X, Hinge(), mesh=mesh, epochs=epochs,
                                     block_size=DIST_B, seed=SEED, **kw)
    else:
        res = solve_segmented(X, Hinge(), mesh=mesh, epochs=epochs,
                              block_size=DIST_B, seed=SEED,
                              checkpoint_every=1, **segmented, **kw).result
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rounds = sum(sharded_passcode_solve.epoch_rounds)
    _dist_save(tag, res)
    return {"s_epoch": secs / epochs, "rounds": rounds,
            "coll_ms_round": 1e3 * tc.STATS["seconds"] / max(rounds, 1),
            "coll_calls": tc.STATS["calls"], "coll_bytes": tc.STATS["bytes"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": {"dcd_ell_shards": dcd_ell_shards.launches,
                         "dcd_feature_gram": dcd_feature_gram.launches,
                         "dcd_feature_update": dcd_feature_update.launches},
            "epoch_rounds": list(sharded_passcode_solve.epoch_rounds)}


def dist_rank_main(rank, store):
    """A rank of the two-rank gloo group on cuda:0: every case of
    ``DIST_CASES`` and the segmented save, its numbers as the last line."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=DIST_WORLD)
    print(f"rank {rank}: backend {dist.get_backend()}, world "
          f"{dist.get_world_size()}, {torch.cuda.get_device_name(dev)}")
    data, out = {}, {}
    for name, (ds, kind, ranks, epochs, kw) in DIST_CASES.items():
        if ds not in data:
            data[ds] = _dist_data(torch, dev, ds)
        out[name] = _dist_solve(torch, f"{name}.r{rank}", data[ds], kind,
                                ranks, epochs, kw)
        if name == DIST_PLACED:
            out[name]["x_bytes"] = _dist_placed(torch, data[ds], kind,
                                                ranks, kw)
        if ds == "webspam":
            del data[ds]
            torch.cuda.empty_cache()
        dist.barrier()
    name, ds, kind, ranks, epochs = DIST_SEG
    out[name] = _dist_solve(torch, f"{name}.r{rank}", data[ds], kind, ranks,
                            epochs, {},
                            segmented=dict(ckpt_dir=str(DIST_DIR / "ckpt")))
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(out))
    return 0


def dist_one_main(store):
    """The one-process solves of every case, the segmented solve resumed
    from the two ranks' checkpoint of epoch 1, and the transport through
    a one-rank nccl group; their numbers as the last line."""
    import shutil

    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.dist import collectives as tc

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    data, out = {}, {}
    for name, (ds, kind, _, epochs, kw) in DIST_CASES.items():
        if ds not in data:
            data[ds] = _dist_data(torch, dev, ds)
        out[name] = _dist_solve(torch, f"{name}.one", data[ds], kind, None,
                                epochs, kw)
        if name == DIST_PLACED:
            out[name]["x_bytes"] = _dist_placed(torch, data[ds], kind, None,
                                                kw)
        if ds == "webspam":
            del data[ds]
            torch.cuda.empty_cache()
    name, ds, kind, _, epochs = DIST_SEG
    out[name] = _dist_solve(torch, f"{name}.one", data[ds], kind, None,
                            epochs, {})
    # the two ranks' checkpoint of epoch 1, resumed here alone
    shutil.rmtree(DIST_DIR / "ckpt" / f"ckpt_{epochs}")
    out[f"{name} resumed"] = _dist_solve(
        torch, f"{name}.resumed", data[ds], kind, None, epochs, {},
        segmented=dict(ckpt_dir=str(DIST_DIR / "ckpt"), resume=True))
    # NCCL's transport: a one-rank group, its DeviceMesh on the card.  A
    # solve on it would spread nothing (no collective runs), so each of
    # the layer's operations goes through the group at rcv1 p = 8's shapes
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=dev)
    group = _dist_mesh(("data", 8), {"data": 1}).device_mesh.get_group(
        "data")
    d1 = data["rcv1"].n_features + 1
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ops = {
        "all_gather (1, 8, d + 1) f32 Δw": (
            torch.randn((1, 8, d1), generator=gen, device=dev), None),
        "SUM (d + 1) int64 words": (
            torch.randint(-2**62, 2**62, (d1,), generator=gen, device=dev),
            dist.ReduceOp.SUM),
        "SUM (1,) int64 count": (
            torch.tensor([677_399], device=dev), dist.ReduceOp.SUM),
        "MAX () f32": (torch.rand((), generator=gen, device=dev),
                       dist.ReduceOp.MAX)}
    checks = {}
    for label, (t, op) in ops.items():
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if op is None:
                got = torch.cat(tc._all_gather(t, group))
            else:
                got = t.clone()
                dist.all_reduce(got, op=op, group=group)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        checks[label] = {"ok": bool(torch.equal(got.reshape(t.shape), t)),
                         "ms": 1e3 * min(times)}
    out["nccl transport"] = {"backend": dist.get_backend(group),
                             "checks": checks}
    dist.destroy_process_group()
    print(json.dumps(out))
    return 0


class DistRun:
    """Phase 9's children, run beside the parent's host work: the two
    gloo ranks together, then, once both have exited, the one-process
    and nccl child.  ``poll`` starts the second stage when the first is
    done; ``finish`` waits for both, prints their lines and holds every
    run to its one-process solve.  A child's nonzero exit fails the
    phase; ``kill`` stops whatever still runs."""

    def __init__(self, card):
        import shutil

        shutil.rmtree(DIST_DIR, ignore_errors=True)
        DIST_DIR.mkdir(parents=True)
        self.card, self.t0 = card, time.perf_counter()
        self.procs = [self._start(f"rank{r}", ["--dist-rank", str(r),
                                               str(DIST_DIR / "store")])
                      for r in range(DIST_WORLD)]
        self.ranks = self.one = self.t_ranks = None

    def _start(self, tag, args):
        out = open(DIST_DIR / f"{tag}.out", "w")
        err = open(DIST_DIR / f"{tag}.err", "w")
        proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                 *args], stdout=out, stderr=err, text=True)
        return args, proc, out, err, time.perf_counter()

    def _collect(self, timeout):
        """Wait for the running stage; each child's numbers (its last
        line), its other lines printed."""
        res = []
        for args, proc, out, err, t0 in self.procs:
            try:
                proc.wait(timeout=max(timeout - (time.perf_counter() - t0),
                                      1))
            except subprocess.TimeoutExpired:
                self.kill()
                fail(f"phase 9: the child {' '.join(args)} ran past "
                     f"{timeout} s")
            out.close()
            err.close()
            lines = Path(out.name).read_text().splitlines()
            for line in lines[:-1] + Path(err.name).read_text(
                    ).splitlines()[-40:]:
                print(f"    [{' '.join(args)}] {line}")
            if proc.returncode != 0 or not lines:
                self.kill()
                fail(f"phase 9: the child {' '.join(args)} exited "
                     f"{proc.returncode}")
            res.append(json.loads(lines[-1]))
        return res

    def poll(self):
        if self.ranks is None and all(p.poll() is not None
                                      for _, p, *_ in self.procs):
            self._next_stage()

    def _next_stage(self):
        self.ranks = self._collect(600)
        self.t_ranks = time.perf_counter() - self.t0
        self.procs = [self._start("one", ["--dist-one",
                                          str(DIST_DIR / "nccl")])]

    def kill(self):
        for _, proc, *_ in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def finish(self):
        import numpy as np

        if self.ranks is None:
            self._next_stage()
        (one,) = self._collect(600)
        ranks, card = self.ranks, self.card

        def load(tag):
            return dict(np.load(DIST_DIR / f"{tag}.npz"))

        def same(a, b):
            return all(np.array_equal(a[k], b[k]) for k in DIST_FIELDS)

        names = list(DIST_CASES) + [DIST_SEG[0]]
        place = [rk[DIST_PLACED]["x_bytes"] for rk in ranks]
        whole = one[DIST_PLACED]["x_bytes"]
        print(f"  {DIST_PLACED}: placed X "
              f"{', '.join(f'{b / 2**30:.4f}' for b in place)} GiB a rank, "
              f"one process {whole / 2**30:.4f} GiB; {card}")
        if any(2 * b != whole for b in place):
            fail(f"phase 9: a rank placed {place} bytes of X, not half of "
                 f"the one process's {whole}")
        for name in names:
            want = load(f"{name}.one")
            got = [load(f"{name}.r{r}") for r in range(DIST_WORLD)]
            ok = all(same(g, want) for g in got)
            print(f"  {name}: 2 gloo ranks vs one process: "
                  f"{'bit-equal' if ok else 'DIFFER'} on α, ŵ and the "
                  f"{len(want['gaps'])} gap records (gaps "
                  f"{[float(g) for g in want['gaps']]})")
            if not ok:
                diff = {k: float(np.abs(got[0][k] - want[k]).max())
                        for k in DIST_FIELDS}
                fail(f"phase 9: {name} at 2 ranks is not the one-process "
                     f"solve: max abs diff {diff}")
            base = one[name]
            for r, rk in enumerate(ranks):
                line = rk[name]
                print(f"    rank {r}: {line['s_epoch']:.3f} s/epoch (one "
                      f"process {base['s_epoch']:.3f}), collective layer "
                      f"{line['coll_ms_round']:.4f} ms a round over "
                      f"{line['rounds']} rounds ({line['coll_calls']} calls, "
                      f"{line['coll_bytes'] / 1e6:.1f} MB sent), peak "
                      f"{line['peak_gib']:.3f} GiB (one process "
                      f"{base['peak_gib']:.3f}), launches {line['launches']}; "
                      f"{card}")
                if line["peak_gib"] > DIST_PEAK_SHARE * base["peak_gib"]:
                    fail(f"phase 9: {name} rank {r} peaked at "
                         f"{line['peak_gib']:.3f} GiB, more than "
                         f"{DIST_PEAK_SHARE} of the one process's "
                         f"{base['peak_gib']:.3f}")
                if line["epoch_rounds"] != base["epoch_rounds"]:
                    fail(f"phase 9: {name} rank {r} ran rounds "
                         f"{line['epoch_rounds']}, one process "
                         f"{base['epoch_rounds']}")
                kern = ("dcd_feature_gram", "dcd_feature_update") if (
                    "2-D" in name) else ("dcd_ell_shards",)
                for k, n in line["launches"].items():
                    want_n = line["rounds"] if k in kern else 0
                    if n != want_n or n != base["launches"][k]:
                        fail(f"phase 9: {name} rank {r} launched {k} {n} "
                             f"times, expected {want_n} (one process "
                             f"{base['launches'][k]})")
        seg = DIST_SEG[0]
        resumed = load(f"{seg}.resumed")
        ok = same(resumed, load(f"{seg}.one"))
        print(f"  {seg}: saved by 2 gloo ranks after epoch 1, resumed in one "
              f"process: {'bit-equal' if ok else 'DIFFER'} to the whole "
              f"one-process solve on α, ŵ and the gap records")
        if not ok:
            fail(f"phase 9: {seg} resumed at one rank is not the whole solve")
        tr = one["nccl transport"]
        for label, c in tr["checks"].items():
            print(f"  one-rank {tr['backend']} group, transport only (a "
                  f"solve at one rank is the one-process path): {label}: "
                  f"{'unchanged' if c['ok'] else 'WRONG'}, {c['ms']:.4f} "
                  f"ms; {card}")
        if tr["backend"] != "nccl" or not all(
                c["ok"] for c in tr["checks"].values()):
            fail("phase 9: the one-rank nccl transport check failed")
        print(f"  phase 9: {time.perf_counter() - self.t0:.1f} s (the two "
              f"ranks {self.t_ranks:.1f} s)")


def dist_phase_main():
    """Phase 9 alone (``--dist-phase``): the card, the build, then the
    children."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    card = card_line()
    print(card)
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f}s")
    print("phase 9: the solver across processes (child processes)")
    DistRun(card).finish()
    return 0


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()  # the script's clock, printed per path
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch.core import duals
    from repro_torch.core.backward_error import backward_error_report
    from repro_torch.core.dcd import DcdState, dcd_epoch, dcd_solve
    from repro_torch.core.objective import (
        duality_gap,
        multiclass_accuracy,
        predict_accuracy,
        primal_objective,
        w_of_alpha,
    )
    from repro_torch.core.passcode import (
        _parallel_epoch,
        _round_indices,
        passcode_epoch,
        passcode_solve,
    )
    from repro_torch.core.asyscd import _asyscd_epoch, asyscd_solve
    from repro_torch.core.cocoa import cocoa_pod_solve, cocoa_solve
    from repro_torch.core.sharded import (
        _block_update_1d,
        _block_update_2d,
        _n_blocks,
        _place_rows,
        _pod_segments,
        _scan_rounds,
        sharded_passcode_feature,
        sharded_passcode_solve,
    )
    from repro_torch.data.labels import ovr_labels
    from repro_torch.data.sparse import EllMatrix, ell_column_split
    from repro_torch.data.synthetic import make_dataset, make_paper_split
    from repro_torch.dist.mesh import (
        dcd_dense_plan,
        dcd_ell_plan,
        dcd_tile_plan,
        feature_update_plan,
        gram_plan,
        SolverMesh,
        solver_mesh,
        solver_mesh_2d,
        solver_mesh_3d,
    )
    from repro_torch.kernels import build, dcd_feature as feat, ops
    from repro_torch.kernels.dcd_block import (
        dcd_indexed_epoch,
        dcd_indexed_epoch_plain,
        dcd_indexed_shards,
        dcd_indexed_shards_plain,
        dcd_tile_epoch,
        dcd_tile_epoch_plain,
    )
    from repro_torch.kernels.dcd_ell import (
        dcd_ell_epoch,
        dcd_ell_epoch_plain,
        dcd_ell_shards,
        dcd_ell_shards_plain,
    )

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

    # ------------------------------------------------------------ 7. LM
    # first in time: the child has the card's memory to itself (the data
    # phases below keep about 40 GB resident, and the full-depth
    # mistral-nemo-12b needs 49 GB)
    print("phase 7: the LM stack (a child process)")
    lm_launches = run_lm_phase()
    print("phase 8: LM training and serving (a child process)")
    run_lm_train_phase()

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

    # the multi-task paths' classes: the rows as the unfolded X, class
    # ids argmax_k x_iᵀV[:, k] with V a (d, K) standard normal drawn on
    # the card from SEED + 1, and Y their (K, n) one-vs-rest matrix
    def class_ids(X, K):
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 1)
        d = X.n_features if isinstance(X, EllMatrix) else X.shape[1]
        V = torch.randn((d, K), generator=g, device=dev)
        if not isinstance(X, EllMatrix):
            return torch.argmax(X @ V, dim=1)
        Vp = torch.cat([V, torch.zeros((1, K), device=dev)])  # dummy slot
        rows = max(1, (1 << 26) // (X.k_max * K))
        return torch.cat([
            torch.argmax((Vp[c.long()] * v[..., None]).sum(1), dim=1)
            for c, v in zip(X.indices.split(rows), X.values.split(rows))])

    t0 = time.perf_counter()
    classes = {}
    for name, X, K in [("rcv1", X_rcv1, K_R), ("covtype", X_cov, K_C),
                       ("webspam", X_web, K_W)]:
        ids = class_ids(X, K)
        counts = torch.bincount(ids, minlength=K)
        classes[name] = (ids, ovr_labels(ids, K, device=dev),
                         float(counts.max()) / ids.numel())
        print(f"data: {name} {K} classes, sizes {int(counts.min())} to "
              f"{int(counts.max())} (majority share "
              f"{classes[name][2]:.4f})")
    print(f"data: classes drawn in {time.perf_counter() - t0:.1f}s")
    q_r = X_rcv1.row_sq_norms()
    q_c = (X_cov * X_cov).sum(1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def blocks(n, rounds):
        return torch.randperm(n, generator=gen, device=dev)[
            : rounds * B].int().reshape(rounds, B)

    # ------------------- 9. across processes, beside phase 3's host work
    # Phase 3 holds each whole-round launch (B3's covtype epoch, B1's and
    # B2's whole-epoch orders, CoCoA's and the pod oracle's rounds) to its
    # plain version replayed on CPU copies of the inputs, about 150 s of
    # host time: the inputs are made now, and the replays run while phase
    # 9's children hold the card (this process keeps about 10 GB there).
    hinge, hinge_c = duals.Hinge(1.0), duals.Hinge(0.0625)
    gen_w = torch.Generator(device=dev)
    gen_w.manual_seed(8)
    perm_r = torch.randperm(n_r, generator=gen_w, device=dev).int()
    perm_c = torch.randperm(n_c, generator=gen_w, device=dev).int()
    from repro_torch.core.cocoa import _pod_rows
    from repro_torch.core.sharded import _device_block_perm_v

    K_CO, P_P = THREADS, 2  # CoCoA's partitions; the oracle's pods
    n_k = n_c // K_CO
    key_co, kpart = prng.split(prng.PRNGKey(SEED, device=dev))
    part = prng.permutation(kpart, n_c)[: n_k * K_CO]
    X_co = X_cov[part].contiguous()
    q_co = (X_co * X_co).sum(1)
    ids_co = prng.permutation(prng.split(prng.split(key_co)[1], K_CO),
                              n_k).to(torch.int32).contiguous()
    del part

    n_o = min(PASSCODE_ROWS, n_r)
    n_pod_o = -(-n_o // P_P)
    nb_o = _n_blocks(n_pod_o, B)
    rows_o, q_o = _pod_rows(EllMatrix(X_rcv1.indices[:n_o],
                                      X_rcv1.values[:n_o], d_r), n_pod_o, P_P)
    sub_o = prng.split(prng.PRNGKey(SEED, device=dev))[1]
    ids_o = torch.stack([
        _device_block_perm_v(sub_o, k_, P_P, n_pod_o,
                             min(max(n_o - k_ * n_pod_o, 1), n_pod_o), nb_o,
                             B).reshape(-1)
        for k_ in range(P_P)]).to(torch.int32).contiguous()

    def co_round(shards, rows, q, n_loc):
        def run(a, w, i, L):
            a, dw = shards(*rows, a, w, q, loss=L, idx=i, n_loc=n_loc)
            return a, w + dw.sum(0)
        return run

    def zeros_co():
        return (torch.zeros(n_k * K_CO, device=dev),
                torch.zeros(d_c, device=dev))

    def zeros_o():
        return (torch.zeros(P_P * n_pod_o, device=dev),
                torch.zeros(d_r + 1, device=dev))

    X_cov_h, q_c_h = X_cov.cpu(), q_c.cpu()  # the host replays' rows
    cols_r_h, vals_r_h, q_r_h = (X_rcv1.indices.cpu(), X_rcv1.values.cpu(),
                                 q_r.cpu())
    replays = [
        ("b3", lambda a, w: dcd_tile_epoch_plain(X_cov_h, a, w, q_c_h,
                                                 loss=hinge_c),
         (torch.zeros(n_c), torch.zeros(d_c))),
        ("b1e", lambda a, w, i, L: dcd_ell_epoch_plain(
            cols_r_h, vals_r_h, a, w, q_r_h, loss=L, idx=i),
         (torch.zeros(n_r), torch.zeros(d_r + 1), perm_r, hinge)),
        ("b2e", lambda a, w, i, L: dcd_indexed_epoch_plain(
            X_cov_h, a, w, q_c_h, loss=L, idx=i),
         (torch.zeros(n_c), torch.zeros(d_c), perm_c, hinge_c)),
        ("dcd_indexed_cocoa", co_round(dcd_indexed_shards_plain,
                                       [X_co.cpu()], q_co.cpu(), n_k),
         (*zeros_co(), ids_co, hinge_c)),
        ("dcd_ell_cocoa_pods", co_round(dcd_ell_shards_plain,
                                        [r.cpu() for r in rows_o],
                                        q_o.cpu(), n_pod_o),
         (*zeros_o(), ids_o, hinge))]
    print("phase 9: the solver across processes (child processes, beside "
          "phase 3's host replays)")
    dist_run = DistRun(card)
    try:
        replayed = {}
        for key, plain, args in replays:
            replayed[key] = replay_on_host(plain, *args)
            print(f"  host replay {key}: {replayed[key][1]:.1f} s")
            dist_run.poll()
        dist_run.finish()
    except BaseException:
        dist_run.kill()
        raise
    del replays, X_cov_h, q_c_h, cols_r_h, vals_r_h, q_r_h

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

    def one_shard(shards, *Xq):
        """B1's or B2's shard-grid wrapper as the p = 1 solver round
        launches it, a grid of one shard (``shards`` a kernel wrapper or
        its plain version; ``Xq`` the rows and q): returns (α, w + the
        shard's Δw), the round's new state."""
        def run(a, w, i, L, **kw):
            *rows, q = Xq
            a, dw = shards(*rows, a, w, q, loss=L, idx=i[None], n_loc=0,
                           **kw)
            return a, w + dw[0]
        return run

    # B1 and B2 at p = 1 through the wrapper the solver's round calls
    # (``dcd_ell_shards`` / ``dcd_indexed_shards`` over a grid of one
    # shard, which writes that shard's Δw)
    r1 = one_shard(dcd_ell_shards, X_rcv1.indices, X_rcv1.values, q_r)
    r1_plain = one_shard(dcd_ell_shards_plain, X_rcv1.indices,
                         X_rcv1.values, q_r)
    err_b1 = compare("B1 dcd_ell_shards p = 1", r1, r1_plain, zeros_r, ids_r,
                     losses)
    err_b1 = max(err_b1, compare(
        "B1 dcd_ell_shards p = 1 (mask, labels)",
        lambda a, w, i, L: r1(a, w, i, L, active=act_r, y=y_r),
        lambda a, w, i, L: r1_plain(a, w, i, L, active=act_r, y=y_r),
        zeros_r, ids_r[:2], ["hinge"]))
    print(f"  B1 at the rcv1 shape: {dcd_ell_plan(B, k_r)}")
    # the wide variant at the same shape, as the staged one's "before"
    err_b1_before = compare(
        "B1 dcd_ell_shards p = 1 wide at the rcv1 shape",
        lambda a, w, i, L: r1(a, w, i, L, wide=True), r1_plain, zeros_r,
        ids_r[:2], ["hinge"])
    a_r0, w_r0 = zeros_r()
    same_bits("B1 dcd_ell_shards p = 1 staged (rcv1, hinge, mask, labels)",
              lambda: r1(a_r0, w_r0, ids_r[0], duals.Hinge(1.0),
                         active=act_r, y=y_r), torch)

    # B1's wide variant on webspam's rows (k = 3,728: a block too large
    # to stage), the 1-D webspam path's shape
    n_w1, k_w1, d_w1 = X_web.n_rows, X_web.k_max, X_web.n_features
    q_w1 = X_web.row_sq_norms()
    ids_w1 = blocks(n_w1, 2)
    print(f"  B1 at webspam's rows: {dcd_ell_plan(B, k_w1)}")

    def zeros_w1():
        return (torch.zeros(n_w1, device=dev),
                torch.zeros(d_w1 + 1, device=dev))

    r1w = one_shard(dcd_ell_shards, X_web.indices, X_web.values, q_w1)
    r1w_plain = one_shard(dcd_ell_shards_plain, X_web.indices, X_web.values,
                          q_w1)
    err_b1w = compare("B1 dcd_ell_shards p = 1 wide", r1w, r1w_plain,
                      zeros_w1, ids_w1, losses)
    a_w1, w_w1 = zeros_w1()
    same_bits("B1 dcd_ell_shards p = 1 wide (webspam rows, hinge)",
              lambda: r1w(a_w1, w_w1, ids_w1[0], duals.Hinge(1.0)), torch)

    ids_c = blocks(n_c, 4)

    def zeros_c():
        return torch.zeros(n_c, device=dev), torch.zeros(d_c, device=dev)

    act_c = (torch.rand(n_c, generator=gen, device=dev) > 0.2).float()
    y_c = torch.where(torch.rand(n_c, generator=gen, device=dev) > 0.5,
                      1.0, -1.0)
    print(f"  B2 at the covtype shape: {dcd_dense_plan(B, d_c)}")
    r2 = one_shard(dcd_indexed_shards, X_cov, q_c)
    r2_plain = one_shard(dcd_indexed_shards_plain, X_cov, q_c)
    err_b2 = compare("B2 dcd_indexed_shards p = 1", r2, r2_plain, zeros_c,
                     ids_c, losses)
    err_b2 = max(err_b2, compare(
        "B2 dcd_indexed_shards p = 1 (mask, labels)",
        lambda a, w, i, L: r2(a, w, i, L, active=act_c, y=y_c),
        lambda a, w, i, L: r2_plain(a, w, i, L, active=act_c, y=y_c),
        zeros_c, ids_c[:2], ["hinge"]))
    # the wide variant at the same shape, as the staged one's "before"
    err_b2_before = compare(
        "B2 dcd_indexed_shards p = 1 wide at the covtype shape",
        lambda a, w, i, L: r2(a, w, i, L, wide=True), r2_plain, zeros_c,
        ids_c[:2], ["hinge"])
    a_c0, w_c0 = zeros_c()
    for wide in (False, True):
        same_bits(f"B2 dcd_indexed_shards p = 1 "
                  f"{'wide' if wide else 'staged'} (covtype, hinge, mask, "
                  "labels)",
                  lambda: r2(a_c0, w_c0, ids_c[0], duals.Hinge(1.0),
                             active=act_c, y=y_c, wide=wide), torch)
    # B3 runs its rows in order.  The main path gives it the whole
    # covtype shard in one launch (ops.dcd_epoch, hinge C = 0.0625), which
    # takes its stream variant: hold it to its plain version there, one
    # whole epoch from α = 0, w = 0 (the plain version replayed on CPU
    # copies of the same inputs, and timed on the card over the epoch's
    # first PLAIN_IDS rows), and time the kernel on it, with the wide
    # variant (the design the stream one replaced) held and re-timed on the
    # same inputs as its "before".  A few rows suffice for the other two
    # losses, from an aligned and from an unaligned offset (a view whose
    # base and q are not 16-byte aligned: the stages are copied in 4-byte
    # units).
    print(f"  B3 at the covtype shape: {dcd_tile_plan(n_c, d_c)}")
    a0_c, w0_c = torch.zeros(n_c, device=dev), torch.zeros(d_c, device=dev)
    p3, host_b3 = replayed["b3"]
    moved_b3 = int((p3[0] != 0).sum())  # rows whose update scattered
    n_p3 = min(PLAIN_IDS, n_c)  # the epoch's first rows, timed on the card
    plain_b3 = wall_ms(lambda: dcd_tile_epoch_plain(
        X_cov[:n_p3], a0_c[:n_p3], w0_c, q_c[:n_p3], loss=hinge_c), 1, torch)
    err_b3 = err_b3_before = 0.0
    for wide in (False, True):
        e = max_err(dcd_tile_epoch(X_cov, a0_c, w0_c, q_c, loss=hinge_c,
                                   wide=wide), p3)
        what = "wide" if wide else "stream"
        print(f"  B3 dcd_tile {what} hinge: max abs err {e:.3g} over one "
              f"epoch of {n_c} rows ({moved_b3} scattered; |w| max "
              f"{float(p3[1].abs().max()):.4g}; tolerance {ATOL}); plain "
              f"version on the host {host_b3:.1f} s, on the card "
              f"{plain_b3:.1f} ms over the first {n_p3} rows")
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
    a_r, w_r = zeros_r()
    t_ids = blocks(n_r, 64)
    it = iter(range(10**9))
    # (the wrapper alone, as the p = 1 round calls it: a grid of one
    # shard, returning its Δw; the round's w + Δw is not timed)
    def b1_p1(w_, ids, wide=False):
        return dcd_ell_shards(X_rcv1.indices, X_rcv1.values, a_r, w_, q_r,
                              loss=hinge, idx=ids[None], n_loc=0, wide=wide)

    ms_b1 = cuda_ms(lambda: b1_p1(w_r, t_ids[next(it) % 64]), 50, torch)
    # the design B1 had before its staged variant (the wide kernel) at
    # the same shape, timed the same way
    ms_b1_before = cuda_ms(lambda: b1_p1(w_r, t_ids[next(it) % 64], True),
                           50, torch)
    plain_b1 = wall_ms(lambda: dcd_ell_shards_plain(
        X_rcv1.indices, X_rcv1.values, a_r, w_r, q_r, loss=hinge,
        idx=t_ids[:1], n_loc=0), 2, torch)
    w_ids = blocks(n_w1, 16)
    ms_b1w = cuda_ms(lambda: dcd_ell_shards(
        X_web.indices, X_web.values, a_w1, w_w1, q_w1, loss=hinge,
        idx=w_ids[next(it) % 16][None], n_loc=0), 20, torch)
    plain_b1w = wall_ms(lambda: dcd_ell_shards_plain(
        X_web.indices, X_web.values, a_w1, w_w1, q_w1, loss=hinge,
        idx=w_ids[:1], n_loc=0), 2, torch)
    a_c, w_c = zeros_c()
    c_ids = blocks(n_c, 64)

    def b2_p1(ids, wide=False):
        return dcd_indexed_shards(X_cov, a_c, w_c, q_c, loss=hinge_c,
                                  idx=ids[None], n_loc=0, wide=wide)

    ms_b2 = cuda_ms(lambda: b2_p1(c_ids[next(it) % 64]), 50, torch)
    # the design B2 had before its staged variant (the wide kernel) at the
    # same shape, timed the same way
    ms_b2_before = cuda_ms(lambda: b2_p1(c_ids[next(it) % 64], True), 50,
                           torch)
    plain_b2 = wall_ms(lambda: dcd_indexed_shards_plain(
        X_cov, a_c, w_c, q_c, loss=hinge_c, idx=c_ids[:1], n_loc=0), 2,
        torch)

    # bytes each timed call must move: α in and out (the wrapper returns
    # a new one), w in and the shard's Δw out, and the visited rows with
    # their q (and ids);
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
                               ms_logistic=ms_b3_logistic, plain_ids=n_p3,
                               plain_host_ms=host_b3 * 1e3)
    for name, what, ms, e in [
            ("dcd_ell", f"its staged variant (the wide kernel at the rcv1 "
             f"shape, {B} ids", ms_b1_before, err_b1_before),
            ("dcd_indexed", f"its staged variant (the wide kernel at the "
             f"covtype shape, {B} ids", ms_b2_before, err_b2_before),
            ("dcd_tile", "its stream variant (the wide kernel, one covtype "
             "epoch", ms_b3_before, err_b3_before)]:
        print(f"  {name} before {what}; max abs err {e:.3g}): {ms:.4f} ms "
              "per launch")

    # B1's and B2's wide variants over a whole epoch's order: serial DCD
    # and PASSCoDe-Lock hand the kernel all n ids of the epoch at once,
    # past the staged plans' 1,024.  Each is held to its plain version
    # over the whole order with the main path's loss (hinge; C = 0.0625
    # on covtype), from α = 0 and w = 0, the plain version replayed on CPU
    # copies of the same inputs (and timed on the card over the order's
    # first PLAIN_IDS ids, one update at a time, about 0.15 ms an update
    # there); the other two losses over the order's first PREFIX ids
    # (still the wide plan)
    print(f"  B1 over a whole rcv1 epoch: {dcd_ell_plan(n_r, k_r)}; B2 over "
          f"a whole covtype epoch: {dcd_dense_plan(n_c, d_c)}")

    def whole_epoch(label, kernel, plain, replay, state0, order, loss):
        ka = kernel(*state0(), order, loss)
        p, host_s = replay
        e = max_err(ka, p)
        pl_ms = wall_ms(lambda: plain(*state0(), order[:PLAIN_IDS], loss), 1,
                        torch)
        print(f"  {label}: max abs err {e:.3g} over {order.numel()} updates "
              f"(tolerance {ATOL}); plain version on the host {host_s:.1f} "
              f"s, on the card {pl_ms:.1f} ms over the first "
              f"{min(PLAIN_IDS, order.numel())} ids")
        if not e <= ATOL:
            fail(f"{label} disagrees with its plain version")
        return e, pl_ms, host_s * 1e3

    def b1(a, w, i, L):
        return dcd_ell_epoch(X_rcv1.indices, X_rcv1.values, a, w, q_r,
                             loss=L, idx=i)

    def b1_plain(a, w, i, L):
        return dcd_ell_epoch_plain(X_rcv1.indices, X_rcv1.values, a, w, q_r,
                                   loss=L, idx=i)

    def b2(a, w, i, L):
        return dcd_indexed_epoch(X_cov, a, w, q_c, loss=L, idx=i)

    def b2_plain(a, w, i, L):
        return dcd_indexed_epoch_plain(X_cov, a, w, q_c, loss=L, idx=i)

    err_b1e, plain_b1e, host_b1e = whole_epoch(
        "B1 dcd_ell wide, a whole rcv1 epoch's order (hinge)", b1, b1_plain,
        replayed["b1e"], zeros_r, perm_r, hinge)
    err_b2e, plain_b2e, host_b2e = whole_epoch(
        "B2 dcd_indexed wide, a whole covtype epoch's order (hinge)", b2,
        b2_plain, replayed["b2e"], zeros_c, perm_c, hinge_c)
    err_b1e = max(err_b1e, compare(
        f"B1 dcd_ell wide, an epoch's order (first {PREFIX} ids)", b1,
        b1_plain, zeros_r, perm_r[None, :PREFIX], losses[1:]))
    err_b2e = max(err_b2e, compare(
        f"B2 dcd_indexed wide, an epoch's order (first {PREFIX} ids)", b2,
        b2_plain, zeros_c, perm_c[None, :PREFIX], losses[1:]))
    same_bits("B1 dcd_ell wide (a whole rcv1 epoch, hinge)",
              lambda: b1(a_r, w_r, perm_r, hinge), torch)
    same_bits("B2 dcd_indexed wide (a whole covtype epoch, hinge)",
              lambda: b2(a_c, w_c, perm_c, hinge_c), torch)
    ms_b1e = cuda_ms(lambda: b1(a_r, w_r, perm_r, hinge), 2, torch)
    ms_b2e = cuda_ms(lambda: b2(a_c, w_c, perm_c, hinge_c), 2, torch)
    # bytes: α and w in and out, each id's row, q and id once; operations:
    # a multiply-add per row entry for the dot and one for the axpy
    by_b1e = 4 * (2 * n_r + 2 * (d_r + 1)) + n_r * (k_r * 8 + 2 * 4)
    by_b2e = 4 * (2 * n_c + 2 * d_c) + n_c * (d_c * 4 + 2 * 4)
    for name, route_ms, pl_ms, host_ms, by, ops_n, n_ids, err, src, rep in [
        ("dcd_ell_epoch", ms_b1e, plain_b1e, host_b1e, by_b1e,
         4 * n_r * k_r, n_r, err_b1e,
         "src/repro_torch/kernels/csrc/dcd_ell.cu",
         "src/repro/kernels/dcd_ell.py:51"),
        ("dcd_indexed_epoch", ms_b2e, plain_b2e, host_b2e, by_b2e,
         4 * n_c * d_c, n_c, err_b2e,
         "src/repro_torch/kernels/csrc/dcd_block.cu",
         "src/repro/kernels/dcd_block.py:100"),
    ]:
        b_ms, b_by = bound(by, ops_n)
        results[name] = dict(name=name, route="cuda", source=src,
                             replaces=rep, variant="wide", launches=0,
                             max_abs_err=err, ms=route_ms, plain_ms=pl_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=None,
                             ids=n_ids, plain_ids=min(PLAIN_IDS, n_ids),
                             plain_host_ms=host_ms)
        print(f"  {name} (wide, {n_ids} ids, a whole epoch): {route_ms:.4f} "
              f"ms per launch ({route_ms / n_ids * 1e6:.1f} ns per update), "
              f"plain {pl_ms:.1f} ms over the first {min(PLAIN_IDS, n_ids)} "
              f"ids ({pl_ms / min(PLAIN_IDS, n_ids) * 1e6:.1f} ns per "
              f"update), bound {b_ms:.6f} ms ({b_by}), no library call "
              "computes it")

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
          f"workspace {_ws_mb(ws):.2f} MB")
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
        "B1 staged": cuda_ms(lambda: b1_p1(w_r, t_ids[next(it) % 64]), 50,
                             torch, spin=False),
        "B1 wide": cuda_ms(lambda: b1_p1(w_r, t_ids[next(it) % 64], True),
                           50, torch, spin=False),
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
    # ------------------------------- the shard grid: p data shards a launch
    # B1, B2, B4 and B5 over p data shards (a CTA, or a group of CTAs, a
    # shard) at the p > 1 main paths' shapes, the rows laid out as the
    # solver lays them out (n_pad = p·n_loc, the tail zero rows, q = 1),
    # held to their plain versions over a few rounds from α = 0: each
    # round the kernel and the plain version take the same ids and their
    # own carried (α, w), each shard's Δw compared, and w += the Δw sum
    def pad_rows(t, n_pad, fill):
        extra = n_pad - t.shape[0]
        if extra == 0:
            return t
        return torch.cat([t, torch.full((extra, *t.shape[1:]), fill,
                                        dtype=t.dtype, device=dev)])

    def shard_ids(n, p, rounds):
        """(n_loc, ids (rounds, p, B)): each shard's B distinct real rows
        a round, shard-local."""
        n_loc = -(-n // p)
        per = []
        for s_ in range(p):
            v = min(max(n - s_ * n_loc, 1), n_loc)
            per.append(torch.stack([
                torch.randperm(v, generator=gen, device=dev)[:B]
                for _ in range(rounds)]))
        return n_loc, torch.stack(per, 1).int().contiguous()

    def compare_grid(name, kernel, plain, state0, ids, losses):
        err = 0.0
        for lname, rounds in losses:
            loss = duals.make_loss(lname, 0.5 if lname == "logistic" else 1.0)
            (ka, kw), (pa, pw) = state0(), state0()
            e = 0.0
            for r in range(rounds):
                ka, kdw = kernel(ka, kw, ids[r], loss)
                pa, pdw = plain(pa, pw, ids[r], loss)
                e = max(e, float((kdw - pdw).abs().max()))
                kw, pw = kw + kdw.sum(0), pw + pdw.sum(0)
            torch.cuda.synchronize()
            e = max(e, float((ka - pa).abs().max()),
                    float((kw - pw).abs().max()))
            print(f"  {name} {lname}: max abs err {e:.3g} over {rounds} "
                  f"rounds of {ids.shape[1]} × {B} updates (each shard's "
                  f"Δw, α and w; tolerance {ATOL})")
            if not e <= ATOL:
                fail(f"{name} disagrees with its plain version ({lname})")
            err = max(err, e)
        return err

    grid_losses = [("hinge", 3), ("squared_hinge", 1), ("logistic", 1)]
    grid = {}  # name → (ms, plain ms, bytes, ops, what, err, library ms)

    # B1 staged at rcv1, p = 8: n_loc = 84,675, one padding row
    P_R = 8
    n_loc_r8, ids_r8 = shard_ids(n_r, P_R, 16)
    np_r8 = P_R * n_loc_r8
    cols_r8 = pad_rows(X_rcv1.indices, np_r8, d_r)
    vals_r8 = pad_rows(X_rcv1.values, np_r8, 0.0)
    q_r8 = pad_rows(q_r, np_r8, 1.0)

    def g1(a, w, i, L, wide=False):
        return dcd_ell_shards(cols_r8, vals_r8, a, w, q_r8, loss=L, idx=i,
                              n_loc=n_loc_r8, wide=wide)

    def g1_plain(a, w, i, L):
        return dcd_ell_shards_plain(cols_r8, vals_r8, a, w, q_r8, loss=L,
                                    idx=i, n_loc=n_loc_r8)

    def zeros_r8():
        return (torch.zeros(np_r8, device=dev),
                torch.zeros(d_r + 1, device=dev))

    print(f"  B1 shard grid at rcv1, p = {P_R}: "
          f"{dcd_ell_plan(B, k_r, False, P_R)}")
    err_g1 = compare_grid(f"B1 dcd_ell_shards staged (rcv1, p = {P_R})", g1,
                          g1_plain, zeros_r8, ids_r8, grid_losses)
    a_g, w_g = zeros_r8()
    same_bits(f"B1 dcd_ell_shards staged (rcv1, p = {P_R}, hinge)",
              lambda: g1(a_g, w_g, ids_r8[0], hinge), torch)
    ms_g1 = cuda_ms(lambda: g1(a_g, w_g, ids_r8[next(it) % 16], hinge), 50,
                    torch)
    plain_g1 = wall_ms(lambda: g1_plain(a_g, w_g, ids_r8[0], hinge), 1,
                       torch)
    grid["dcd_ell_shards"] = (
        ms_g1, plain_g1,
        4 * (2 * np_r8 + (1 + P_R) * (d_r + 1)) + P_R * B * (k_r * 8 + 8),
        4 * P_R * B * k_r, f"rcv1, p = {P_R}, {B} ids a shard", err_g1, None,
        "src/repro_torch/kernels/csrc/dcd_ell.cu",
        "src/repro/kernels/dcd_ell.py:51", "staged")

    # B1 wide at webspam's rows, p = 2 (n = 280,000: no padding)
    P_W1 = 2
    n_loc_w1, ids_w1g = shard_ids(n_w1, P_W1, 8)

    def g1w(a, w, i, L):
        return dcd_ell_shards(X_web.indices, X_web.values, a, w, q_w1,
                              loss=L, idx=i, n_loc=n_loc_w1)

    def g1w_plain(a, w, i, L):
        return dcd_ell_shards_plain(X_web.indices, X_web.values, a, w, q_w1,
                                    loss=L, idx=i, n_loc=n_loc_w1)

    print(f"  B1 shard grid at webspam's rows, p = {P_W1}: "
          f"{dcd_ell_plan(B, k_w1, False, P_W1)}")
    err_g1w = compare_grid(f"B1 dcd_ell_shards wide (webspam rows, p = "
                           f"{P_W1})", g1w, g1w_plain, zeros_w1, ids_w1g,
                           [("hinge", 2), ("squared_hinge", 1),
                            ("logistic", 1)])
    a_g, w_g = zeros_w1()
    same_bits(f"B1 dcd_ell_shards wide (webspam rows, p = {P_W1}, hinge)",
              lambda: g1w(a_g, w_g, ids_w1g[0], hinge), torch)
    ms_g1w = cuda_ms(lambda: g1w(a_g, w_g, ids_w1g[next(it) % 8], hinge),
                     20, torch)
    plain_g1w = wall_ms(lambda: g1w_plain(a_g, w_g, ids_w1g[0], hinge), 1,
                        torch)
    grid["dcd_ell_shards_wide"] = (
        ms_g1w, plain_g1w,
        4 * (2 * n_w1 + (1 + P_W1) * (d_w1 + 1))
        + P_W1 * B * (k_w1 * 8 + 8),
        4 * P_W1 * B * k_w1, f"webspam rows, p = {P_W1}, {B} ids a shard",
        err_g1w, None, "src/repro_torch/kernels/csrc/dcd_ell.cu",
        "src/repro/kernels/dcd_ell.py:51", "wide")

    # B2 staged at covtype, p = 8: n_loc = 72,627, four padding rows
    P_C = 8
    n_loc_c8, ids_c8 = shard_ids(n_c, P_C, 16)
    np_c8 = P_C * n_loc_c8
    X_c8 = pad_rows(X_cov, np_c8, 0.0)
    q_c8 = pad_rows(q_c, np_c8, 1.0)

    def g2(a, w, i, L):
        return dcd_indexed_shards(X_c8, a, w, q_c8, loss=L, idx=i,
                                  n_loc=n_loc_c8)

    def g2_plain(a, w, i, L):
        return dcd_indexed_shards_plain(X_c8, a, w, q_c8, loss=L, idx=i,
                                        n_loc=n_loc_c8)

    def zeros_c8():
        return torch.zeros(np_c8, device=dev), torch.zeros(d_c, device=dev)

    print(f"  B2 shard grid at covtype, p = {P_C}: "
          f"{dcd_dense_plan(B, d_c, False, P_C)}")
    err_g2 = compare_grid(f"B2 dcd_indexed_shards staged (covtype, p = "
                          f"{P_C})", g2, g2_plain, zeros_c8, ids_c8,
                          grid_losses)
    a_g, w_g = zeros_c8()
    same_bits(f"B2 dcd_indexed_shards staged (covtype, p = {P_C}, hinge)",
              lambda: g2(a_g, w_g, ids_c8[0], hinge_c), torch)
    ms_g2 = cuda_ms(lambda: g2(a_g, w_g, ids_c8[next(it) % 16], hinge_c),
                    50, torch)
    plain_g2 = wall_ms(lambda: g2_plain(a_g, w_g, ids_c8[0], hinge_c), 1,
                       torch)
    grid["dcd_indexed_shards"] = (
        ms_g2, plain_g2,
        4 * (2 * np_c8 + (1 + P_C) * d_c) + P_C * B * (d_c * 4 + 8),
        4 * P_C * B * d_c, f"covtype, p = {P_C}, {B} ids a shard", err_g2,
        None, "src/repro_torch/kernels/csrc/dcd_block.cu",
        "src/repro/kernels/dcd_block.py:100", "staged")

    # B4 + B5 at webspam, data = 2, m = 4 (n = 280,000: no padding): per
    # round B4 over the 2 × 4 (data, model) pairs, the sum over model per
    # data shard, B5 into each data shard's replica of the slices
    P_D = 2
    n_loc_d, ids_d = shard_ids(n_w, P_D, 8)
    ws2 = feat.gram_workspace(SHARDS, B, k_loc, d1_w, dev, P_D)
    print(f"  B4 at the webspam split, data = {P_D}: "
          f"{gram_plan(SHARDS, B, k_loc, d1_w, P_D)}; workspace "
          f"{_ws_mb(ws2):.2f} MB")
    err_g4 = err_g5 = 0.0
    for lname, rounds in [("hinge", 3), ("squared_hinge", 1),
                          ("logistic", 1)]:
        loss = duals.make_loss(lname, 0.5 if lname == "logistic" else 1.0)
        ka, kw = pa, pw = state_w()
        e4 = e5 = 0.0
        for r in range(rounds):
            kb, kg = feat.dcd_feature_gram(cols_w, vals_w, kw, ids_d[r],
                                           workspace=ws2, n_loc=n_loc_d)
            pb, pg = feat.dcd_feature_gram_plain(cols_w, vals_w, pw,
                                                 ids_d[r], n_loc_d)
            e4 = max(e4, float((kb - pb).abs().max()),
                     float((kg - pg).abs().max()))
            ka, krep = feat.dcd_feature_update(
                cols_w, vals_w, ka, q_w, kw, ids_d[r], kb.sum(1), kg.sum(1),
                loss=loss, workspace=ws2, n_loc=n_loc_d)
            pa, prep = feat.dcd_feature_update_plain(
                cols_w, vals_w, pa, q_w, pw, ids_d[r], pb.sum(1), pg.sum(1),
                loss=loss, n_loc=n_loc_d)
            e5 = max(e5, float((krep - prep).abs().max()))
            kw, pw = kw + (krep - kw).sum(0), pw + (prep - pw).sum(0)
        torch.cuda.synchronize()
        e5 = max(e5, float((ka - pa).abs().max()),
                 float((kw - pw).abs().max()))
        print(f"  B4 dcd_feature_gram data = {P_D} {lname}: max abs err "
              f"{e4:.3g} over {rounds} rounds; B5 dcd_feature_update: "
              f"{e5:.3g} over {rounds * P_D * B} updates (tolerance {ATOL})")
        if not (e4 <= ATOL and e5 <= ATOL):
            fail(f"B4/B5 over data shards disagree with their plain "
                 f"versions ({lname})")
        err_g4, err_g5 = max(err_g4, e4), max(err_g5, e5)
    w_same = state_w()[1]
    same_bits(f"B4 dcd_feature_gram (webspam, data = {P_D})",
              lambda: feat.dcd_feature_gram(cols_w, vals_w, w_same, ids_d[0],
                                            workspace=ws2, n_loc=n_loc_d),
              torch)
    b_d, g_d = ops.dcd_feature_gram(cols_w, vals_w, w_same, ids_d[0],
                                    workspace=ws2, n_loc=n_loc_d)
    a_same = torch.zeros(n_w, device=dev)
    same_bits(f"B5 dcd_feature_update (webspam, data = {P_D}, hinge)",
              lambda: feat.dcd_feature_update(
                  cols_w, vals_w, a_same, q_w, w_same, ids_d[0], b_d, g_d,
                  loss=hinge, workspace=ws2, n_loc=n_loc_d), torch)
    ms_g4 = cuda_ms(lambda: feat.dcd_feature_gram(
        cols_w, vals_w, w_same, ids_d[next(it) % 8], workspace=ws2,
        n_loc=n_loc_d), 50, torch)
    ms_g5 = cuda_ms(lambda: feat.dcd_feature_update(
        cols_w, vals_w, a_same, q_w, w_same, ids_d[0], b_d, g_d, loss=hinge,
        workspace=ws2, n_loc=n_loc_d), 50, torch)
    plain_g4 = wall_ms(lambda: feat.dcd_feature_gram_plain(
        cols_w, vals_w, w_same, ids_d[0], n_loc_d), 1, torch)
    plain_g5 = wall_ms(lambda: feat.dcd_feature_update_plain(
        cols_w, vals_w, a_same, q_w, w_same, ids_d[0], b_d, g_d, loss=hinge,
        n_loc=n_loc_d), 1, torch)
    mats_d = [sparse_block(j, ids_d[0][s_] + s_ * n_loc_d)
              for s_ in range(P_D) for j in range(SHARDS)]
    lib_g4 = cuda_ms(lambda: [torch.sparse.mm(S, St) for S, St in mats_d],
                     20, torch)
    rows_d = (ids_d[0].long()
              + n_loc_d * torch.arange(P_D, device=dev)[:, None]).reshape(-1)
    nnz_d = int((cols_w[rows_d] < d_loc).sum())
    grid["dcd_feature_gram_data"] = (
        ms_g4, plain_g4,
        4 * P_D * B * SHARDS * k_loc + 8 * nnz_d + 4 * P_D * B
        + 4 * P_D * SHARDS * (B + B * B),
        2 * B * nnz_d + 2 * nnz_d, f"webspam, data = {P_D}, m = {SHARDS}, "
        f"{B} ids a data shard", err_g4, lib_g4,
        "src/repro_torch/kernels/csrc/dcd_feature.cu",
        "src/repro/kernels/dcd_feature.py:60", "column-class")
    grid["dcd_feature_update_data"] = (
        ms_g5, plain_g5,
        8 * n_w + 4 * (1 + P_D) * SHARDS * d1_w + 4 * P_D * B * SHARDS * k_loc
        + 4 * nnz_d + P_D * (12 * B + 4 * B * B),
        2 * nnz_d + P_D * B * B, f"webspam, data = {P_D}, m = {SHARDS}, "
        f"{B} ids a data shard", err_g5, None,
        "src/repro_torch/kernels/csrc/dcd_feature.cu",
        "src/repro/kernels/dcd_feature.py:106", "column-class")
    for name, (route_ms, pl_ms, by, ops_n, per, err, lib_ms, src, rep,
               variant) in grid.items():
        b_ms, b_by = bound(by, ops_n)
        results[name] = dict(name=name, route="cuda", source=src,
                             replaces=rep, variant=variant, launches=0,
                             max_abs_err=err, ms=route_ms, plain_ms=pl_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        lib = ("no library call computes it" if lib_ms is None
               else f"torch.sparse.mm {lib_ms:.4f} ms")
        print(f"  {name} ({per}): {route_ms:.4f} ms per launch, plain "
              f"{pl_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by}), {lib}")
    print(f"  shard-grid launches per epoch: rcv1 p = {P_R} "
          f"{_n_blocks(n_loc_r8, B)}, covtype p = {P_C} "
          f"{_n_blocks(n_loc_c8, B)}, webspam data = {P_D} "
          f"{_n_blocks(n_loc_d, B)} (B4 and B5 each), webspam rows p = "
          f"{P_W1} {_n_blocks(n_loc_w1, B)}")
    del mats_d, a_g, w_g

    # ----------------------- the task grid: K tasks of p shards a launch
    # B1, B2, B4 and B5 over the multi-task paths' (task × shard) grids:
    # rcv1 K = 53 at p = 8 (B1 staged, 424 CTAs), covtype K = 7 at p = 8
    # (B2 staged, 56 CTAs) and the webspam split K = 4 at m = 4 (B4 over
    # 16 (task, model) pairs, B5 R × 16 CTAs), with the paths' own labels
    # folded on read and one (p, B) block for every task, as the solver
    # draws it without repacking; held to the plain versions (which loop
    # the tasks, then the shards) over 2 rounds from α = 0 with hinge,
    # each pair's Δw, α and w compared; a second launch to the same bits;
    # timed behind the spin
    def pad_labels(Y, n_pad):
        return torch.cat([Y, torch.ones((Y.shape[0], n_pad - Y.shape[1]),
                                        device=dev)], 1).contiguous()

    def compare_tasks(name, kernel, plain, state0, ids, rounds=2):
        """The grid's rounds through the kernel and its plain version
        (hinge), each carrying its own (α, w), w += each task's Δw summed
        over its shards; returns (max abs err, the plain version's ms a
        call)."""
        (ka, kw), (pa, pw) = state0(), state0()
        e, pl = 0.0, []
        for r in range(rounds):
            ka, kdw = kernel(ka, kw, ids[r])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pa, pdw = plain(pa, pw, ids[r])
            torch.cuda.synchronize()
            pl.append((time.perf_counter() - t0) * 1e3)
            e = max(e, float((kdw - pdw).abs().max()))
            kw, pw = kw + kdw.sum(1), pw + pdw.sum(1)
        e = max(e, float((ka - pa).abs().max()), float((kw - pw).abs().max()))
        print(f"  {name}: max abs err {e:.3g} over {rounds} rounds of "
              f"{ka.shape[0]} × {ids.shape[1]} × {B} updates (each pair's "
              f"Δw, α and w; tolerance {ATOL}); plain version "
              f"{min(pl):.1f} ms a call")
        if not e <= ATOL:
            fail(f"{name} disagrees with its plain version")
        return e, min(pl)

    tasks = {}  # name → (ms, plain ms, bytes, ops, what, err, library ms)
    Y_r8 = pad_labels(classes["rcv1"][1], np_r8)

    def t1(a, w, i):
        return dcd_ell_shards(cols_r8, vals_r8, a, w, q_r8, loss=hinge,
                              idx=i, n_loc=n_loc_r8, y=Y_r8)

    def t1_plain(a, w, i):
        return dcd_ell_shards_plain(cols_r8, vals_r8, a, w, q_r8,
                                    loss=hinge, idx=i, n_loc=n_loc_r8,
                                    y=Y_r8)

    def zeros_t1():
        return (torch.zeros((K_R, np_r8), device=dev),
                torch.zeros((K_R, d_r + 1), device=dev))

    print(f"  B1 task grid at rcv1, K = {K_R}, p = {P_R}: "
          f"{dcd_ell_plan(B, k_r, False, P_R, K_R)}")
    err_t1, plain_t1 = compare_tasks(
        f"B1 dcd_ell_shards staged (rcv1, K = {K_R}, p = {P_R})", t1,
        t1_plain, zeros_t1, ids_r8)
    a_t, w_t = zeros_t1()
    same_bits(f"B1 dcd_ell_shards staged (rcv1, K = {K_R}, p = {P_R})",
              lambda: t1(a_t, w_t, ids_r8[0]), torch)
    ms_t1 = cuda_ms(lambda: t1(a_t, w_t, ids_r8[next(it) % 16]), 20, torch)
    tasks["dcd_ell_tasks"] = (
        ms_t1, plain_t1,
        4 * (2 * K_R * np_r8 + K_R * (1 + P_R) * (d_r + 1))
        + P_R * B * (k_r * 8 + 8) + 4 * K_R * P_R * B,
        4 * K_R * P_R * B * k_r,
        f"rcv1, K = {K_R}, p = {P_R}, {B} ids a pair", err_t1, None,
        "src/repro_torch/kernels/csrc/dcd_ell.cu",
        "src/repro/kernels/dcd_ell.py:51", "staged")
    del a_t, w_t

    Y_c8 = pad_labels(classes["covtype"][1], np_c8)

    def t2(a, w, i):
        return dcd_indexed_shards(X_c8, a, w, q_c8, loss=hinge_c, idx=i,
                                  n_loc=n_loc_c8, y=Y_c8)

    def t2_plain(a, w, i):
        return dcd_indexed_shards_plain(X_c8, a, w, q_c8, loss=hinge_c,
                                        idx=i, n_loc=n_loc_c8, y=Y_c8)

    def zeros_t2():
        return (torch.zeros((K_C, np_c8), device=dev),
                torch.zeros((K_C, d_c), device=dev))

    print(f"  B2 task grid at covtype, K = {K_C}, p = {P_C}: "
          f"{dcd_dense_plan(B, d_c, False, P_C, K_C)}")
    err_t2, plain_t2 = compare_tasks(
        f"B2 dcd_indexed_shards staged (covtype, K = {K_C}, p = {P_C})", t2,
        t2_plain, zeros_t2, ids_c8)
    a_t, w_t = zeros_t2()
    same_bits(f"B2 dcd_indexed_shards staged (covtype, K = {K_C}, p = "
              f"{P_C})", lambda: t2(a_t, w_t, ids_c8[0]), torch)
    ms_t2 = cuda_ms(lambda: t2(a_t, w_t, ids_c8[next(it) % 16]), 50, torch)
    tasks["dcd_indexed_tasks"] = (
        ms_t2, plain_t2,
        4 * (2 * K_C * np_c8 + K_C * (1 + P_C) * d_c)
        + P_C * B * (d_c * 4 + 8) + 4 * K_C * P_C * B,
        4 * K_C * P_C * B * d_c,
        f"covtype, K = {K_C}, p = {P_C}, {B} ids a pair", err_t2, None,
        "src/repro_torch/kernels/csrc/dcd_block.cu",
        "src/repro/kernels/dcd_block.py:100", "staged")
    del a_t, w_t

    # B4 + B5 at the webspam split, K = 4, data = 1: per round B4 over the
    # K × m (task, model) pairs, each task's sum over model, B5 into each
    # task's replica of the slices
    Y_w = classes["webspam"][1]
    wsK = feat.gram_workspace(SHARDS, B, k_loc, d1_w, dev, 1, K_W)
    print(f"  B4 at the webspam split, K = {K_W}: "
          f"{gram_plan(SHARDS, B, k_loc, d1_w, 1, K_W)}; workspace "
          f"{_ws_mb(wsK):.2f} MB")
    ids_t4 = t_ids_w[:, None]  # (rounds, 1, B): one block for every task

    def t45(a, w, i, plain=False):
        if plain:
            b4, g4 = feat.dcd_feature_gram_plain(cols_w, vals_w, w, i,
                                                 tasks=True)
            a5, rep5 = feat.dcd_feature_update_plain(
                cols_w, vals_w, a, q_w, w, i, b4.sum(2), g4.sum(2),
                loss=hinge, y=Y_w)
        else:
            b4, g4 = feat.dcd_feature_gram(cols_w, vals_w, w, i,
                                           workspace=wsK, tasks=True)
            a5, rep5 = feat.dcd_feature_update(
                cols_w, vals_w, a, q_w, w, i, b4.sum(2), g4.sum(2),
                loss=hinge, y=Y_w, workspace=wsK)
        return a5, b4, g4, rep5

    e4 = e5 = 0.0
    (ka, kw), (pa, pw) = [(torch.zeros((K_W, n_w), device=dev),
                           torch.zeros((K_W, SHARDS, d1_w), device=dev))
                          for _ in range(2)]
    for r in range(2):
        ka, kb, kg, krep = t45(ka, kw, ids_t4[r])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pa, pb, pg, prep = t45(pa, pw, ids_t4[r], plain=True)
        torch.cuda.synchronize()
        plain_t45 = (time.perf_counter() - t0) * 1e3
        e4 = max(e4, float((kb - pb).abs().max()),
                 float((kg - pg).abs().max()))
        e5 = max(e5, float((krep - prep).abs().max()))
        kw = kw + (krep - kw[:, None]).sum(1)
        pw = pw + (prep - pw[:, None]).sum(1)
    e5 = max(e5, float((ka - pa).abs().max()), float((kw - pw).abs().max()))
    print(f"  B4 dcd_feature_gram (webspam, K = {K_W}): max abs err "
          f"{e4:.3g} over 2 rounds; B5 dcd_feature_update: {e5:.3g} over "
          f"{2 * K_W * B} updates (tolerance {ATOL}); plain B4 + B5 "
          f"{plain_t45:.1f} ms a round")
    if not (e4 <= ATOL and e5 <= ATOL):
        fail("B4/B5 over tasks disagree with their plain versions")
    w_t = kw
    a_t = torch.zeros((K_W, n_w), device=dev)
    same_bits(f"B4 dcd_feature_gram (webspam, K = {K_W})",
              lambda: feat.dcd_feature_gram(cols_w, vals_w, w_t, ids_t4[0],
                                            workspace=wsK, tasks=True),
              torch)
    b_t, g_t = ops.dcd_feature_gram(cols_w, vals_w, w_t, ids_t4[0],
                                    workspace=wsK, tasks=True)
    same_bits(f"B5 dcd_feature_update (webspam, K = {K_W}, hinge)",
              lambda: feat.dcd_feature_update(
                  cols_w, vals_w, a_t, q_w, w_t, ids_t4[0], b_t, g_t,
                  loss=hinge, y=Y_w, workspace=wsK), torch)
    ms_t4 = cuda_ms(lambda: feat.dcd_feature_gram(
        cols_w, vals_w, w_t, ids_t4[next(it) % 64], workspace=wsK,
        tasks=True), 20, torch)
    ms_t5 = cuda_ms(lambda: feat.dcd_feature_update(
        cols_w, vals_w, a_t, q_w, w_t, ids_t4[0], b_t, g_t, loss=hinge,
        y=Y_w, workspace=wsK), 20, torch)
    plain_t4 = wall_ms(lambda: feat.dcd_feature_gram_plain(
        cols_w, vals_w, w_t, ids_t4[0], tasks=True), 1, torch)
    plain_t5 = wall_ms(lambda: feat.dcd_feature_update_plain(
        cols_w, vals_w, a_t, q_w, w_t, ids_t4[0], b_t, g_t, loss=hinge,
        y=Y_w), 1, torch)
    # the library yardstick as for B4: torch.sparse.mm of each (task,
    # model) pair's block with its transpose
    lib_t4 = cuda_ms(lambda: [torch.sparse.mm(S, St) for _ in range(K_W)
                              for S, St in mats], 10, torch)
    # bytes: the block's rows once (every task reads the same block), w at
    # each real entry and the outputs per task; operations: the Gram once
    # (it depends on the ids alone) and each task's base
    tasks["dcd_feature_gram_tasks"] = (
        ms_t4, plain_t4,
        4 * B * SHARDS * k_loc + 4 * nnz4 + 4 * K_W * nnz4 + 4 * B
        + 4 * K_W * SHARDS * (B + B * B),
        2 * B * nnz4 + K_W * 2 * nnz4,
        f"webspam, K = {K_W}, m = {SHARDS}, {B} ids", e4, lib_t4,
        "src/repro_torch/kernels/csrc/dcd_feature.cu",
        "src/repro/kernels/dcd_feature.py:60", "column-class")
    tasks["dcd_feature_update_tasks"] = (
        ms_t5, plain_t5,
        8 * K_W * n_w + 8 * K_W * SHARDS * d1_w + 4 * B * SHARDS * k_loc
        + 4 * nnz4 + 4 * K_W * B + K_W * (12 * B + 4 * B * B),
        K_W * (2 * nnz4 + B * B),
        f"webspam, K = {K_W}, m = {SHARDS}, {B} ids", e5, None,
        "src/repro_torch/kernels/csrc/dcd_feature.cu",
        "src/repro/kernels/dcd_feature.py:106", "column-class")
    for name, (route_ms, pl_ms, by, ops_n, per, err, lib_ms, src, rep,
               variant) in tasks.items():
        b_ms, b_by = bound(by, ops_n)
        results[name] = dict(name=name, route="cuda", source=src,
                             replaces=rep, variant=variant, launches=0,
                             max_abs_err=err, ms=route_ms, plain_ms=pl_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        lib = ("no library call computes it" if lib_ms is None
               else f"torch.sparse.mm {lib_ms:.4f} ms")
        print(f"  {name} ({per}): {route_ms:.4f} ms per launch, plain "
              f"{pl_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by}), {lib}")
    del krep, prep, a_t, w_t, b_t, g_t

    # ------------------------ the pod grid: P pods of p shards a launch
    # B1, B2, B4 and B5 over the pod solver's grid (Hybrid-DCA): P pods of
    # p data shards, pod k's shards reading pod k's own view of w (a
    # (P, …) w a launch), each pod's rows padded to its own p·n_loc slots
    # as the solver lays them out (``_pod_segments``): rcv1 at (P = 2,
    # p = 4) (B1 staged, 8 CTAs), covtype at (2, 4) (B2 staged; pod 0's
    # two padding rows sit inside the row range) and the webspam split at
    # (2, 1) with m = 4 (B4 over 8 (pod, model) pairs, B5 R × 8 CTAs);
    # held to the plain versions over 2 rounds from α = 0 with hinge and
    # one round each with squared hinge and logistic (each shard's Δw, α
    # and each pod's w, which takes its shards' Δw summed in shard
    # order); a second launch to the same bits; timed behind the spin
    def pod_ids(n, P, p, rounds):
        """(n_loc, the real-row runs, ids (rounds, P·p, B)): each shard's
        B distinct real rows a round, shard-local, drawn from its pod's
        own real-row count."""
        n_pod = max(-(-n // P), 1)
        n_loc = -(-n_pod // p)
        per = []
        for s_ in range(P * p):
            k_, my = divmod(s_, p)
            npv = min(max(n - k_ * n_pod, 0), n_pod)
            v = min(max(npv - my * n_loc, 1), n_loc)
            per.append(torch.stack([
                torch.randperm(v, generator=gen, device=dev)[:B]
                for _ in range(rounds)]))
        return (n_loc, _pod_segments(n, P, p, n_loc),
                torch.stack(per, 1).int().contiguous())

    def compare_pods(name, kernel, plain, state0, ids, P):
        err = 0.0
        for lname, rounds in [("hinge", 2), ("squared_hinge", 1),
                              ("logistic", 1)]:
            loss = duals.make_loss(lname, 0.5 if lname == "logistic" else 1.0)
            (ka, kw), (pa, pw) = state0(), state0()
            e = 0.0
            for r in range(rounds):
                ka, kdw = kernel(ka, kw, ids[r], loss)
                pa, pdw = plain(pa, pw, ids[r], loss)
                e = max(e, float((kdw - pdw).abs().max()))
                kw = kw + kdw.unflatten(0, (P, -1)).sum(1)
                pw = pw + pdw.unflatten(0, (P, -1)).sum(1)
            torch.cuda.synchronize()
            e = max(e, float((ka - pa).abs().max()),
                    float((kw - pw).abs().max()))
            print(f"  {name} {lname}: max abs err {e:.3g} over {rounds} "
                  f"rounds of {ids.shape[1]} × {B} updates (each shard's "
                  f"Δw, α and each pod's w; tolerance {ATOL})")
            if not e <= ATOL:
                fail(f"{name} disagrees with its plain version ({lname})")
            err = max(err, e)
        return err

    pods = {}  # name → (ms, plain ms, bytes, ops, what, err, library ms)
    P_PD = 4  # the 1-D pod paths' data shards a pod (of P_P pods)
    S_P = P_P * P_PD
    n_loc_rp, segs_rp, ids_rp = pod_ids(n_r, P_P, P_PD, 16)
    np_rp = S_P * n_loc_rp
    cols_rp = _place_rows(X_rcv1.indices, np_rp, segs_rp, d_r)
    vals_rp = _place_rows(X_rcv1.values, np_rp, segs_rp, 0.0)
    q_rp = _place_rows(q_r, np_rp, segs_rp, 1.0)

    def p1(a, w, i, L):
        return dcd_ell_shards(cols_rp, vals_rp, a, w, q_rp, loss=L, idx=i,
                              n_loc=n_loc_rp)

    def p1_plain(a, w, i, L):
        return dcd_ell_shards_plain(cols_rp, vals_rp, a, w, q_rp, loss=L,
                                    idx=i, n_loc=n_loc_rp)

    def zeros_rp():
        return (torch.zeros(np_rp, device=dev),
                torch.zeros((P_P, d_r + 1), device=dev))

    print(f"  B1 pod grid at rcv1, P = {P_P}, p = {P_PD}: "
          f"{dcd_ell_plan(B, k_r, False, P_PD, 1, P_P)}; real rows "
          f"{segs_rp}")
    err_p1 = compare_pods(f"B1 dcd_ell_shards staged (rcv1, P = {P_P}, "
                          f"p = {P_PD})", p1, p1_plain, zeros_rp, ids_rp,
                          P_P)
    a_p, w_p1 = zeros_rp()
    same_bits(f"B1 dcd_ell_shards staged (rcv1, P = {P_P}, p = {P_PD})",
              lambda: p1(a_p, w_p1, ids_rp[0], hinge), torch)
    ms_p1 = cuda_ms(lambda: p1(a_p, w_p1, ids_rp[next(it) % 16], hinge),
                    50, torch)
    plain_p1 = wall_ms(lambda: p1_plain(a_p, w_p1, ids_rp[0], hinge), 1,
                       torch)
    pods["dcd_ell_pods"] = (
        ms_p1, plain_p1,
        4 * (2 * np_rp + (P_P + S_P) * (d_r + 1)) + S_P * B * (k_r * 8 + 8),
        4 * S_P * B * k_r, f"rcv1, P = {P_P}, p = {P_PD}, {B} ids a shard",
        err_p1, None, "src/repro_torch/kernels/csrc/dcd_ell.cu",
        "src/repro/kernels/dcd_ell.py:51", "staged")
    del cols_rp, vals_rp, a_p, w_p1

    n_loc_cp, segs_cp, ids_cp = pod_ids(n_c, P_P, P_PD, 16)
    np_cp = S_P * n_loc_cp
    X_cp = _place_rows(X_cov, np_cp, segs_cp, 0.0)
    q_cp = _place_rows(q_c, np_cp, segs_cp, 1.0)

    def p2(a, w, i, L):
        return dcd_indexed_shards(X_cp, a, w, q_cp, loss=L, idx=i,
                                  n_loc=n_loc_cp)

    def p2_plain(a, w, i, L):
        return dcd_indexed_shards_plain(X_cp, a, w, q_cp, loss=L, idx=i,
                                        n_loc=n_loc_cp)

    def zeros_cp():
        return (torch.zeros(np_cp, device=dev),
                torch.zeros((P_P, d_c), device=dev))

    print(f"  B2 pod grid at covtype, P = {P_P}, p = {P_PD}: "
          f"{dcd_dense_plan(B, d_c, False, P_PD, 1, P_P)}; real rows "
          f"{segs_cp}")
    err_p2 = compare_pods(f"B2 dcd_indexed_shards staged (covtype, P = "
                          f"{P_P}, p = {P_PD})", p2, p2_plain, zeros_cp,
                          ids_cp, P_P)
    a_p, w_p2 = zeros_cp()
    same_bits(f"B2 dcd_indexed_shards staged (covtype, P = {P_P}, p = "
              f"{P_PD})", lambda: p2(a_p, w_p2, ids_cp[0], hinge_c), torch)
    ms_p2 = cuda_ms(lambda: p2(a_p, w_p2, ids_cp[next(it) % 16], hinge_c),
                    50, torch)
    plain_p2 = wall_ms(lambda: p2_plain(a_p, w_p2, ids_cp[0], hinge_c), 1,
                       torch)
    pods["dcd_indexed_pods"] = (
        ms_p2, plain_p2,
        4 * (2 * np_cp + (P_P + S_P) * d_c) + S_P * B * (d_c * 4 + 8),
        4 * S_P * B * d_c, f"covtype, P = {P_P}, p = {P_PD}, {B} ids a "
        "shard", err_p2, None, "src/repro_torch/kernels/csrc/dcd_block.cu",
        "src/repro/kernels/dcd_block.py:100", "staged")
    del X_cp, a_p, w_p2

    # B4 + B5 at the webspam split, (pod = 2, data = 1), m = 4: n = 280,000
    # splits into two pods of 140,000 rows, no padding; per round B4 over
    # the 2 × 4 (pod, model) pairs against each pod's view, the sum over
    # model per pod, B5 into each pod's replica of the slices
    n_loc_wp, segs_wp, ids_wp = pod_ids(n_w, P_P, 1, 8)
    wsP = feat.gram_workspace(SHARDS, B, k_loc, d1_w, dev, P_P)
    print(f"  B4 at the webspam split, P = {P_P}: "
          f"{gram_plan(SHARDS, B, k_loc, d1_w, 1, 1, P_P)}; real rows "
          f"{segs_wp}")

    def state_wp():
        a, w = state_w()
        return a, torch.stack([w, w + 1e-3 * (w != 0)])  # a view a pod

    err_p4 = err_p5 = 0.0
    for lname, rounds in [("hinge", 2), ("squared_hinge", 1),
                          ("logistic", 1)]:
        loss = duals.make_loss(lname, 0.5 if lname == "logistic" else 1.0)
        ka, kw = pa, pw = state_wp()
        e4 = e5 = 0.0
        for r in range(rounds):
            kb, kg = feat.dcd_feature_gram(cols_w, vals_w, kw, ids_wp[r],
                                           workspace=wsP, n_loc=n_loc_wp)
            pb, pg = feat.dcd_feature_gram_plain(cols_w, vals_w, pw,
                                                 ids_wp[r], n_loc_wp)
            e4 = max(e4, float((kb - pb).abs().max()),
                     float((kg - pg).abs().max()))
            ka, krep = feat.dcd_feature_update(
                cols_w, vals_w, ka, q_w, kw, ids_wp[r], kb.sum(1), kg.sum(1),
                loss=loss, workspace=wsP, n_loc=n_loc_wp)
            pa, prep = feat.dcd_feature_update_plain(
                cols_w, vals_w, pa, q_w, pw, ids_wp[r], pb.sum(1), pg.sum(1),
                loss=loss, n_loc=n_loc_wp)
            e5 = max(e5, float((krep - prep).abs().max()))
            kw, pw = krep, prep  # one data shard a pod: its replica
        torch.cuda.synchronize()
        e5 = max(e5, float((ka - pa).abs().max()),
                 float((kw - pw).abs().max()))
        print(f"  B4 dcd_feature_gram P = {P_P} {lname}: max abs err "
              f"{e4:.3g} over {rounds} rounds; B5 dcd_feature_update: "
              f"{e5:.3g} over {rounds * P_P * B} updates (tolerance {ATOL})")
        if not (e4 <= ATOL and e5 <= ATOL):
            fail(f"B4/B5 over pods disagree with their plain versions "
                 f"({lname})")
        err_p4, err_p5 = max(err_p4, e4), max(err_p5, e5)
    w_same = state_wp()[1]
    same_bits(f"B4 dcd_feature_gram (webspam, P = {P_P})",
              lambda: feat.dcd_feature_gram(cols_w, vals_w, w_same,
                                            ids_wp[0], workspace=wsP,
                                            n_loc=n_loc_wp), torch)
    b_p, g_p = ops.dcd_feature_gram(cols_w, vals_w, w_same, ids_wp[0],
                                    workspace=wsP, n_loc=n_loc_wp)
    a_same = torch.zeros(n_w, device=dev)
    same_bits(f"B5 dcd_feature_update (webspam, P = {P_P}, hinge)",
              lambda: feat.dcd_feature_update(
                  cols_w, vals_w, a_same, q_w, w_same, ids_wp[0], b_p, g_p,
                  loss=hinge, workspace=wsP, n_loc=n_loc_wp),
              torch)
    ms_p4 = cuda_ms(lambda: feat.dcd_feature_gram(
        cols_w, vals_w, w_same, ids_wp[next(it) % 8], workspace=wsP,
        n_loc=n_loc_wp), 50, torch)
    ms_p5 = cuda_ms(lambda: feat.dcd_feature_update(
        cols_w, vals_w, a_same, q_w, w_same, ids_wp[0], b_p, g_p, loss=hinge,
        workspace=wsP, n_loc=n_loc_wp), 50, torch)
    plain_p4 = wall_ms(lambda: feat.dcd_feature_gram_plain(
        cols_w, vals_w, w_same, ids_wp[0], n_loc_wp), 1, torch)
    plain_p5 = wall_ms(lambda: feat.dcd_feature_update_plain(
        cols_w, vals_w, a_same, q_w, w_same, ids_wp[0], b_p, g_p, loss=hinge,
        n_loc=n_loc_wp), 1, torch)
    mats_p = [sparse_block(j, ids_wp[0][s_] + s_ * n_loc_wp)
              for s_ in range(P_P) for j in range(SHARDS)]
    lib_p4 = cuda_ms(lambda: [torch.sparse.mm(S, St) for S, St in mats_p],
                     20, torch)
    rows_p = (ids_wp[0].long()
              + n_loc_wp * torch.arange(P_P, device=dev)[:, None]).reshape(-1)
    nnz_p = int((cols_w[rows_p] < d_loc).sum())
    pods["dcd_feature_gram_pods"] = (
        ms_p4, plain_p4,
        4 * P_P * B * SHARDS * k_loc + 8 * nnz_p + 4 * P_P * B
        + 4 * P_P * SHARDS * (B + B * B),
        2 * B * nnz_p + 2 * nnz_p, f"webspam, P = {P_P}, data = 1, m = "
        f"{SHARDS}, {B} ids a pod", err_p4, lib_p4,
        "src/repro_torch/kernels/csrc/dcd_feature.cu",
        "src/repro/kernels/dcd_feature.py:60", "column-class")
    pods["dcd_feature_update_pods"] = (
        ms_p5, plain_p5,
        8 * n_w + 8 * P_P * SHARDS * d1_w + 4 * P_P * B * SHARDS * k_loc
        + 4 * nnz_p + P_P * (12 * B + 4 * B * B),
        2 * nnz_p + P_P * B * B, f"webspam, P = {P_P}, data = 1, m = "
        f"{SHARDS}, {B} ids a pod", err_p5, None,
        "src/repro_torch/kernels/csrc/dcd_feature.cu",
        "src/repro/kernels/dcd_feature.py:106", "column-class")
    for name, (route_ms, pl_ms, by, ops_n, per, err, lib_ms, src, rep,
               variant) in pods.items():
        b_ms, b_by = bound(by, ops_n)
        results[name] = dict(name=name, route="cuda", source=src,
                             replaces=rep, variant=variant, launches=0,
                             max_abs_err=err, ms=route_ms, plain_ms=pl_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        lib = ("no library call computes it" if lib_ms is None
               else f"torch.sparse.mm {lib_ms:.4f} ms")
        print(f"  {name} ({per}): {route_ms:.4f} ms per launch, plain "
              f"{pl_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by}), {lib}")
    print(f"  pod-grid launches per epoch: rcv1 (2, 4) "
          f"{_n_blocks(n_loc_rp, B)}, covtype (2, 4) "
          f"{_n_blocks(n_loc_cp, B)}, webspam (2, 1, 4) "
          f"{_n_blocks(n_loc_wp, B)} (B4 and B5 each)")
    del wsP, mats_p, b_p, g_p, krep, prep

    # ------------------------- the baselines' wide launches, at full shape
    # cocoa_solve's outer round on covtype (8 partitions: one launch of B2's
    # wide variant over 8 CTAs, each a partition's whole local epoch of
    # n // 8 ids against the shared w), and cocoa_pod_solve's epoch on
    # rcv1's first PASSCODE_ROWS rows (P = 2: one launch of B1's wide
    # variant over 2 CTAs, each a pod's drawn block sequence).  Each is the
    # first round of its solve, laid out and drawn as the solve does it
    # (the reference's key chain), held to its plain version on the same
    # inputs from α = 0 with the main path's loss over the whole round (the
    # plain version replayed on CPU copies of the inputs, and timed on the
    # card over each CTA's first PLAIN_IDS / CTAs ids) and with the other
    # two losses over each CTA's first PREFIX ids; its second launch to the
    # same bits, and timed
    wide_rounds = {}
    for name, shards, plain, rows, q, n_loc, ids, state0, loss, what in [
            ("dcd_indexed_cocoa", dcd_indexed_shards,
             dcd_indexed_shards_plain, (X_co,), q_co, n_k, ids_co, zeros_co,
             hinge_c, f"covtype, CoCoA's round: {K_CO} partitions of {n_k} "
             "ids"),
            ("dcd_ell_cocoa_pods", dcd_ell_shards, dcd_ell_shards_plain,
             rows_o, q_o, n_pod_o, ids_o, zeros_o, hinge,
             f"rcv1's first {n_o} rows, cocoa_pod_solve's epoch: {P_P} pods "
             f"of {ids_o.shape[1]} ids")]:
        kern, pl = co_round(shards, rows, q, n_loc), co_round(plain, rows, q,
                                                              n_loc)
        label = f"{name} (wide, {what})"
        p, host_s = replayed[name]
        e = max_err(kern(*state0(), ids, loss), p)
        head = ids[:, :PLAIN_IDS // ids.shape[0]].contiguous()
        pl_ms = wall_ms(lambda: pl(*state0(), head, loss), 1, torch)
        print(f"  {label} hinge: max abs err {e:.3g} over the whole round, "
              f"{ids.numel()} updates (α and w; tolerance {ATOL}); plain "
              f"version on the host {host_s:.1f} s, on the card "
              f"{pl_ms:.1f} ms over each CTA's first {head.shape[1]} ids")
        if not e <= ATOL:
            fail(f"{label} disagrees with its plain version")
        e = max(e, compare(f"{label}, each CTA's first {PREFIX} ids", kern,
                           pl, state0, ids[None, :, :PREFIX], losses[1:]))
        a0, w0 = state0()
        same_bits(f"{label} hinge", lambda: kern(a0, w0, ids, loss), torch)
        ms = cuda_ms(lambda: kern(a0, w0, ids, loss), 2, torch)
        wide_rounds[name] = (ms, pl_ms, e, ids.numel(), head.numel(),
                             host_s * 1e3)
    # bytes: α and w in and out a CTA, each id's row, q and id once;
    # operations: a multiply-add per row entry for the dot and the axpy
    for name, by, ops_n, src, rep in [
            ("dcd_indexed_cocoa",
             4 * (2 * n_k * K_CO + 2 * K_CO * d_c)
             + n_k * K_CO * (d_c * 4 + 8), 4 * n_k * K_CO * d_c,
             "src/repro_torch/kernels/csrc/dcd_block.cu",
             "src/repro/kernels/dcd_block.py:100"),
            ("dcd_ell_cocoa_pods",
             4 * (2 * P_P * n_pod_o + 2 * P_P * (d_r + 1))
             + ids_o.numel() * (k_r * 8 + 8), 4 * ids_o.numel() * k_r,
             "src/repro_torch/kernels/csrc/dcd_ell.cu",
             "src/repro/kernels/dcd_ell.py:51")]:
        ms, pl_ms, err, n_ids, n_plain, host_ms = wide_rounds[name]
        b_ms, b_by = bound(by, ops_n)
        results[name] = dict(name=name, route="cuda", source=src,
                             replaces=rep, variant="wide", launches=0,
                             max_abs_err=err, ms=ms, plain_ms=pl_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=None,
                             ids=n_ids, plain_ids=n_plain,
                             plain_host_ms=host_ms)
        print(f"  {name} (wide, {n_ids} ids a launch): {ms:.4f} ms per "
              f"launch, plain {pl_ms:.1f} ms over {n_plain} ids, bound "
              f"{b_ms:.6f} ms ({b_by}), no library call computes it")
    del X_co, q_co, ids_co, rows_o, q_o, ids_o

    # where a round's time goes: 20 rounds of the solver's fused 2-D
    # engine on webspam (B4, the sum over shards, B5, the Δw round trip)
    # and of its 1-D engine on rcv1 and covtype (B1/B2 and the wrapper's
    # copies, Δw and w + Δw), each at p = 1 and over the p > 1 shard
    # grid, under torch.profiler; the rounds' ids are (p, B), as the
    # solver hands them
    def profile(label, engine, a, w, rounds, tasks=False):
        if not tasks:
            a, w = a[None], w[None]  # the solver's state: one task
        _scan_rounds(engine, a, w, torch.zeros_like(w), rounds[:2], 0)
        profile_rounds(label, lambda: _scan_rounds(
            engine, a, w, torch.zeros_like(w), rounds[:20], 0),
            min(20, rounds.shape[0]), torch)

    w_p = torch.zeros_like(w_w)
    profile("webspam (2-D, fused)", functools.partial(
        _block_update_2d(hinge, True, ws), cols_w, vals_w, q_w), a_w, w_p,
        t_ids_w[:, None])
    profile(f"webspam (2-D, fused, data = {P_D})", functools.partial(
        _block_update_2d(hinge, True, ws2, n_loc_d), cols_w, vals_w, q_w),
        a_w, w_p, ids_d)
    profile("rcv1 (1-D, B1 staged)", functools.partial(
        _block_update_1d(hinge, True), (X_rcv1.indices, X_rcv1.values), q_r),
        *zeros_r(), t_ids[:, None])
    profile(f"rcv1 (1-D, B1 staged, p = {P_R})", functools.partial(
        _block_update_1d(hinge, True, n_loc_r8), (cols_r8, vals_r8), q_r8),
        *zeros_r8(), ids_r8)
    profile("covtype (1-D, B2 staged)", functools.partial(
        _block_update_1d(hinge_c, False), X_cov, q_c), *zeros_c(),
        c_ids[:, None])
    profile(f"covtype (1-D, B2 staged, p = {P_C})", functools.partial(
        _block_update_1d(hinge_c, False, n_loc_c8), X_c8, q_c8),
        *zeros_c8(), ids_c8)
    # and the multi-task rounds: the task grid over the K tasks' state
    profile(f"rcv1 (1-D, B1 staged, K = {K_R}, p = {P_R})", functools.partial(
        _block_update_1d(hinge, True, n_loc_r8, Y_r8), (cols_r8, vals_r8),
        q_r8), *zeros_t1(), ids_r8, tasks=True)
    profile(f"covtype (1-D, B2 staged, K = {K_C}, p = {P_C})",
            functools.partial(_block_update_1d(hinge_c, False, n_loc_c8,
                                               Y_c8), X_c8, q_c8),
            *zeros_t2(), ids_c8, tasks=True)
    profile(f"webspam (2-D, fused, K = {K_W})", functools.partial(
        _block_update_2d(hinge, True, wsK, 0, Y_w), cols_w, vals_w, q_w),
        torch.zeros((K_W, n_w), device=dev),
        torch.zeros((K_W, SHARDS, d1_w), device=dev), t_ids_w[:, None],
        tasks=True)
    del wsK
    del fse, cols_w, vals_w, q_w, ws, ws2, mats, a_w, w_w, ka, kw, pa, pw
    del w_p, w_same, a_w1, w_w1, a_same, b_same, g_same, a_l
    del cols_r8, vals_r8, X_c8
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

    # p > 1 data shards and the self-tuning: the shard-grid kernels on the
    # card against the same solves' CPU paths (their plain versions; the
    # fused 2-D engine on both), at the CPU tests' tolerances: α and ŵ at
    # atol 1e-5, the gaps at 1e-5 + 1e-6·M (M = ‖w(α)‖² + Σ|ℓ| + Σ|ℓ*| in
    # float64), the active and delay records equal
    def gap_tol(Xs, alpha, loss):
        X64 = (EllMatrix(Xs.indices, Xs.values.double(), Xs.n_features)
               if isinstance(Xs, EllMatrix) else Xs.double())
        a = alpha.double()
        wa = w_of_alpha(X64, a)
        z = (torch.sum(wa[X64.indices.long()] * X64.values, 1)
             if isinstance(X64, EllMatrix) else X64 @ wa)
        return ATOL + 1e-6 * float(torch.dot(wa, wa)
                                   + loss.primal_loss(z).abs().sum()
                                   + loss.conj(a).abs().sum())

    for label, Xs, kw in [
            ("ELL, p = 2", small.X_train, dict(mesh=solver_mesh(n_devices=2))),
            ("dense, p = 8", small.dense_train(),
             dict(mesh=solver_mesh(n_devices=8))),
            ("ELL, p = 8, delay 1", small.X_train,
             dict(mesh=solver_mesh(n_devices=8), delay_rounds=1)),
            ("2-D data = 2, m = 2, overlapped", small.X_train,
             dict(mesh=solver_mesh_2d(data=2, model=2), delay_rounds=1)),
            ("ELL, p = 8, shrinking and repacking", small.X_train,
             dict(mesh=solver_mesh(n_devices=8), shrink_every=1,
                  repack=True)),
            ("2-D data = 2, m = 2, shrinking", small.X_train,
             dict(mesh=solver_mesh_2d(data=2, model=2), shrink_every=1)),
            # the adaptive delay's latch moves here: flags 1, 1, 0, 0
            ("ELL, p = 4, adaptive ratio 0.5 from delay 1", small.X_train,
             dict(mesh=solver_mesh(n_devices=4), delay_rounds=1,
                  adaptive=True, adaptive_ratio=0.5))]:
        kw.update(epochs=4, block_size=16, seed=2)
        on_card = sharded_passcode_solve(Xs.to(dev), hinge, device=dev, **kw)
        on_cpu = sharded_passcode_solve(Xs, hinge, device="cpu",
                                        use_kernel=True, **kw)
        e = max(float((on_card.alpha.cpu() - on_cpu.alpha).abs().max()),
                float((on_card.w_hat.cpu() - on_cpu.w_hat).abs().max()))
        eg = float((on_card.gaps.cpu() - on_cpu.gaps).abs().max())
        tol = gap_tol(Xs, on_cpu.alpha, hinge)
        same = (torch.equal(on_card.active.cpu(), on_cpu.active)
                and torch.equal(on_card.delay.cpu(), on_cpu.delay))
        print(f"  solver {label} kernel path vs CPU path: max abs err "
              f"{e:.3g} (tolerance {ATOL}), gaps {eg:.3g} (tolerance "
              f"{tol:.3g}), active {on_card.active.tolist()} and delay "
              f"records equal: {same}")
        if not (e <= ATOL and eg <= tol and same):
            fail(f"the solver's {label} kernel path disagrees with its CPU "
                 "path")
        if kw.get("adaptive") and not (on_card.delay[0] == 1
                                       and on_card.delay[-1] == 0):
            fail(f"the solver's {label}: the delay flag did not latch to 0 "
                 f"({on_card.delay.tolist()})")

    # the multi-task solve (K = 3 one-vs-rest classes of tiny's rows) on
    # the card, the task-grid kernels, against its CPU path, the plain
    # versions: α and ŵ at atol 1e-5, each task's gaps at 1e-5 + 1e-6·M,
    # each task's active, delay and round-count records equal.  With
    # shrinking, a row whose α lands on the box in one float32 summation
    # order and a rounding short of it in another flips the mask and the
    # solves part (ROADMAP C.6): where the card parts from the CPU path on
    # the same rows, it is held to the CPU path on the same rows dense
    # (the other summation order), which must then part from the first
    y3 = ovr_labels(torch.arange(small.X_train.n_rows) * 7 % 3, 3,
                    device="cpu")

    def tiny_gap_err(a, b, Xs, alpha):
        return max(float((a.gaps[k].cpu() - b.gaps[k]).abs().max())
                   - gap_tol(EllMatrix(Xs.indices,
                                       Xs.values * y3[k][:, None],
                                       Xs.n_features)
                             if isinstance(Xs, EllMatrix)
                             else Xs * y3[k][:, None], alpha[k], hinge)
                   for k in range(3))

    for label, Xs, kw in [
            ("ELL, p = 2, shrinking and repacking", small.X_train,
             dict(mesh=solver_mesh(n_devices=2), shrink_every=1,
                  repack=True, repack_threshold=0.9)),
            ("dense, p = 4, adaptive ratio 0.5 from delay 1",
             small.dense_train(), dict(mesh=solver_mesh(n_devices=4),
                                       delay_rounds=1, adaptive=True,
                                       adaptive_ratio=0.5)),
            ("2-D data = 2, m = 2, overlapped", small.X_train,
             dict(mesh=solver_mesh_2d(data=2, model=2), delay_rounds=1))]:
        kw.update(epochs=4, block_size=16, seed=2, y=y3)
        on_card = sharded_passcode_solve(Xs.to(dev), hinge, device=dev,
                                         **{**kw, "y": y3.to(dev)})
        card_rounds = list(sharded_passcode_solve.task_rounds)
        orders = [("the CPU path", Xs)]
        if kw.get("shrink_every"):
            orders.append(("the CPU path on the rows dense",
                           small.dense_train()))
        for what, Xc in orders:
            on_cpu = sharded_passcode_solve(Xc, hinge, device="cpu",
                                            use_kernel=True, **kw)
            e = max(float((on_card.alpha.cpu() - on_cpu.alpha).abs().max()),
                    float((on_card.w_hat.cpu() - on_cpu.w_hat).abs().max()))
            eg = tiny_gap_err(on_card, on_cpu, Xs, on_cpu.alpha)
            same = (torch.equal(on_card.active.cpu(), on_cpu.active)
                    and torch.equal(on_card.delay.cpu(), on_cpu.delay)
                    and card_rounds == sharded_passcode_solve.task_rounds)
            print(f"  multi-task K = 3 {label} kernel path vs {what}: max "
                  f"abs err {e:.3g} (tolerance {ATOL}), gaps within their "
                  f"tolerance by {-eg:.3g}, per-task active, delay and "
                  f"round records equal: {same} (rounds {card_rounds})")
            if e <= ATOL and eg <= 0.0 and same:
                break
            if len(orders) == 1:
                fail(f"the multi-task {label} kernel path disagrees with "
                     "its CPU path")
            first = on_cpu
        else:
            fail(f"the multi-task {label} kernel path agrees with neither "
                 "summation order's CPU path")
        if what != orders[0][0]:
            part = float((first.alpha - on_cpu.alpha).abs().max())
            print(f"    the CPU's two summation orders part by {part:.3g} "
                  "on α: a mask flipped at the box (ROADMAP C.6)")
            if not part > ATOL:
                fail(f"the multi-task {label}: the card parts from the CPU "
                     "path while the CPU's two orders agree")

    # p = 1 keeps the bits of the single-block round it had before the
    # shard grid: one epoch of the solver (its round a grid of one shard,
    # w + that shard's Δw) against the same explicit schedule run through
    # the single-block wrapper that round called before (B1/B2 updating a
    # copy of w, then w + (w_new − w)), α and ŵ equal bit for bit, at
    # rcv1 (B1 staged), covtype (B2 staged) and webspam's rows (B1 wide).
    # The solver's gap takes w(α) through index_add_ (atomics in no fixed
    # order), so it is evaluated twice on the same α to show its own
    # spread from run to run.
    from repro_torch.core.sharded import _gap_closure

    def p1_bits(label, X, loss, kernel, rows, q, n, d, w_len):
        nb = _n_blocks(n, B)
        order = torch.randperm(n, generator=gen, device=dev)
        sched = order[torch.arange(nb * B, device=dev) % n].int()
        sched = sched.reshape(1, nb, B)
        t0 = time.perf_counter()
        r = sharded_passcode_solve(X, loss, epochs=1, block_size=B,
                                   blocks=sched, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        a, w = torch.zeros(n, device=dev), torch.zeros(w_len, device=dev)
        for blk in sched[0]:
            a, w_new = kernel(*rows, a, w, q, loss=loss, idx=blk)
            w = w + (w_new - w)
        torch.cuda.synchronize()
        same = torch.equal(r.alpha, a) and torch.equal(r.w_hat, w[:d])
        ell = len(rows) == 2
        gap = _gap_closure(loss, rows if ell else rows[0], ell=ell)
        g1, g2 = (float(gap(a, w)[0]) for _ in range(2))
        print(f"  p = 1 {label}: one epoch ({nb} rounds) through the shard "
              f"grid in {t1 - t0:.3f} s and through the single-block "
              f"wrapper in {time.perf_counter() - t1:.3f} s: α and ŵ "
              f"bit-identical: {same}; the gap of that α evaluated twice: "
              f"{g1!r}, {g2!r}")
        if not same:
            fail(f"p = 1 {label}: the shard-grid round changed the bits of "
                 "the single-block round")

    p1_bits("rcv1 (B1 staged)", X_rcv1, hinge, dcd_ell_epoch,
            (X_rcv1.indices, X_rcv1.values), q_r, n_r, d_r, d_r + 1)
    p1_bits("covtype (B2 staged)", X_cov, hinge_c, dcd_indexed_epoch,
            (X_cov,), q_c, n_c, d_c, d_c)
    p1_bits("webspam rows (B1 wide)", X_web, hinge, dcd_ell_epoch,
            (X_web.indices, X_web.values), q_w1, n_w1, d_w1, d_w1 + 1)

    # ---- B4 and B5 past 1,024 ids, their rows layout: the shim's one
    # block of all SHIM_ROWS rows of rcv1's first rows, split into m =
    # SHARDS feature shards; B5 of each loss fed the plain version's
    # (base, G) on both sides, so each kernel is held on its own
    t0 = time.perf_counter()
    X_shim = EllMatrix(X_rcv1.indices[:SHIM_ROWS].contiguous(),
                       X_rcv1.values[:SHIM_ROWS].contiguous(), d_r)
    fs = ell_column_split(X_shim, SHARDS)
    cols_s, vals_s, q_s = fs.indices, fs.values, fs.row_sq_norms()
    k_s, d_loc_s = fs.k_loc, fs.d_loc
    d1_s, Bs = d_loc_s + 1, SHIM_ROWS
    ids_s = torch.randperm(Bs, generator=gen, device=dev).int()
    ws_s = feat.gram_workspace(SHARDS, Bs, k_s, d1_s, dev)
    print(f"  B4 past 1,024 ids (rcv1's first {Bs} rows, m = {SHARDS}, "
          f"k_loc {k_s}): {gram_plan(SHARDS, Bs, k_s, d1_s)}")
    print(f"  B5 past 1,024 ids: {feature_update_plan(SHARDS, Bs, k_s, d1_s)}")
    w_s = torch.randn((SHARDS, d1_s), generator=gen, device=dev) * 1e-3
    w_s[:, d_loc_s] = 0.0
    kb_s, kg_s = feat.dcd_feature_gram(cols_s, vals_s, w_s, ids_s,
                                       workspace=ws_s)
    pb_s, pg_s = feat.dcd_feature_gram_plain(cols_s, vals_s, w_s, ids_s)
    torch.cuda.synchronize()
    err_b4r = max(float((kb_s - pb_s).abs().max()),
                  float((kg_s - pg_s).abs().max()))
    print(f"  B4 rows layout: max abs err {err_b4r:.3g} over G "
          f"({SHARDS} × {Bs} × {Bs}) and base (tolerance {ATOL})")
    base_s, gram_s = pb_s.sum(0), pg_s.sum(0)
    err_b5r = 0.0
    for lname in ("hinge", "squared_hinge", "logistic"):
        loss = duals.make_loss(lname, 1.0)
        a0 = torch.full((Bs,), 0.25 if lname == "logistic" else 0.0,
                        device=dev)
        ka, kwv = feat.dcd_feature_update(cols_s, vals_s, a0, q_s, w_s,
                                          ids_s, base_s, gram_s, loss=loss,
                                          workspace=ws_s)
        pa, pwv = feat.dcd_feature_update_plain(cols_s, vals_s, a0, q_s,
                                                w_s, ids_s, base_s, gram_s,
                                                loss=loss)
        torch.cuda.synchronize()
        e5 = max(float((ka - pa).abs().max()), float((kwv - pwv).abs().max()))
        print(f"  B5 rows layout {lname}: max abs err {e5:.3g} over {Bs} "
              f"updates (tolerance {ATOL})")
        err_b5r = max(err_b5r, e5)
    if not (err_b4r <= ATOL and err_b5r <= ATOL):
        fail("B4/B5 past 1,024 ids disagree with their plain versions")
    same_bits("B4 dcd_feature_gram rows layout",
              lambda: feat.dcd_feature_gram(cols_s, vals_s, w_s, ids_s,
                                            workspace=ws_s), torch)
    a_s0 = torch.zeros(Bs, device=dev)
    same_bits("B5 dcd_feature_update rows layout (hinge)",
              lambda: feat.dcd_feature_update(
                  cols_s, vals_s, a_s0, q_s, w_s, ids_s, base_s, gram_s,
                  loss=hinge, workspace=ws_s), torch)
    ms_b4r = cuda_ms(lambda: feat.dcd_feature_gram(
        cols_s, vals_s, w_s, ids_s, workspace=ws_s), 5, torch)
    ms_b5r = cuda_ms(lambda: feat.dcd_feature_update(
        cols_s, vals_s, a_s0, q_s, w_s, ids_s, base_s, gram_s, loss=hinge,
        workspace=ws_s), 5, torch)
    plain_b4r = wall_ms(lambda: feat.dcd_feature_gram_plain(
        cols_s, vals_s, w_s, ids_s), 1, torch)
    plain_b5r = wall_ms(lambda: feat.dcd_feature_update_plain(
        cols_s, vals_s, a_s0, q_s, w_s, ids_s, base_s, gram_s, loss=hinge),
        1, torch)
    # the library yardstick: each shard's block as a (B, d_loc + 1) sparse
    # matrix times its transpose, built outside the timed region
    real_s = cols_s[ids_s.long()] < d_loc_s  # (B, m, k)
    mats_s = []
    for j in range(SHARDS):
        c, v, r = cols_s[ids_s.long(), j], vals_s[ids_s.long(), j], \
            real_s[:, j]
        rows = torch.arange(Bs, device=dev)[:, None].expand_as(c)[r]
        cr = c[r].long()
        mats_s.append((torch.sparse_coo_tensor(
            torch.stack([rows, cr]), v[r], (Bs, d1_s)).coalesce(),
            torch.sparse_coo_tensor(torch.stack([cr, rows]), v[r],
                                    (d1_s, Bs)).coalesce()))
    lib_b4r = cuda_ms(lambda: [torch.sparse.mm(S, St) for S, St in mats_s],
                      5, torch)
    # this block's work: each shard's column counts L give Σ L² products
    # of G, the scatter and base its nnz real entries
    nnz_s = int(real_s.sum())
    flat_s = (cols_s[ids_s.long()].long()
              + d1_s * torch.arange(SHARDS, device=dev)[:, None])[real_s]
    pairs_s = int((torch.bincount(flat_s).long() ** 2).sum())
    by_b4r = (4 * Bs * SHARDS * k_s + 8 * nnz_s + 4 * Bs
              + 4 * SHARDS * (Bs + Bs * Bs))
    by_b5r = (8 * Bs + 8 * SHARDS * d1_s + 4 * Bs * SHARDS * k_s
              + 4 * nnz_s + 12 * Bs + 4 * Bs * Bs)
    for name, route_ms, pl_ms, lib_ms, by, ops_n, err, rep in [
        ("dcd_feature_gram_rows", ms_b4r, plain_b4r, lib_b4r, by_b4r,
         2 * pairs_s + 2 * nnz_s, err_b4r,
         "src/repro/kernels/dcd_feature.py:60"),
        ("dcd_feature_update_rows", ms_b5r, plain_b5r, None, by_b5r,
         2 * nnz_s + Bs * (Bs - 1), err_b5r,
         "src/repro/kernels/dcd_feature.py:106"),
    ]:
        b_ms, b_by = bound(by, ops_n)
        results[name] = dict(name=name, route="cuda",
                             source="src/repro_torch/kernels/csrc/"
                                    "dcd_feature.cu",
                             replaces=rep, variant="rows", launches=0,
                             max_abs_err=err, ms=route_ms, plain_ms=pl_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms)
        lib = ("no library call computes it" if lib_ms is None
               else f"torch.sparse.mm {lib_ms:.4f} ms")
        print(f"  {name} (rcv1's first {Bs} rows, m = {SHARDS}, one block "
              f"of {Bs} ids): {route_ms:.4f} ms per launch, plain "
              f"{pl_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by}), {lib}")
    del kb_s, kg_s, pb_s, pg_s, mats_s
    print(f"  B4/B5 past 1,024 ids: {time.perf_counter() - t0:.1f} s")

    print(f"  [kernel phase done at {time.perf_counter() - t_start:.0f} s]")

    # ----------------------------------------------------- 4. main paths
    # each kernel's launch count; B1's, B2's and B3's two variants count
    # apart, and B1's and B2's shard-grid wrappers (the solver's round, at
    # p = 1 a grid of one CTA, whose launches add to the p = 1 rows
    # "dcd_ell", "dcd_ell_wide" and "dcd_indexed") apart from the
    # single-block ones (serial DCD and Lock launch their wide variant
    # over a whole epoch, the rows "dcd_ell_epoch" and
    # "dcd_indexed_epoch")
    counters = {"dcd_ell_epoch_staged": (dcd_ell_epoch, "staged"),
                "dcd_ell_epoch": (dcd_ell_epoch, "wide"),
                "dcd_ell_shards": (dcd_ell_shards, "staged"),
                "dcd_ell_shards_wide": (dcd_ell_shards, "wide"),
                "dcd_indexed_epoch_staged": (dcd_indexed_epoch, "staged"),
                "dcd_indexed_epoch": (dcd_indexed_epoch, "wide"),
                "dcd_indexed_shards": (dcd_indexed_shards, "staged"),
                "dcd_indexed_shards_wide": (dcd_indexed_shards, "wide"),
                "dcd_tile": (dcd_tile_epoch, "stream"),
                "dcd_tile_wide": (dcd_tile_epoch, "wide"),
                "dcd_feature_gram": (feat.dcd_feature_gram, None),
                "dcd_feature_update": (feat.dcd_feature_update, None),
                # the launches of a grid with more than one task
                "dcd_ell_tasks": (dcd_ell_shards, "tasks"),
                "dcd_indexed_tasks": (dcd_indexed_shards, "tasks"),
                "dcd_feature_gram_tasks": (feat.dcd_feature_gram, "tasks"),
                "dcd_feature_update_tasks": (feat.dcd_feature_update,
                                             "tasks"),
                # the launches of a grid of pods of p > 1 data shards
                # (a view of w a pod, read from w's shape)
                "dcd_ell_pods": (dcd_ell_shards, "pods"),
                "dcd_indexed_pods": (dcd_indexed_shards, "pods"),
                "dcd_feature_gram_pods": (feat.dcd_feature_gram, "pods"),
                "dcd_feature_update_pods": (feat.dcd_feature_update,
                                            "pods"),
                # the launches of a block past 1,024 ids (the rows layout)
                "dcd_feature_gram_rows": (feat.dcd_feature_gram, "rows"),
                "dcd_feature_update_rows": (feat.dcd_feature_update,
                                            "rows")}

    # every plain version counts its calls from here on: a main path on
    # the card calls none (the wrappers take them only for CPU tensors)
    from repro_torch.kernels import dcd_block as b_mod, dcd_ell as e_mod
    plain_calls = {"n": 0}

    def counted(f):
        @functools.wraps(f)
        def call(*a, **k):
            plain_calls["n"] += 1
            return f(*a, **k)
        return call

    for mod, names in [(e_mod, ("dcd_ell_epoch_plain",
                                "dcd_ell_shards_plain")),
                       (b_mod, ("dcd_indexed_epoch_plain",
                                "dcd_indexed_shards_plain",
                                "dcd_tile_epoch_plain")),
                       (feat, ("dcd_feature_gram_plain",
                               "dcd_feature_update_plain"))]:
        for name in names:
            setattr(mod, name, counted(getattr(mod, name)))

    def launches(f, variant):
        if variant == "tasks":
            return f.task_launches
        if variant == "pods":
            return f.pod_launches
        if variant == "rows":
            return f.rows_launches
        return f.variant_launches[variant] if variant else f.launches

    def run_path(label, want, fn, rows=None, count=True):
        """Run one main path with every launch count set to 0 just before
        it; read the counts just after and hold them to ``want`` (every
        other kernel: 0 launches; a callable ``want`` is asked after the
        run, for a path whose rounds depend on its data).  Each count adds
        to its kernel's row of the JSON line, ``rows[name]`` where the
        path launches the kernel at a shape that has a row of its own (a
        ``rows[name]`` of None: checked and added to no row, as a task
        grid's launches are also its wrapper's); a check of the card
        against the CPU (``count=False``) adds nothing.  A counted path
        calls no plain version."""
        for f, _ in counters.values():
            f.launches = f.task_launches = f.pod_launches = 0
            f.rows_launches = 0
            for v in getattr(f, "variant_launches", {}):
                f.variant_launches[v] = 0
        plain_calls["n"] = 0
        fn()
        print(f"  [{label}: done at {time.perf_counter() - t_start:.0f} s]")
        want = want() if callable(want) else want
        for name, (f, variant) in counters.items():
            got, expect = launches(f, variant), want.get(name, 0)
            if name in want:
                row = (rows or {}).get(name, name)
                if count and row:
                    results[row]["launches"] += got
                print(f"  launches {name} ({label}): {got} (expected "
                      f"{expect})")
            if got != expect:
                fail(f"{label}: {name} launched {got} times, expected "
                     f"{expect}")
        if count:
            print(f"  plain-version calls ({label}): {plain_calls['n']}")
            if plain_calls["n"]:
                fail(f"{label}: a plain version ran on the card")

    def solve(label, X, loss, n, epochs, accuracy=True, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reads = sharded_passcode_solve.host_reads
        t0 = time.perf_counter()
        r = sharded_passcode_solve(X, loss, epochs=epochs, block_size=B,
                                   gap_every=1, seed=0, device=dev, **kw)
        gaps = r.gaps.tolist()  # the solve's one host sync at the end
        sec = time.perf_counter() - t0
        mesh = kw.get("mesh")
        p = mesh.shape["data"] if mesh is not None else 1
        nb = _n_blocks(-(-n // p), B)
        done = sharded_passcode_solve.epoch_rounds
        print(f"  {label}: {sec / epochs:.3f} s per epoch (gap included), "
              f"{sum(done) * p * B / sec:.4g} updates/s, {nb} rounds per "
              f"epoch ({sec / sum(done) * 1e3:.4f} ms per round run), peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        print(f"    gaps {gaps}")
        print(f"    eps  {r.eps.tolist()}")
        print(f"    active {r.active.tolist()}, delay {r.delay.tolist()}, "
              f"rounds run per epoch {done} of {nb}, host reads of the "
              f"round count {sharded_passcode_solve.host_reads - reads}")
        if accuracy:
            print(f"    train accuracy "
                  f"{float(predict_accuracy(r.w_hat, X)):.4f}")
        if r.alpha.shape != (n,) or not all(math.isfinite(g) for g in gaps):
            fail(f"{label}: result of the wrong shape or a non-finite gap")
        if not gaps[-1] < gaps[0]:
            fail(f"{label}: the duality gap did not fall: {gaps}")
        if done[-1] != nb:
            fail(f"{label}: the final epoch ran {done[-1]} of {nb} rounds")
        return r

    hinge1 = duals.Hinge(1.0)
    nb_r, nb_c = EPOCHS * _n_blocks(n_r, B), EPOCHS * _n_blocks(n_c, B)
    run_path("rcv1", {"dcd_ell_shards": nb_r}, lambda: solve(
        "rcv1 (ELL, B1)", X_rcv1, hinge1, n_r, EPOCHS),
        {"dcd_ell_shards": "dcd_ell"})
    run_path("covtype", {"dcd_indexed_shards": nb_c}, lambda: solve(
        "covtype (dense, B2 staged)", X_cov, duals.Hinge(0.0625), n_c,
        EPOCHS), {"dcd_indexed_shards": "dcd_indexed"})

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
             lambda: solve("webspam (2-D, B4 + B5)", X_web, hinge1,
                           X_web.n_rows, EPOCHS_2D, accuracy=False,
                           mesh=solver_mesh_2d(model=SHARDS)))
    nb_w1 = EPOCHS_2D * _n_blocks(n_w1, B)
    run_path("webspam 1-D", {"dcd_ell_shards_wide": nb_w1},
             lambda: solve("webspam (1-D, ELL, B1 wide)", X_web, hinge1,
                           n_w1, EPOCHS_2D, accuracy=False),
             {"dcd_ell_shards_wide": "dcd_ell_wide"})

    # p > 1 data shards: the reference's data axis as a grid of CTAs (B1
    # and B2 a CTA a shard; B4 and B5 a group a data shard), at full
    # Table-3 size, and the self-tuning over them; a self-tuning path's
    # launches are the rounds its epochs ran
    def ran():
        return sum(sharded_passcode_solve.epoch_rounds)

    mesh_r, mesh_c = solver_mesh(n_devices=P_R), solver_mesh(n_devices=P_C)
    mesh_w = solver_mesh_2d(data=P_D, model=SHARDS)
    rows_d = {"dcd_feature_gram": "dcd_feature_gram_data",
              "dcd_feature_update": "dcd_feature_update_data"}
    run_path(f"rcv1 p = {P_R}",
             {"dcd_ell_shards": EPOCHS * _n_blocks(n_loc_r8, B)},
             lambda: solve(f"rcv1 (ELL, p = {P_R}, B1 shard grid)", X_rcv1,
                           hinge1, n_r, EPOCHS, mesh=mesh_r))
    run_path(f"covtype p = {P_C}",
             {"dcd_indexed_shards": EPOCHS * _n_blocks(n_loc_c8, B)},
             lambda: solve(f"covtype (dense, p = {P_C}, B2 shard grid)",
                           X_cov, duals.Hinge(0.0625), n_c, EPOCHS,
                           mesh=mesh_c))
    nb_d = EPOCHS_2D * _n_blocks(n_loc_d, B)
    run_path(f"webspam data = {P_D}",
             {"dcd_feature_gram": nb_d, "dcd_feature_update": nb_d},
             lambda: solve(f"webspam (2-D, data = {P_D}, m = {SHARDS}, B4 + "
                           "B5 over the data grid)", X_web, hinge1, n_w,
                           EPOCHS_2D, accuracy=False, mesh=mesh_w), rows_d)
    run_path(f"webspam 1-D p = {P_W1}",
             {"dcd_ell_shards_wide": EPOCHS_2D * _n_blocks(n_loc_w1, B)},
             lambda: solve(f"webspam (1-D, ELL, p = {P_W1}, B1 wide shard "
                           "grid)", X_web, hinge1, n_w1, EPOCHS_2D, accuracy=False,
                           mesh=solver_mesh(n_devices=P_W1)))
    # A′.12: the per-epoch host driver (pipeline=False) against the
    # pipelined solve at the same seed, 2 epochs each: rcv1 at p = P_R (B1's
    # shard grid) at delays 0 and 1; webspam on the 2-D mesh, m = SHARDS,
    # the fused round at delay 0 and the overlapped one at delay 1 (the
    # unfused engine, use_kernel=False, is the CPU path and is refused on
    # the card)
    def driver_pair(label, X, loss, n, want, **kw):
        out = {}

        def run():
            for pipe in (True, False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = sharded_passcode_solve(X, loss, epochs=2, block_size=B,
                                           gap_every=1, seed=SEED,
                                           device=dev, pipeline=pipe, **kw)
                gaps = r.gaps.tolist()
                out[pipe] = (r, (time.perf_counter() - t0) / 2, gaps)

        run_path(label, want, run)
        (rp, sp, gp), (rd, sd, gd) = out[True], out[False]
        ea = float((rp.alpha - rd.alpha).abs().max())
        ew = float((rp.w_hat - rd.w_hat).abs().max())
        eg = max(abs(a - b) - 1e-3 * abs(a) for a, b in zip(gp, gd))
        print(f"  {label}: pipelined {sp:.3f} s per epoch, driver "
              f"{sd:.3f} s per epoch; gaps {gp} and {gd}; max abs "
              f"diff α {ea:.3g}, ŵ {ew:.3g} (tolerance {ATOL}), the gaps "
              f"within 1e-3 + 1e-3·|gap|: {eg <= 1e-3}")
        if not (ea <= ATOL and ew <= ATOL and eg <= 1e-3 and len(gp)
                == len(gd) == 2 and gd[-1] < gd[0] and rd.eps is None):
            fail(f"{label}: the driver disagrees with the pipelined solve")

    nb_r8 = _n_blocks(n_loc_r8, B)
    for dr in (0, 1):
        driver_pair(f"rcv1 p = {P_R} pipeline=False delay {dr}", X_rcv1,
                    hinge1, n_r, {"dcd_ell_shards": 4 * nb_r8},
                    mesh=mesh_r, delay_rounds=dr)
    nb_w2 = _n_blocks(n_w, B)
    driver_pair("webspam 2-D pipeline=False delay 0", X_web, hinge1, n_w,
                {"dcd_feature_gram": 4 * nb_w2,
                 "dcd_feature_update": 4 * nb_w2},
                mesh=solver_mesh_2d(model=SHARDS))
    # the overlapped round's grams: the pipelined solve's one at entry and
    # one a round; the driver's one a round and a prologue an epoch
    driver_pair("webspam 2-D pipeline=False overlapped delay 1", X_web,
                hinge1, n_w,
                {"dcd_feature_gram": 4 * nb_w2 + 3,
                 "dcd_feature_update": 4 * nb_w2},
                mesh=solver_mesh_2d(model=SHARDS), delay_rounds=1,
                overlap=True)

    # the feature-sharded shim: one block of all SHIM_ROWS rows an epoch,
    # B4 and B5 in their rows layout, its objective falling
    def shim():
        hinge_s = duals.Hinge(1.0)
        g0 = float(duality_gap(torch.zeros(SHIM_ROWS, device=dev), X_shim,
                               hinge_s))
        gaps = []
        for ep in (1, 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a, w = sharded_passcode_feature(
                X_shim, hinge_s, mesh=solver_mesh_2d(model=SHARDS),
                epochs=ep)
            torch.cuda.synchronize()
            sec = (time.perf_counter() - t0) / ep
            gaps.append(float(duality_gap(a, X_shim, hinge_s)))
            print(f"  shim, {ep} epoch(s) of one {SHIM_ROWS}-id block: "
                  f"{sec:.4f} s per epoch, gap {gaps[-1]:.6g}, primal "
                  f"{float(primal_objective(w, X_shim, hinge_s)):.6g}")
        print(f"  shim gaps: {g0:.6g} at α = 0, then {gaps}")
        if not (math.isfinite(gaps[-1]) and gaps[1] < gaps[0] < g0):
            fail(f"shim: the duality gap did not fall ({g0}, {gaps})")

    run_path("sharded_passcode_feature shim",
             {"dcd_feature_gram": 4, "dcd_feature_update": 4,
              "dcd_feature_gram_rows": 4, "dcd_feature_update_rows": 4},
             shim, {"dcd_feature_gram": None, "dcd_feature_update": None})

    run_path(f"rcv1 p = {P_R} shrinking",
             lambda: {"dcd_ell_shards": ran()},
             lambda: solve(f"rcv1 (ELL, p = {P_R}, shrink_every = 1, "
                           "repack auto below 0.8 active)", X_rcv1, hinge1,
                           n_r, EPOCHS, mesh=mesh_r, shrink_every=1,
                           repack="auto", repack_threshold=0.8))
    # the adaptive delay from delay_rounds = 1 with a ratio of 0.3: the
    # flag stays 1 while each record's gap is at most 0.3 of the one
    # before, and latches to 0 (synchronous reads) from the epoch after a
    # record that is not; the recorded flags must follow that rule from
    # the recorded gaps
    adaptive = []
    run_path(f"rcv1 p = {P_R} shrinking, adaptive",
             lambda: {"dcd_ell_shards": ran()},
             lambda: adaptive.append(solve(
                 f"rcv1 (ELL, p = {P_R}, shrink_every = 1, repack auto, "
                 "adaptive ratio 0.3, delay_rounds = 1)", X_rcv1, hinge1,
                 n_r, EPOCHS, mesh=mesh_r, shrink_every=1, repack="auto",
                 adaptive=True, adaptive_ratio=ADAPTIVE_RATIO,
                 delay_rounds=1)))
    g_ad, f_ad = adaptive[0].gaps.tolist(), adaptive[0].delay.tolist()
    latch = [1.0]
    for k in range(1, len(g_ad)):
        latch.append(min(latch[-1], float(
            g_ad[k - 1] <= ADAPTIVE_RATIO * g_ad[k - 2] if k > 1 else 1.0)))
    print(f"  adaptive delay flags {f_ad}, by the latch rule from the gaps "
          f"{latch}; the flag moved: {min(f_ad) < 1}")
    if f_ad != latch:
        fail(f"the adaptive delay flags {f_ad} do not follow the latch rule "
             f"from the recorded gaps ({latch})")
    run_path(f"webspam data = {P_D} shrinking",
             lambda: {"dcd_feature_gram": ran(), "dcd_feature_update": ran()},
             lambda: solve(f"webspam (2-D, data = {P_D}, m = {SHARDS}, "
                           "shrink_every = 1)", X_web, hinge1, n_w,
                           EPOCHS_2D, accuracy=False, mesh=mesh_w,
                           shrink_every=1), rows_d)

    # the multi-task (one-vs-rest) solve: K classes on the unfolded rows
    # as one solve, every round one launch of the task grid (K × p CTAs,
    # or K × m pairs on the 2-D mesh); its seconds per epoch, each task's
    # gaps summarised over the tasks, its rounds and peak memory, and the
    # top-1 accuracy of the K heads on the training rows against the
    # majority class's share
    def summary(vals):
        v = sorted(vals)
        return f"{v[0]:.6g} / {v[len(v) // 2]:.6g} / {v[-1]:.6g}"

    def mt_solve(label, X, loss, data, n, epochs, **kw):
        ids, Y, majority = classes[data]
        K = Y.shape[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reads = sharded_passcode_solve.host_reads
        t0 = time.perf_counter()
        r = sharded_passcode_solve(X, loss, y=Y, epochs=epochs,
                                   block_size=B, gap_every=1, seed=SEED,
                                   device=dev, **kw)
        gaps = r.gaps.tolist()  # the solve's one host sync at the end
        sec = time.perf_counter() - t0
        rounds = sharded_passcode_solve.task_rounds
        done = sharded_passcode_solve.epoch_rounds
        print(f"  {label}: {sec / epochs:.3f} s per epoch (gap included), "
              f"{sec / sum(done) * 1e3:.4f} ms per round run, rounds run "
              f"per epoch {done}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        for e in range(epochs):
            print(f"    epoch {e + 1}: gap min / median / max over the "
                  f"{K} tasks {summary([g[e] for g in gaps])}")
        if kw.get("shrink_every"):
            act = r.active.tolist()
            for e in range(epochs):
                print(f"    epoch {e + 1}: active fraction "
                      f"{summary([a[e] for a in act])}, rounds run "
                      f"{summary(rounds[e])}")
            print(f"    host reads of the round counts "
                  f"{sharded_passcode_solve.host_reads - reads} in "
                  f"{epochs} epochs")
            if sharded_passcode_solve.host_reads - reads != epochs:
                fail(f"{label}: the round counts were not read once an "
                     "epoch")
        acc = float(multiclass_accuracy(r.w_hat, X, ids))
        print(f"    top-1 accuracy of the {K} heads on the training rows "
              f"{acc:.4f} (the majority class's share {majority:.4f})")
        if (tuple(r.alpha.shape) != (K, n)
                or not all(math.isfinite(g) for t in gaps for g in t)):
            fail(f"{label}: result of the wrong shape or a non-finite gap")
        if not all(t[-1] < t[0] for t in gaps):
            fail(f"{label}: a task's gap did not fall")
        if not acc > majority:
            fail(f"{label}: accuracy {acc} not above the majority share")
        return r

    mt = {}
    nb_r8, nb_c8 = _n_blocks(n_loc_r8, B), _n_blocks(n_loc_c8, B)
    run_path(f"rcv1 K = {K_R}, p = {P_R}",
             {"dcd_ell_shards": EPOCHS * nb_r8,
              "dcd_ell_tasks": EPOCHS * nb_r8},
             lambda: mt.update(rcv1=mt_solve(
                 f"rcv1 multi-task (K = {K_R}, p = {P_R}, B1 task grid)",
                 X_rcv1, hinge1, "rcv1", n_r, EPOCHS, mesh=mesh_r)),
             {"dcd_ell_shards": None})
    run_path(f"covtype K = {K_C}, p = {P_C}",
             {"dcd_indexed_shards": EPOCHS * nb_c8,
              "dcd_indexed_tasks": EPOCHS * nb_c8},
             lambda: mt.update(covtype=mt_solve(
                 f"covtype multi-task (K = {K_C}, p = {P_C}, B2 task grid)",
                 X_cov, duals.Hinge(0.0625), "covtype", n_c, EPOCHS,
                 mesh=mesh_c)),
             {"dcd_indexed_shards": None})
    nb_wt = EPOCHS_2D * _n_blocks(n_w, B)
    run_path(f"webspam K = {K_W}",
             {"dcd_feature_gram": nb_wt, "dcd_feature_update": nb_wt,
              "dcd_feature_gram_tasks": nb_wt,
              "dcd_feature_update_tasks": nb_wt},
             lambda: mt_solve(f"webspam multi-task (2-D, K = {K_W}, m = "
                              f"{SHARDS}, B4 + B5 task grid)", X_web, hinge1,
                              "webspam", n_w, EPOCHS_2D,
                              mesh=solver_mesh_2d(model=SHARDS)),
             {"dcd_feature_gram": None, "dcd_feature_update": None})
    run_path(f"rcv1 K = {K_R}, p = {P_R} shrinking",
             lambda: {"dcd_ell_shards": ran(), "dcd_ell_tasks": ran()},
             lambda: mt_solve(
                 f"rcv1 multi-task (K = {K_R}, p = {P_R}, shrink_every = 1, "
                 "repack below 0.8 active)", X_rcv1, hinge1, "rcv1", n_r,
                 EPOCHS, mesh=mesh_r, shrink_every=1, repack="auto",
                 repack_threshold=0.8),
             {"dcd_ell_shards": None})

    # K = 1 is the binary solve: one epoch at p = 8 of the class-0-vs-rest
    # labels y, the binary solve of y·X against X with y[None], α and ŵ
    # bit for bit, the recorded gap at rtol 1e-6.  An ELL solve's gap
    # takes w(α) through index_add_, whose atomics add in no fixed order
    # on the card, so where the recorded gaps part by more, both gaps are
    # evaluated again in a fixed order (on the CPU, from the card's α and
    # ŵ: the binary's on y·X, the K = 1 one on X with y folded on read)
    # and held at rtol 1e-6, and the card gap's own spread is shown (the
    # binary's evaluated twice on its α)
    def fold(X, y):
        if isinstance(X, EllMatrix):
            return EllMatrix(X.indices, X.values * y[:, None], X.n_features)
        return X * y[:, None]

    def ell_gap(loss, X, alpha, w_hat, y=None):
        rows = (X.indices, X.values)
        w_view = torch.cat([w_hat, w_hat.new_zeros(1)])
        return float(_gap_closure(loss, rows, ell=True)(
            alpha, w_view, y)[0])

    for data, X, loss, mesh in [("rcv1", X_rcv1, hinge1, mesh_r),
                                ("covtype", X_cov, hinge_c, mesh_c)]:
        y = classes[data][1][0]
        kw = dict(epochs=1, block_size=B, seed=SEED, mesh=mesh, device=dev)
        b = sharded_passcode_solve(fold(X, y), loss, **kw)
        m1 = sharded_passcode_solve(X, loss, y=y[None], **kw)
        torch.cuda.synchronize()
        same = (torch.equal(m1.alpha[0], b.alpha)
                and torch.equal(m1.w_hat[0], b.w_hat))
        rel = float((m1.gaps[0] - b.gaps).abs().max() / b.gaps.abs().max())
        print(f"  K = 1 is the binary solve ({data}, p = 8, one epoch): α "
              f"and ŵ bit-identical: {same}; recorded gap "
              f"{float(m1.gaps[0, 0])!r} against {float(b.gaps[0])!r} "
              f"(relative {rel:.3g}, tolerance 1e-6)")
        if not same:
            fail(f"{data}: the K = 1 multi-task solve is not the binary one")
        if rel > 1e-6:
            if not isinstance(X, EllMatrix):
                fail(f"{data}: the K = 1 gap parts from the binary one")
            Xc = EllMatrix(X.indices.cpu(), X.values.cpu(), X.n_features)
            gb = ell_gap(loss, fold(Xc, y.cpu()), b.alpha.cpu(),
                         b.w_hat.cpu())
            gm = ell_gap(loss, Xc, m1.alpha[0].cpu(), m1.w_hat[0].cpu(),
                         y.cpu())
            twice = [ell_gap(loss, fold(X, y), b.alpha, b.w_hat)
                     for _ in range(2)]
            rel_c = abs(gm - gb) / abs(gb)
            print(f"    in a fixed order (CPU): {gm!r} against {gb!r} "
                  f"(relative {rel_c:.3g}, tolerance 1e-6); the binary gap "
                  f"evaluated twice on the card: {twice[0]!r}, "
                  f"{twice[1]!r}")
            if not rel_c <= 1e-6:
                fail(f"{data}: the K = 1 gap parts from the binary one in "
                     "a fixed order")
        del b, m1

    # one solve against the loop over K: each class's binary solve on the
    # rows folded by Y[k] (the same seed and epochs), α and ŵ at atol
    # 1e-5 against that class of the multi-task path's result
    for data, X, loss, mesh, ks in [
            ("covtype", X_cov, hinge_c, mesh_c, range(K_C)),
            ("rcv1", X_rcv1, hinge1, mesh_r, (0, 26, 52))]:
        r, Y = mt[data], classes[data][1]
        errs, bits = [], []
        for k in ks:
            b = sharded_passcode_solve(fold(X, Y[k]), loss, epochs=EPOCHS,
                                       block_size=B, seed=SEED, mesh=mesh,
                                       device=dev)
            errs.append(max(float((r.alpha[k] - b.alpha).abs().max()),
                            float((r.w_hat[k] - b.w_hat).abs().max())))
            bits.append(torch.equal(r.alpha[k], b.alpha)
                        and torch.equal(r.w_hat[k], b.w_hat))
            del b
        print(f"  one solve vs the loop over K ({data}, classes "
              f"{list(ks)}): max abs err {max(errs):.3g} (tolerance "
              f"{ATOL}); bit-identical per class: {bits}")
        if not max(errs) <= ATOL:
            fail(f"{data}: the multi-task solve disagrees with the loop "
                 "over K")
    del mt

    def timed(label, fn, n, epochs, gap0, falls=True):
        """Run and time a solve; its gaps must be finite and, with
        ``falls``, below the gap at α = 0 and falling."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        gaps = r.gaps.tolist()
        sec = time.perf_counter() - t0
        print(f"  {label}: {sec / epochs:.3f} s per epoch (gap included), "
              f"{sec / (epochs * n) * 1e9:.1f} ns per update")
        print(f"    gaps {gaps} (at α = 0: {gap0:.6g})")
        if not all(math.isfinite(g) for g in gaps):
            fail(f"{label}: non-finite gaps: {gaps}")
        if falls and not (gaps[0] < gap0 and gaps[-1] <= gaps[0]):
            fail(f"{label}: the gap did not fall: {gaps}")
        return r

    # pods (Hybrid-DCA): each epoch an outer round from the merged (α,
    # w), each pod's rounds one launch of the pod grid (P·p CTAs, or
    # (pod, data, model) triples), the pods' Δw merged at the epoch's end
    # now or through a FIFO of pod_delay_rounds; each path prints its
    # seconds per epoch, gaps and ε epoch by epoch, delay flags, peak
    # memory and rounds
    def pod_solve(label, X, loss, n, epochs, P, p, model=None, y=None,
                  falls=True, **kw):
        mesh = (SolverMesh(("pod", "data"), (P, p)) if model is None
                else solver_mesh_3d(pod=P, data=p, model=model))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = sharded_passcode_solve(X, loss, mesh=mesh, y=y, epochs=epochs,
                                   block_size=B, gap_every=1, seed=SEED,
                                   device=dev, **kw)
        gaps = r.gaps.tolist()  # the solve's one host sync at the end
        sec = time.perf_counter() - t0
        done = sharded_passcode_solve.epoch_rounds
        print(f"  {label}: {sec / epochs:.3f} s per epoch (gap included), "
              f"{sec / sum(done) * 1e3:.4f} ms per round, rounds per "
              f"epoch {done}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        tasks = gaps if y is not None else [gaps]
        eps = r.eps.tolist() if y is not None else [r.eps.tolist()]
        for e in range(epochs):
            g_e, e_e = [t[e] for t in tasks], [t[e] for t in eps]
            print(f"    epoch {e + 1}: gap {summary(g_e)}, ε "
                  f"{summary(e_e)}"
                  + (f" (min / median / max over {len(tasks)} tasks)"
                     if y is not None else ""))
        print(f"    delay flags {r.delay.tolist()}, ‖ŵ‖ "
              f"{float(torch.linalg.vector_norm(r.w_hat)):.6g}")
        lead = (y.shape[0],) if y is not None else ()
        if (tuple(r.alpha.shape) != (*lead, n)
                or not all(math.isfinite(g) for t in tasks for g in t)):
            fail(f"{label}: result of the wrong shape or a non-finite gap")
        if falls and not all(t[-1] < t[0] for t in tasks):
            fail(f"{label}: the duality gap did not fall: {gaps}")
        return r

    # a merge kept in flight for 2 outer rounds lets each pod's α move
    # against a w that lacks the last two merges, and on rcv1 the gap can
    # rise (the reference's semantics: the pod solve at (2, 1) follows the
    # serial oracle through it, below); the delayed paths are held to
    # the reference's own bound on staleness (tests/test_sharded_pod.py:
    # the final gap within 20× the synchronous one) instead of a fall
    pod_runs = {}
    nb_rp = _n_blocks(n_loc_rp, B)
    rows_p1 = {"dcd_ell_shards": None}
    for delay, adapt in [(0, False), (2, False), (2, True)]:
        what = f"pod_delay_rounds {delay}" + (", adaptive ratio 0.3"
                                              if adapt else "")
        run_path(f"rcv1 pods (2, 4), {what}",
                 {"dcd_ell_shards": EPOCHS * nb_rp,
                  "dcd_ell_pods": EPOCHS * nb_rp},
                 lambda: pod_runs.update({(delay, adapt): pod_solve(
                     f"rcv1 pods (P = {P_P}, p = {P_PD}, B1 pod grid), "
                     f"{what}", X_rcv1, hinge1, n_r, EPOCHS, P_P, P_PD,
                     falls=delay == 0, pod_delay_rounds=delay,
                     adaptive=adapt, adaptive_ratio=ADAPTIVE_RATIO)}),
                 rows_p1)
    r0, r2, ra = (pod_runs[k] for k in ((0, False), (2, False), (2, True)))
    for label, r in [("delay 2", r2), ("delay 2, adaptive", ra)]:
        g, g0 = r.gaps.tolist(), float(r0.gaps[-1])
        print(f"  rcv1 pods {label}: final gap {g[-1]:.6g}, "
              f"{g[-1] / g0:.3f}× the synchronous run's {g0:.6g} (bound "
              f"20×); below its first: {g[-1] < g[0]}")
        if not g[-1] <= 20.0 * g0:
            fail(f"rcv1 pods {label}: the final gap is past 20× the "
                 "synchronous one")
    wn0 = float(torch.linalg.vector_norm(r0.w_hat))
    eps0, eps2 = r0.eps.tolist(), r2.eps.tolist()
    print(f"  rcv1 pods: ε at delay 0 {eps0} (at most 1e-4·‖ŵ‖ = "
          f"{1e-4 * wn0:.4g}); at delay 2 {eps2}")
    if not max(eps0) <= 1e-4 * wn0:
        fail(f"rcv1 pods: ε at delay 0 {eps0} is above 1e-4·‖ŵ‖")
    if not min(eps2) > max(eps0):
        fail(f"rcv1 pods: ε at delay 2 {eps2} is not above delay 0's")
    g_ad, f_ad = ra.gaps.tolist(), ra.delay.tolist()
    latch = [1.0]
    for k in range(1, len(g_ad)):
        latch.append(min(latch[-1], float(
            g_ad[k - 1] <= ADAPTIVE_RATIO * g_ad[k - 2] if k > 1 else 1.0)))
    print(f"  rcv1 pods adaptive: flags {f_ad}, by the latch rule from the "
          f"gaps {latch}")
    if f_ad != latch:
        fail(f"the pod latch's flags {f_ad} do not follow the rule from the "
             f"recorded gaps ({latch})")
    del pod_runs, r0, r2, ra

    nb_cp = _n_blocks(n_loc_cp, B)
    rows_p2 = {"dcd_indexed_shards": None}
    run_path("covtype pods (2, 4), pod_delay_rounds 1",
             {"dcd_indexed_shards": EPOCHS * nb_cp,
              "dcd_indexed_pods": EPOCHS * nb_cp},
             lambda: pod_solve(f"covtype pods (P = {P_P}, p = {P_PD}, B2 "
                               "pod grid), pod_delay_rounds 1", X_cov,
                               hinge_c, n_c, EPOCHS, P_P, P_PD,
                               pod_delay_rounds=1), rows_p2)
    run_path(f"covtype pods (2, 4), K = {K_C}",
             {"dcd_indexed_shards": EPOCHS * nb_cp,
              "dcd_indexed_pods": EPOCHS * nb_cp,
              "dcd_indexed_tasks": EPOCHS * nb_cp},
             lambda: pod_solve(f"covtype pods multi-task (K = {K_C}, P = "
                               f"{P_P}, p = {P_PD}), pod_delay_rounds 1",
                               X_cov, hinge_c, n_c, EPOCHS, P_P, P_PD,
                               y=classes["covtype"][1], pod_delay_rounds=1),
             dict(rows_p2, dcd_indexed_tasks=None))
    nb_wp = EPOCHS_2D * _n_blocks(n_loc_wp, B)
    run_path("webspam pods (2, 1, 4), pod_delay_rounds 1",
             {"dcd_feature_gram": nb_wp, "dcd_feature_update": nb_wp},
             lambda: pod_solve(f"webspam pods (P = {P_P}, data = 1, m = "
                               f"{SHARDS}, B4 + B5 pod grid), "
                               "pod_delay_rounds 1", X_web, hinge1, n_w,
                               EPOCHS_2D, P_P, 1, model=SHARDS,
                               pod_delay_rounds=1),
             # one data shard a pod: a view a shard, the pod counts stay 0
             {"dcd_feature_gram": "dcd_feature_gram_pods",
              "dcd_feature_update": "dcd_feature_update_pods"})

    # the pod solve at (pod = 2, data = 1) held to the port's serial
    # oracle cocoa_pod_solve (the P local epochs one wide B1 launch an
    # epoch, the row "dcd_ell_cocoa_pods" on rcv1's first PASSCODE_ROWS
    # rows) on those rows at atol 1e-5, 2 epochs at delays 0 and 1 (and 3
    # epochs at delay 2, where both gaps rise); and the same at full
    # size, its error printed
    X_o = EllMatrix(X_rcv1.indices[:n_o], X_rcv1.values[:n_o], d_r)

    def against_oracle(label, Xo, held, delays):
        for delay in delays:
            kw = dict(epochs=2 if delay < 2 else EPOCHS, block_size=B,
                      pod_delay_rounds=delay, seed=SEED, device=dev)
            t0 = time.perf_counter()
            r = sharded_passcode_solve(Xo, hinge1, mesh=SolverMesh(
                ("pod", "data"), (P_P, 1)), **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            o = cocoa_pod_solve(Xo, hinge1, n_pods=P_P, **kw)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            e = max(float((r.alpha - o.alpha).abs().max()),
                    float((r.w_hat - o.w).abs().max()))
            eg = float((r.gaps.cpu() - o.gaps).abs().max())
            print(f"  pod solve vs cocoa_pod_solve ({label}, P = {P_P}, "
                  f"data = 1, delay {delay}): max abs err {e:.3g} on α and "
                  f"ŵ ({'held at ' + str(ATOL) if held else 'printed'}), "
                  f"gaps {r.gaps.tolist()} against {o.gaps.tolist()} "
                  f"(max diff {eg:.3g}); {t1 - t0:.2f} s and "
                  f"{t2 - t1:.2f} s")
            if held and not e <= ATOL:
                fail(f"the pod solve parts from cocoa_pod_solve ({label}, "
                     f"delay {delay})")

    # a view of w a pod over one data shard a pod: the pod solve's staged
    # B1 grid counts no pod launch; each solve's epochs: its rounds, and
    # one wide launch of the oracle
    ep_o = 2 + 2 + EPOCHS
    run_path(f"rcv1 pod solve vs cocoa_pod_solve ({n_o} rows)",
             {"dcd_ell_shards": ep_o * nb_o, "dcd_ell_shards_wide": ep_o},
             lambda: against_oracle(f"rcv1's first {n_o} rows", X_o, True,
                                    (0, 1, 2)),
             {"dcd_ell_shards": None,
              "dcd_ell_shards_wide": "dcd_ell_cocoa_pods"})
    nb_of = _n_blocks(-(-n_r // P_P), B)
    run_path("rcv1 pod solve vs cocoa_pod_solve (full size)",
             {"dcd_ell_shards": 4 * nb_of, "dcd_ell_shards_wide": 4},
             lambda: against_oracle("rcv1 at full size", X_rcv1, False,
                                    (0, 1)),
             {"dcd_ell_shards": None, "dcd_ell_shards_wide": None})
    del X_o

    # the paper's §5 comparison on covtype (dense, the one Table-3 set the
    # baselines' dense input takes at full size), per epoch: PASSCoDe (the
    # sharded solver at p = 8), CoCoA (8 partitions, one local epoch an
    # outer round, one B2 launch of 8 CTAs a round) and AsySCD (8
    # threads, torch ops), each one's gap after each epoch and seconds per
    # epoch
    gap0_c = float(duality_gap(torch.zeros(n_c, device=dev), X_cov,
                               hinge_c))
    print(f"  §5 on covtype (hinge C = 0.0625, gap at α = 0 {gap0_c:.6g}):")
    run_path("covtype §5 PASSCoDe p = 8",
             {"dcd_indexed_shards": EPOCHS * nb_c8},
             lambda: solve(f"covtype PASSCoDe (p = {P_C})", X_cov, hinge_c,
                           n_c, EPOCHS, mesh=mesh_c))
    run_path("covtype §5 CoCoA", {"dcd_indexed_shards_wide": EPOCHS},
             lambda: timed(f"covtype CoCoA ({THREADS} partitions, one local "
                           "epoch a round)", lambda: cocoa_solve(
                               X_cov, hinge_c, n_partitions=THREADS,
                               outer_rounds=EPOCHS, seed=SEED, device=dev),
                           n_c, EPOCHS, gap0_c),
             {"dcd_indexed_shards_wide": "dcd_indexed_cocoa"})
    # AsySCD's epoch: n / 8 rounds, each a matrix-vector product over the
    # whole X; its first 200 rounds timed set the epoch's size (the full
    # rows, or the first PASSCODE_ROWS if a full epoch would pass 60 s)
    sq_cov = (X_cov * X_cov).sum(1)
    order = prng.permutation(prng.split(prng.PRNGKey(SEED, device=dev))[1],
                             n_c)[: 200 * THREADS].reshape(200, THREADS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _asyscd_epoch(X_cov, sq_cov, torch.zeros(n_c, device=dev), order,
                  hinge_c, 0.5)
    torch.cuda.synchronize()
    per_round = (time.perf_counter() - t0) / 200
    full_s = per_round * (n_c // THREADS)
    n_a = n_c if full_s <= 60.0 else min(PASSCODE_ROWS, n_c)
    X_a = X_cov[:n_a]
    print(f"  AsySCD: {per_round * 1e3:.4f} ms a round at full size, a full "
          f"epoch about {full_s:.1f} s: the epoch runs on "
          f"{'all' if n_a == n_c else 'the first'} {n_a} rows")
    gap0_a = float(duality_gap(torch.zeros(n_a, device=dev), X_a, hinge_c))
    run_path("covtype §5 AsySCD", {},
             lambda: timed(f"covtype AsySCD ({THREADS} threads, {n_a} rows)",
                           lambda: asyscd_solve(X_a, hinge_c,
                                                n_threads=THREADS, epochs=1,
                                                seed=SEED, device=dev),
                           n_a, 1, gap0_a))
    del X_a, sq_cov, order

    # the three on the card against their CPU paths on tiny (and the pod
    # oracle on ELL)
    def baselines_parity():
        Xs = small.dense_train()
        for label, run in [
                ("PASSCoDe p = 8", lambda X, d: sharded_passcode_solve(
                    X, hinge, mesh=solver_mesh(n_devices=8), epochs=3,
                    block_size=16, seed=2, device=d)),
                ("CoCoA", lambda X, d: cocoa_solve(
                    X, hinge, n_partitions=8, outer_rounds=3, seed=2,
                    device=d)),
                ("AsySCD", lambda X, d: asyscd_solve(
                    X, hinge, n_threads=8, epochs=2, seed=2, device=d)),
                ("cocoa_pod_solve (ELL)", lambda X, d: cocoa_pod_solve(
                    small.X_train.to(d), hinge, n_pods=3, epochs=3,
                    block_size=16, pod_delay_rounds=1, seed=2, device=d))]:
            on_card, on_cpu = run(Xs.to(dev), dev), run(Xs, "cpu")
            e = float((on_card.alpha.cpu() - on_cpu.alpha).abs().max())
            print(f"  {label} card path vs CPU path on tiny: max abs err "
                  f"{e:.3g} on α (tolerance {ATOL}); gaps "
                  f"{on_card.gaps.cpu().tolist()}")
            if not e <= ATOL:
                fail(f"{label}: the card path disagrees with its CPU path")

    n_s, d_s = small.X_train.n_rows, small.recipe.d
    n_pod_s = -(-n_s // 3)
    co = dcd_dense_plan(n_s // 8, d_s).variant  # CoCoA's local epoch
    po = dcd_ell_plan(_n_blocks(n_pod_s, 16) * 16,
                      small.X_train.k_max).variant  # the pod oracle's
    want_s = {"dcd_indexed_shards": 3 * _n_blocks(-(-n_s // 8), 16)}
    want_s["dcd_indexed_shards" + ("_wide" if co == "wide" else "")] = (
        want_s.get("dcd_indexed_shards" + ("_wide" if co == "wide" else ""),
                   0) + 3)
    want_s["dcd_ell_shards" + ("_wide" if po == "wide" else "")] = 3
    run_path("§5 baselines, card vs CPU on tiny", want_s, baselines_parity,
             count=False)

    # serial DCD and PASSCoDe-Lock: one launch of B1's (B2's) wide
    # variant per epoch over the epoch's whole order

    shapes = [("rcv1", X_rcv1, duals.Hinge(1.0), n_r, "dcd_ell",
               results["dcd_ell_epoch"]["bound_ms"]),
              ("covtype", X_cov, hinge_c, n_c, "dcd_indexed",
               results["dcd_indexed_epoch"]["bound_ms"])]
    for shape, X, loss, n, kern, b_ms in shapes:
        gap0 = float(duality_gap(torch.zeros(n, device=dev), X, loss))
        print(f"  {shape}: a whole-epoch launch's bound {b_ms:.4f} ms "
              f"({b_ms / n * 1e6:.3f} ns per update)")
        run_path(f"{shape} dcd_solve", {f"{kern}_epoch": EPOCHS},
                 lambda: timed(f"{shape} serial DCD (dcd_solve)",
                               lambda: dcd_solve(X, loss, epochs=EPOCHS,
                                                 seed=0, device=dev),
                               n, EPOCHS, gap0))
        run_path(f"{shape} Lock", {f"{kern}_epoch": EPOCHS},
                 lambda: timed(f"{shape} PASSCoDe-Lock({THREADS})",
                               lambda: passcode_solve(
                                   X, loss, n_threads=THREADS,
                                   memory_model="lock", epochs=EPOCHS,
                                   seed=0, device=dev),
                               n, EPOCHS, gap0))
        # Lock's first epoch against serial DCD over the same seeded
        # order (the reference's key chain: PRNGKey(0), split, split)
        lock = passcode_solve(X, loss, n_threads=THREADS, memory_model="lock",
                              epochs=1, seed=0, device=dev)
        sub = prng.split(prng.PRNGKey(0, device=dev))[1]
        order = _round_indices(prng.split(sub)[0], n, THREADS).reshape(-1)
        sq = X.row_sq_norms() if kern == "dcd_ell" else (X * X).sum(1)
        d = X.n_features if kern == "dcd_ell" else X.shape[1]
        st = dcd_epoch(X, sq, DcdState(torch.zeros(n, device=dev),
                                       torch.zeros(d, device=dev)),
                       order.int(), loss)
        e = max(float((lock.alpha - st.alpha).abs().max()),
                float((lock.w_hat - st.w).abs().max()))
        print(f"  {shape} Lock epoch 1 vs dcd_epoch over its order: max abs "
              f"err {e:.3g} (tolerance {ATOL})")
        if not e <= ATOL:
            fail(f"{shape}: Lock's epoch differs from serial DCD over its "
                 "order")

    # PASSCoDe-Atomic and -Wild on rcv1's first PASSCODE_ROWS rows: torch
    # ops, no kernel of the port.  A full Wild epoch (84,674 rounds) took
    # 44–62 s, past the 60 s this smoke test gives one epoch, so both run
    # on the same cut, which keeps their ε comparable.  Wild's nominal
    # gap is w̄'s (eq. 6), and w̄ runs ahead of the ŵ its updates read:
    # on rcv1's zipf-hot columns most of a conflicted feature's 8
    # increments are lost, so its gap after one epoch may lie above the
    # gap at α = 0 (the reference's semantics: at rcv1's width it rises
    # past that with n: scripts/wild_gap_growth.py shows it in both).
    # Wild is held to its primal at ŵ, the vector it predicts with
    # (Cor. 1), below P(0) = the gap at α = 0.  Each epoch's α and ŵ are
    # also held to the port's CPU path on the same rows and seed
    n_p = min(PASSCODE_ROWS, n_r)
    X_p = EllMatrix(X_rcv1.indices[:n_p], X_rcv1.values[:n_p], d_r)
    X_p_cpu = EllMatrix(X_p.indices.cpu(), X_p.values.cpu(), d_r)
    gap0_p = float(duality_gap(torch.zeros(n_p, device=dev), X_p, hinge))
    reports = {}
    for mm in ("atomic", "wild"):
        kw = dict(n_threads=THREADS, memory_model=mm, epochs=1, seed=0,
                  delay=0, conflict_rate=0.5)

        def one_epoch(mm=mm, kw=kw):
            r = timed(f"rcv1's first {n_p} rows PASSCoDe-{mm.capitalize()}"
                      f"({THREADS}), {n_p // THREADS} rounds",
                      lambda: passcode_solve(X_p, hinge, device=dev, **kw),
                      n_p, 1, gap0_p, falls=mm == "atomic")
            reports[mm] = backward_error_report(X_p, None, hinge, r)
            return r

        on_card = []
        run_path(f"rcv1 {mm}", {}, lambda: on_card.append(one_epoch()))
        t0 = time.perf_counter()
        on_cpu = passcode_solve(X_p_cpu, hinge, device="cpu", **kw)
        sec = time.perf_counter() - t0
        e = max(float((on_card[0].alpha.cpu() - on_cpu.alpha).abs().max()),
                float((on_card[0].w_hat.cpu() - on_cpu.w_hat).abs().max()))
        print(f"    card path vs CPU path ({sec:.1f} s on the CPU): max abs "
              f"err {e:.3g} on α and ŵ (tolerance {ATOL})")
        if not e <= ATOL:
            fail(f"rcv1 {mm}: the card path disagrees with its CPU path")
        rep = reports[mm]
        print(f"    backward-error report: {json.dumps(rep)}")
        if not all(math.isfinite(v) for v in rep.values()):
            fail(f"rcv1 {mm}: a non-finite field in the report")
        if not rep["primal_at_w_hat"] < gap0_p:
            fail(f"rcv1 {mm}: P(ŵ) = {rep['primal_at_w_hat']} is not below "
                 f"P(0) = {gap0_p}")
    eps_a, eps_w = reports["atomic"]["eps_norm"], reports["wild"]["eps_norm"]
    if not eps_w > eps_a:
        fail(f"rcv1: Wild's ε ({eps_w}) is not above Atomic's ({eps_a})")
    if not eps_a <= 1e-4 * reports["atomic"]["w_bar_norm"]:
        fail(f"rcv1: Atomic's ε ({eps_a}) is above 1e-4·‖w̄‖")
    # where an Atomic round's time goes: 20 rounds of the first epoch
    sub = prng.split(prng.PRNGKey(0, device=dev))[1]
    kperm, kround = prng.split(sub)
    ids20 = _round_indices(kperm, n_r, THREADS)[:20]
    keys20 = prng.split(kround, 20)
    w_pad = torch.zeros(d_r + 1, device=dev)
    a0 = torch.zeros(n_r, device=dev)
    # the epoch's int64 column ids, made once an epoch, made here before
    X_r64 = EllMatrix(X_rcv1.indices.long(), X_rcv1.values, d_r)

    def atomic20():
        _parallel_epoch(X_r64, q_r, a0, w_pad, ids20, keys20, hinge,
                        wild=False, delay=0, conflict_rate=0.5)

    atomic20()  # warm
    profile_rounds(f"rcv1 Atomic({THREADS})", atomic20, 20, torch)

    # all three memory models on the card against their CPU path on tiny
    # (Lock: the staged B1 / B2 kernel against its plain version); Wild
    # one epoch at a time from the CPU path's state, as a rounding flip
    # of a δ at a bound switches a feature between the sum and the last
    # writer
    def passcode_parity():
        for label, Xs in [("ELL", small.X_train),
                          ("dense", small.dense_train())]:
            ell = label == "ELL"
            sq = Xs.row_sq_norms() if ell else (Xs * Xs).sum(1)
            n, d = (Xs.n_rows, Xs.n_features) if ell else Xs.shape
            for mm in ("lock", "atomic", "wild"):
                kw = dict(n_threads=THREADS, memory_model=mm, delay=2)
                if mm != "wild":
                    on_card = passcode_solve(Xs.to(dev), hinge, epochs=3,
                                             seed=1, device=dev, **kw)
                    on_cpu = passcode_solve(Xs, hinge, epochs=3, seed=1,
                                            device="cpu", **kw)
                    pairs = [(on_card.alpha, on_cpu.alpha),
                             (on_card.w_hat, on_cpu.w_hat)]
                else:
                    a, w = torch.zeros(n), torch.zeros(d)
                    key, pairs = prng.PRNGKey(1), []
                    for _ in range(3):
                        key, sub = prng.split(key)
                        card = passcode_epoch(
                            Xs.to(dev), sq.to(dev), a.to(dev), w.to(dev),
                            sub.to(dev), hinge, device=dev, **kw)
                        a, w = passcode_epoch(Xs, sq, a, w, sub, hinge,
                                              device="cpu", **kw)
                        pairs += [(card[0], a), (card[1], w)]
                e = max(float((x.cpu() - y).abs().max()) for x, y in pairs)
                print(f"  PASSCoDe-{mm} {label} (delay 2, 3 epochs) card path "
                      f"vs CPU path: max abs err {e:.3g} (tolerance {ATOL})")
                if not e <= ATOL:
                    fail(f"PASSCoDe-{mm} {label}: the card path disagrees "
                         "with its CPU path")

    lock_ids = small.X_train.n_rows // THREADS * THREADS
    want_tiny = {
        ("dcd_ell_epoch_staged" if dcd_ell_plan(
            lock_ids, small.X_train.k_max).variant == "staged"
         else "dcd_ell_epoch"): 3,
        ("dcd_indexed_epoch_staged" if dcd_dense_plan(
            lock_ids, small.recipe.d).variant == "staged"
         else "dcd_indexed_epoch"): 3}
    run_path("PASSCoDe tiny, card vs CPU", want_tiny, passcode_parity,
             count=False)

    # the example twins as subprocesses on the card
    def twins():
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        for twin in ("quickstart_torch", "train_svm_passcode_torch"):
            out = subprocess.run(
                [sys.executable, str(ROOT / "examples" / f"{twin}.py"),
                 "--device", "cuda", "--epochs", str(TWIN_EPOCHS)],
                env=env, capture_output=True, text=True, timeout=600)
            for line in (out.stdout + out.stderr).splitlines():
                print(f"    {twin}: {line}")
            gaps = [float(g) for g in re.findall(r"gap=\s*(\S+)",
                                                 out.stdout)]
            if out.returncode != 0 or len(gaps) < 3 or not all(
                    math.isfinite(g) for g in gaps):
                fail(f"{twin} exited {out.returncode} with gaps {gaps}")

    run_path("example twins", {}, twins)

    # ---------------------------------------------------- 5. resilience
    resilience_phase(torch, dev, run_path, X_rcv1, X_cov, X_web,
                     classes["covtype"][1], classes["rcv1"][1])

    # ------------------------------------------------------------ 6. serve
    serve_phase(torch, dev, run_path, X_rcv1, X_web, classes["rcv1"][0])

    # the LM phase's probe: B2's task grid and its wide epoch launches
    results["dcd_indexed_tasks"]["launches"] += lm_launches[
        "dcd_indexed_tasks"]
    results["dcd_indexed_epoch"]["launches"] += lm_launches[
        "dcd_indexed_epoch"]

    # --------------------------------------------------------- 10. result
    idle = [name for name, row in results.items() if row["launches"] < 1]
    if idle:
        fail(f"kernels no main path launched: {idle}")
    print(f"profiler windows taken twice (no device activity in the "
          f"first): {PROFILED_TWICE or 'none'}")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(lm_main() if sys.argv[1:] == ["--lm-phase"]
             else lm_train_main() if sys.argv[1:] == ["--lm-train-phase"]
             else dist_rank_main(int(sys.argv[2]), sys.argv[3])
             if sys.argv[1:2] == ["--dist-rank"]
             else dist_one_main(sys.argv[2])
             if sys.argv[1:2] == ["--dist-one"]
             else dist_phase_main() if sys.argv[1:] == ["--dist-phase"]
             else main())

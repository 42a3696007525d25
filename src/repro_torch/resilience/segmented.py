"""The segmented, fault-tolerant solve (the counterpart of
``repro/resilience/segmented.py``).

``solve_segmented`` is ``sharded_passcode_solve`` run in
``checkpoint_every``-epoch segments of the same carried-state machinery
(``repro_torch.core.sharded.build_pipeline``): each segment takes and
returns the whole ``SolverState`` and keys every decision on the global
epoch, so a segmented run is the whole solve bit for bit.  Around it:

  * each boundary may persist the state (``repro_torch.train.
    checkpoint``: atomic, content-hashed, the reference's format); a
    killed process resumes from the last boundary and replays bit for
    bit;
  * the watchdog's sticky health code is read on the host once a
    segment; a trip rolls back to the last healthy boundary and replays
    it — twice with the same knobs (a transient fault replays to the
    clean solve's bits), then down ``degrade_ladder`` (synchronous) —
    and past ``max_retries`` raises ``SolverDiverged`` with the last
    healthy result;
  * a ``FaultPlan`` arms deterministic faults against exactly this
    machinery.

A resume whose checkpoint matches the current layout and schedule
re-places its leaves as they are (a bit resume); one whose pod or shard
count changed warm-starts from the canonical (α, w) in the checkpoint,
re-blocked onto the new layout, and carries the layout-free leaves (the
key chain, the records, the latches) over.

On a mesh spread over ranks (``repro_torch.dist.mesh.rank_layout``) the
checkpoint is still the whole solve's, in the reference's format: every
rank gathers the state into the one-process layout
(``state_to_global``), rank 0 alone writes it, between two barriers; on
restore every rank reads it and keeps its own part
(``state_to_local``).  The layout on disk does not depend on the world
size, so a save at W ranks resumes bit for bit at any other.  The
watchdog's census is global (``_bad_count``), so a trip is every
rank's, at the same rung.
"""

from __future__ import annotations

import os
import signal
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.convert import solver_state_from_numpy, solver_state_to_numpy
import torch.distributed as dist

from repro_torch.core.sharded import (
    ShardedResult,
    SolverSetup,
    _segment_knobs,
    build_pipeline,
    finalize_state,
    global_setup,
    init_pipeline_state,
    pipeline_state_keys,
    sharded_passcode_solve,
    solver_mouth,
    state_to_global,
    state_to_local,
)
from repro_torch.dist.mesh import degrade_ladder
from repro_torch.resilience.faults import FaultPlan, corrupt_payload
from repro_torch.resilience.state import (
    SolverDiverged,
    drain_state,
    load_solver_state,
)
from repro_torch.train.checkpoint import (
    gc_checkpoints,
    latest_step,
    save_checkpoint,
)


class ResilientResult(NamedTuple):
    """A finished resilient solve: the ordinary ``ShardedResult`` and the
    recovery record."""

    result: ShardedResult
    health: int            # the final watchdog code (0 = healthy)
    attempts: tuple        # each segment's attempt count (1 = clean)
    rollbacks: int         # tripped segments rolled back
    rung: int              # the final degradation rung (sticky)
    epochs_lost: int       # epochs recomputed by the rollbacks
    resumed_from: Optional[int]  # the checkpoint step resumed from


# the layout-free leaves, carried as they are through an elastic restore:
# the key chain, the records and the adaptive and watchdog latches
_REPLICATED_KEYS = ("key", "gaps", "epsb", "actb", "delayb", "slot",
                    "epoch", "delay", "gapprev", "rpok", "health",
                    "gph", "eph", "frac", "nrun", "rp")


def _target_keys(setup: SolverSetup, knobs: dict, watchdog: bool):
    """The ``SolverState`` keys a segment built with ``knobs`` (a
    ``degrade_ladder`` rung) carries, by the runner's own mode
    resolution (``_segment_knobs``: the self-tuning scan runs where
    shrinking or the adaptive delay is on and neither the overlap nor a
    pod axis is).  Turning the overlap off can add a key: the 2-D path
    without it runs the self-tuning scan and carries ``dwo``."""
    kn = _segment_knobs(setup, knobs["delay_rounds"],
                        knobs["pod_delay_rounds"], knobs["overlap"])
    tn = setup.tuning
    return pipeline_state_keys(dyn=kn.dyn, shrink_on=tn.shrink_every > 0,
                               adaptive=tn.adaptive, pod_fifo=kn.pod_fifo,
                               watchdog=watchdog)


def _primal_fits(setup: SolverSetup, shape, lead) -> bool:
    """Whether a checkpoint's flat primal of ``shape`` holds this
    setup's layout: d (+ 1) words on the 1-D mesh; on the 2-D one m
    slices of at least d_loc + 1 (the reference pads its slices)."""
    if tuple(shape[:-1]) != lead:
        return False
    words = shape[-1]
    if setup.two_d:
        return words % setup.m == 0 and words // setup.m >= setup.d_loc + 1
    return words == setup.w_shape[0]


def _meta(setup: SolverSetup, total: int) -> dict:
    """The scalars that pin a checkpoint's layout and schedule, with the
    reference's names (``pdata`` the data shards of a pod)."""
    return {"pods": setup.pods, "pdata": setup.p // setup.pods,
            "mmodel": setup.m, "block_size": setup.block_size,
            "total_epochs": total, "seed": setup.seed,
            "n_tasks": setup.n_tasks}


def _restore(setup: SolverSetup, ckpt_dir: str, step: int, total: int, *,
             watchdog: bool):
    """(state, epoch, rung) out of checkpoint ``step``: a bit resume when
    the layout and the meta match (the leaves re-placed as they are,
    through ``solver_state_from_numpy``), else an elastic warm start from
    the canonical (α, w), re-blocked by ``_init_alpha_w``, with the
    layout-free leaves carried over."""
    raw = load_solver_state(ckpt_dir, step)
    rung = int(raw.get("meta_rung", 0))
    knobs = degrade_ladder(rung, delay_rounds=setup.delay_rounds,
                           pod_delay_rounds=setup.pod_delay_rounds,
                           overlap=setup.tuning.overlap)
    expected = set(_target_keys(setup, knobs, watchdog))
    state_raw = {k: v for k, v in raw.items()
                 if not k.startswith("meta_") and not k.endswith("_canon")}
    # checkpoints without a task axis carry no n_tasks: 0, the binary's
    meta_ok = all(int(raw.get(f"meta_{name}", 0 if name == "n_tasks"
                              else -1)) == val
                  for name, val in _meta(setup, total).items())
    lead = (setup.n_tasks,) if setup.n_tasks else ()
    if (meta_ok and set(state_raw) == expected
            and state_raw["alpha"].shape == lead + (setup.n_pad,)
            and _primal_fits(setup, state_raw["w"].shape, lead)):
        st = solver_state_from_numpy(state_raw, global_setup(setup))
        return state_to_local(setup, st), step, rung
    # elastic: the mesh (or the schedule) changed; a fresh Δw and FIFO,
    # as any in-flight aggregate is already flushed into w_canon
    st = init_pipeline_state(
        setup, total_epochs=total, watchdog=watchdog,
        alpha0=raw["alpha_canon"], w0=raw["w_canon"],
        delay_rounds=knobs["delay_rounds"],
        pod_delay_rounds=knobs["pod_delay_rounds"],
        overlap_on=knobs["overlap"])
    carried = solver_state_from_numpy(
        {k: state_raw[k] for k in _REPLICATED_KEYS
         if k in st and k in state_raw}, setup)
    for k, v in carried.items():
        if tuple(v.shape) == tuple(st[k].shape):
            st[k] = v
    st["epoch"] = torch.tensor(step, dtype=torch.int32)
    return st, step, rung


def _save_boundary(setup: SolverSetup, st: dict, e: int, *, total: int,
                   rung: int, ckpt_dir: str, keep: int) -> None:
    """Checkpoint the state at boundary epoch ``e``: its leaves in the
    reference's layout (``solver_state_to_numpy``), the canonical
    (α, w) in user coordinates and the ``meta_*`` scalars; then GC down
    to ``keep``.  Across ranks every rank gathers, rank 0 writes, and
    the barriers keep every rank's reads off a half-written step."""
    canon = finalize_state(setup, st, epochs=e)
    st = state_to_global(setup, st)
    spread = setup.lay is not None
    if spread:
        dist.barrier()
    if not spread or dist.get_rank() == 0:
        flat = solver_state_to_numpy(st, global_setup(setup))
        flat["alpha_canon"] = canon.alpha.cpu().numpy()
        flat["w_canon"] = canon.w_hat.cpu().numpy()
        for name, val in _meta(setup, total).items():
            flat[f"meta_{name}"] = np.int64(val)
        flat["meta_epoch"] = np.int64(e)
        flat["meta_rung"] = np.int64(rung)
        save_checkpoint(ckpt_dir, e, flat)
        gc_checkpoints(ckpt_dir, keep=keep)
    if spread:
        dist.barrier()


def _health(st: dict) -> int:
    """The segment's watchdog code, the worst task's: the one host read
    of a segment (counted in ``sharded_passcode_solve.host_reads``)."""
    sharded_passcode_solve.host_reads += 1
    return int(st["health"].max())


def solve_segmented(
    X_host,
    loss,
    *,
    epochs: int = 10,
    checkpoint_every: int | None = None,
    y=None,
    ckpt_dir: str | None = None,
    resume: bool = False,
    keep: int = 3,
    watchdog: bool = True,
    watchdog_blowup: float = 4.0,
    watchdog_floor: float = 1e-3,
    max_retries: int = 3,
    fault_plan: FaultPlan | None = None,
    alpha0=None,
    w0=None,
    mesh=None,
    mesh_axes: tuple = ("data",),
    block_size: int = 64,
    delay_rounds: int = 0,
    pod_delay_rounds: int = 0,
    seed: int = 0,
    record: bool = True,
    use_kernel="auto",
    gap_every: int = 1,
    overlap="auto",
    shrink_every: int = 0,
    shrink_tol: float = 1e-3,
    repack="auto",
    repack_threshold: float = 0.5,
    adaptive: bool = False,
    adaptive_ratio: float = 0.95,
    device=None,
) -> ResilientResult:
    """``sharded_passcode_solve`` with the same knobs, run in
    ``checkpoint_every``-epoch segments with checkpoints, watchdog
    rollback and the degradation ladder (module docstring), on
    ``device`` (the card by default).  ``checkpoint_every=None`` runs one
    segment, still watched.  ``resume=True`` continues from the newest
    checkpoint in ``ckpt_dir`` when there is one — bit for bit on the
    same mesh, elastically across a changed one.  ``fault_plan`` arms
    the fault harness (``repro_torch.resilience.faults``).  The solve's
    ``sharded_passcode_solve.epoch_rounds``/``task_rounds`` cover every
    segment run, replays included."""
    if not record:
        watchdog = False  # the watchdog keys on the record schedule
    setup = solver_mouth(
        X_host, loss, y=y, device=device, mesh=mesh, mesh_axes=mesh_axes,
        block_size=block_size, delay_rounds=delay_rounds,
        pod_delay_rounds=pod_delay_rounds, seed=seed, record=record,
        use_kernel=use_kernel, gap_every=gap_every, overlap=overlap,
        shrink_every=shrink_every, shrink_tol=shrink_tol, repack=repack,
        repack_threshold=repack_threshold, adaptive=adaptive,
        adaptive_ratio=adaptive_ratio)
    total = int(epochs)
    seg = int(checkpoint_every) if checkpoint_every else total
    if seg < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {seg}")
    plan = fault_plan if fault_plan is not None else FaultPlan()
    sharded_passcode_solve.epoch_rounds = []
    sharded_passcode_solve.task_rounds = []

    resumed_from = None
    rung = 0
    e = 0
    st = None
    if resume:
        if ckpt_dir is None:
            raise ValueError("resume=True requires ckpt_dir")
        step = latest_step(ckpt_dir)
        if step is not None:
            st, e, rung = _restore(setup, ckpt_dir, step, total,
                                   watchdog=watchdog)
            resumed_from = step
    if st is None:
        st = init_pipeline_state(setup, total_epochs=total,
                                 watchdog=watchdog, alpha0=alpha0, w0=w0)

    dev_armed = True
    pay_armed = plan.corrupt_payload_segment >= 0
    pipes = {}
    attempts_log = []
    rollbacks = 0
    epochs_lost = 0

    while e < total:
        seg_len = min(seg, total - e)
        seg_idx = e // seg
        snapshot = st  # the last healthy boundary: the rollback target
        attempt = 0
        while True:
            # attempts 0 and 1 keep the current rung (the transient
            # fault's same-knob replay); from attempt 2 on, rung 1
            eff_rung = rung if attempt < 2 else 1
            knobs = degrade_ladder(
                eff_rung, delay_rounds=setup.delay_rounds,
                pod_delay_rounds=setup.pod_delay_rounds,
                overlap=setup.tuning.overlap)
            dev_fault = None
            if dev_armed:
                dev_fault = plan.device_fault(
                    delay_rounds=knobs["delay_rounds"],
                    pod_delay_rounds=knobs["pod_delay_rounds"])
            if dev_fault is not None:
                # only the epochs this segment reaches
                dev_fault = tuple(v if e <= v < e + seg_len else -1
                                  for v in dev_fault)
                if all(v < 0 for v in dev_fault):
                    dev_fault = None
            X_use = setup.X
            if pay_armed and seg_idx == plan.corrupt_payload_segment:
                X_use = corrupt_payload(setup, frac=plan.corrupt_frac,
                                        seed=plan.seed)
            cache_key = (seg_len, knobs["delay_rounds"],
                         knobs["pod_delay_rounds"], bool(knobs["overlap"]),
                         dev_fault)
            fn = pipes.get(cache_key)
            if fn is None:
                fn = build_pipeline(
                    setup, epochs=seg_len, total_epochs=total,
                    watchdog=watchdog, watchdog_blowup=watchdog_blowup,
                    watchdog_floor=watchdog_floor, fault=dev_fault,
                    delay_rounds=knobs["delay_rounds"],
                    pod_delay_rounds=knobs["pod_delay_rounds"],
                    overlap_on=knobs["overlap"])
                pipes[cache_key] = fn
            st_in = (drain_state(st, _target_keys(setup, knobs, watchdog),
                                 p=setup.p_loc)
                     if eff_rung > 0 else st)
            st_out = fn(X_use, st_in)
            # multi-task: any tripped task trips the segment
            health = _health(st_out) if watchdog else 0
            if health == 0:
                st = st_out
                break
            # tripped: roll back to the healthy boundary and retry
            rollbacks += 1
            epochs_lost += seg_len
            attempt += 1
            st = snapshot
            if not plan.persistent:
                dev_armed = False
                pay_armed = False
            if attempt > max_retries:
                raise SolverDiverged(
                    f"segment {seg_idx} (epochs {e}..{e + seg_len}) "
                    f"still unhealthy (code {health}) after {attempt} "
                    "attempts incl. synchronous retries",
                    epoch=e,
                    history=tuple(attempts_log) + (attempt,),
                    result=finalize_state(setup, snapshot, epochs=e))
        if eff_rung == 1:
            rung = 1  # sticky: never climbs back
        attempts_log.append(attempt + 1)
        e += seg_len
        if plan.sigkill_segment == seg_idx and resumed_from is None:
            # the fault harness: die after computing the segment and
            # before saving it; the resumed process (which skips this)
            # replays it from the previous boundary
            os.kill(os.getpid(), signal.SIGKILL)
        if ckpt_dir is not None:
            _save_boundary(setup, st, e, total=total, rung=rung,
                           ckpt_dir=ckpt_dir, keep=keep)

    final = finalize_state(setup, st, epochs=total)
    health_final = _health(st) if watchdog else 0
    return ResilientResult(result=final, health=health_final,
                           attempts=tuple(attempts_log),
                           rollbacks=rollbacks, rung=rung,
                           epochs_lost=epochs_lost,
                           resumed_from=resumed_from)

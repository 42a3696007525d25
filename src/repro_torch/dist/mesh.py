"""Device, mesh and launch-width policy of the port — the counterpart of
the part of ``repro/dist/mesh.py`` the ported slices use.

``resolve_device`` is where every entry point decides where it runs:
on the card unless the caller asks for the CPU, and never quietly on the
CPU when the card is missing.  ``SolverMesh`` names the solver's axes
and their sizes: on one process the reference's ``model`` axis becomes
m virtual feature shards, a leading tensor dimension.  A mesh may also
be spread over the ranks of a process group (``with_ranks``; a
``DeviceMesh`` whose dimensions are the ``pod``, ``data`` and ``model``
axes, each splitting its shards contiguously over its ranks), the
reference's ``Mesh`` over devices; ``rank_layout`` is a rank's place on
it, and ``repro_torch.dist.collectives`` its psums.
The reference's ``data`` axis becomes p virtual row shards
the same way: each kernel runs a grid of p CTAs (or CTA groups), one a
shard, and the psum over ``data`` becomes a sum of the p shards' Δw in
shard order.  The multi-task solver's K one-vs-rest tasks (the
reference's vmapped task axis, and its ``task`` mesh axis) are a task
dimension of the same grid: K × p CTAs (or CTA groups), one a (task,
shard) pair; ``solver_mesh_tasks`` and ``task_axis_policy`` are the
reference's mesh and admission rule for them.  The pod solver's P pods
(the reference's ``pod`` axis, Hybrid-DCA) join the data shards: P·p
CTAs (or CTA groups), pod k's p shards reading pod k's own w;
``solver_mesh_3d`` and ``pod_merge_policy`` are the reference's mesh and
admission rule for them.  ``pipeline_overlap`` is the reference's rule for the
overlapped 2-D round, ``resolve_self_tuning`` and
``adaptive_delay_policy`` its rules for shrinking, repacking and the
adaptive delay, ``watchdog_trip`` and ``degrade_ladder`` the segmented
solve's recovery, and ``serve_admission_policy``, ``serve_rung``,
``serve_degrade_ladder`` and ``drift_trip`` the serving engine's
admission, overload ladder and re-solve trigger.  ``lane_pad`` and
``cta_threads`` size a kernel's thread block.  ``make_production_mesh``
and ``make_fake_mesh`` build the LM dry-run's ``DeviceMesh`` over a
``fake`` process group (no card, no communication); ``make_rank_mesh``
builds the LM stack's live one over an initialised gloo or nccl group,
one rank a mesh point; ``mesh_axes``, ``data_axes`` and ``dp_size`` read
every kind of mesh.
The reference's 128-lane padding of d and k is TPU tiling, not
semantics: the CUDA kernels take any width, so the port pads nothing but
the thread count, which rounds up to whole warps.

The reference admits a shape to a kernel by its VMEM footprint
(``*_kernel_fits``); the port's counterparts size the kernels' shared
memory against the 227 KB one CTA can use on Hopper: ``dcd_ell_plan``
picks B1's variant (the block staged in shared memory; the rows streamed
by id through a ring of stages, w in shared or device memory; or the
wide kernel that reads rows and w from device memory), ``dcd_dense_plan``
picks B2's (the block's dense rows staged, streamed by id, or the wide
kernel),
``dcd_tile_plan`` B3's (the rows streamed through a ring of stages, or
the wide kernel),
``gram_plan`` lays out B4's column classes, CTAs and workspace, and
``feature_update_plan`` B5's (one CTA per class and shard, G staged in
shared memory when it fits).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

WARP = 32
MAX_CTA_THREADS = 256
SMEM_PER_CTA = 232_448  # bytes of shared memory one CTA can use (H100)
STATIC_SMEM = 1024  # bound on a kernel's static shared memory beside it


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for (or
    defaulted to) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU unless the "
            "caller passes device='cpu'")
    return dev


def lane_pad(d: int, lanes: int = WARP) -> int:
    """Round ``d`` up to a multiple of ``lanes`` (a warp by default)."""
    return ((d + lanes - 1) // lanes) * lanes


def cta_threads(width: int, most: int = MAX_CTA_THREADS) -> int:
    """Threads of a CTA that runs a DCD kernel over rows of ``width``
    entries: one thread per entry, in whole warps, at most ``most``
    (wider rows loop)."""
    return min(lane_pad(max(int(width), 1)), int(most))


def _pow2_at_least(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


# B1 staged: ids per block it takes (its repeat scan is O(B²) per block)
# and the CTA that stages the block (its prologue and epilogue run on all
# threads, the updates on one warp of them, which holds a row of at most
# ELL_STAGED_MAX_SLOTS in registers).
ELL_STAGED_MAX_IDS = 1024
ELL_STAGED_THREADS = 512
ELL_ENTRIES_PER_LANE = 4  # row entries per lane of the update warp
ELL_STAGED_MAX_SLOTS = WARP * ELL_ENTRIES_PER_LANE


# B1 stream: a producer warp gathers the rows by id into a ring of stages
# in shared memory.  Rows of at most ELL_STAGED_MAX_SLOTS slots take one
# consumer warp and ELL_STREAM_ROWS rows a stage; longer rows take up to
# ELL_STREAM_MAX_WARPS consumer warps, each thread gathering at most
# ELL_STREAM_LANE entries of a row at once, and one row a stage.  w goes
# in shared memory where it fits beside the ring (ELL_STREAM_SHARED_RINGS,
# (rows, stages) in order of preference), else it stays in device memory
# (ELL_STREAM_DEVICE_RINGS).  Every ring's stages·rows is a power of two
# and its stages at most RING_MAX_STAGES (the kernel's register history).
ELL_STREAM_ROWS = 32
ELL_STREAM_LANE = 16
ELL_STREAM_MAX_WARPS = 16
ELL_STREAM_SHARED_RINGS = {True: ((ELL_STREAM_ROWS, 2), (16, 2), (8, 2)),
                           False: ((1, 4), (1, 2))}
ELL_STREAM_DEVICE_RINGS = {True: ((ELL_STREAM_ROWS, 4), (ELL_STREAM_ROWS, 2)),
                           False: ((1, 4), (1, 2))}
RING_MAX_STAGES = 4


class EllPlan(NamedTuple):
    """B1's launch for a block of ``b`` ids over rows of ``k`` slots:
    ``variant`` "staged" (the block's rows, a column table of
    ``table_slots`` entries and the ids' α, q, y, act in shared memory),
    "stream" (the rows gathered by id through a ring of ``stages`` stages
    of ``tile_rows`` rows by a producer warp for ``warps`` consumer warps,
    w in shared memory when ``w_shared``) or "wide" (rows and w in device
    memory, one update at a time across ``threads``).  ``smem_bytes`` is
    the kernel's dynamic shared memory (0 for wide), per CTA; the grid
    holds ``tasks`` × ``pods`` × ``shards`` CTAs, one a (task, pod, data
    shard) triple."""

    variant: str
    threads: int
    table_slots: int
    smem_bytes: int
    shards: int = 1
    tasks: int = 1
    pods: int = 1
    tile_rows: int = 0
    stages: int = 0
    warps: int = 0
    w_shared: bool = False


def dcd_ell_staged_bytes(b: int, k: int, table_slots: int) -> int:
    """Shared memory of B1's staged kernel: the column table (key and w
    per slot), the block's b·k (slot, value) pairs, and eight b-word id
    arrays (id, α, q, y, act, running α, previous occurrence, repeated
    column)."""
    return 8 * table_slots + 8 * b * k + 32 * b


def dcd_ell_stream_bytes(k: int, d: int, tile_rows: int, stages: int,
                         warps: int, w_shared: bool) -> int:
    """Shared memory of B1's stream kernel: two mbarriers a stage,
    ``stages`` stages of ``tile_rows`` rows (each row's columns and
    values in windows of ``row_slot(k)`` words, then its id, previous
    occurrence, repeated-column flag, the two windows' offsets in one
    word, α, q, y and act; a stage padded to 16 bytes), the running α of
    stages·tile_rows positions, a partial dot a consumer warp, and w
    (d + 1 floats) when ``w_shared``."""
    T, S = int(tile_rows), int(stages)
    stage = -(-(2 * T * row_slot(k) + 8 * T) // 4) * 4
    return (16 * S + 4 * S * stage + 4 * S * T + 4 * warps
            + (4 * (d + 1) if w_shared else 0))


def row_slot(n: int) -> int:
    """Words of a stream kernel's slot for a row of ``n`` words: the
    16-byte-aligned window around a row anywhere in device memory."""
    return (int(n) + 6) // 4 * 4


def ell_stream_warps(k: int) -> int:
    """B1 stream's consumer warps for rows of ``k`` slots: one up to
    ``ELL_STAGED_MAX_SLOTS``, else enough for at most ``ELL_STREAM_LANE``
    entries a thread, at most ``ELL_STREAM_MAX_WARPS`` (longer rows do
    not take the stream kernel)."""
    if k <= ELL_STAGED_MAX_SLOTS:
        return 1
    return min(ELL_STREAM_MAX_WARPS, -(-k // (WARP * ELL_STREAM_LANE)))


@functools.lru_cache(maxsize=64)
def dcd_ell_plan(b: int, k: int, d: int, wide: bool = False,
                 shards: int = 1, tasks: int = 1,
                 pods: int = 1) -> EllPlan:
    """Pick B1's variant for a block of ``b`` ids over rows of ``k``
    slots against a w of ``d`` + 1 words, by shape.  The block takes the
    staged kernel when it holds at most ``ELL_STAGED_MAX_IDS`` ids, its
    rows at most ``ELL_STAGED_MAX_SLOTS`` slots (the update warp keeps a
    row in registers) and it fits the 227 KB of shared memory one CTA
    can use; the staged column table has a power-of-two size of at least
    1.5 slots per entry (a load ≤ 2/3 under linear probing: every real
    entry may be a distinct column).  Any other block takes the stream
    kernel (``ell_stream_warps`` consumer warps; w in shared memory when
    it fits beside the ring, else in device memory), or,
    where a row is longer than ``ELL_STREAM_MAX_WARPS`` warps gather at
    once or not even the smallest ring fits, or ``wide`` asks for it,
    the wide kernel.  ``shards`` data shards of each of ``tasks`` tasks
    run ``b`` ids each, a CTA a (task, shard) pair, and ``pods`` pods of
    ``shards`` data shards each multiply the grid again: one CTA holds
    one task's block, so its layout (and its shared memory) is the
    binary plan's whatever the three counts."""
    b, k, d = max(int(b), 1), max(int(k), 1), max(int(d), 0)
    shards, tasks, pods = (max(int(shards), 1), max(int(tasks), 1),
                           max(int(pods), 1))
    if not wide:
        slots = max(WARP, _pow2_at_least(-(-3 * b * k // 2)))
        need = dcd_ell_staged_bytes(b, k, slots)
        if (b <= ELL_STAGED_MAX_IDS and k <= ELL_STAGED_MAX_SLOTS
                and need <= SMEM_PER_CTA - STATIC_SMEM):
            return EllPlan("staged", ELL_STAGED_THREADS, slots, need,
                           shards, tasks, pods)
        warps, narrow = ell_stream_warps(k), k <= ELL_STAGED_MAX_SLOTS
        if narrow or k <= warps * WARP * ELL_STREAM_LANE:
            for shared in (True, False):
                rings = (ELL_STREAM_SHARED_RINGS if shared
                         else ELL_STREAM_DEVICE_RINGS)[narrow]
                for T, S in rings:
                    need = dcd_ell_stream_bytes(k, d, T, S, warps, shared)
                    if need <= SMEM_PER_CTA - STATIC_SMEM:
                        return EllPlan("stream", WARP * (warps + 1), 0,
                                       need, shards, tasks, pods, T, S,
                                       warps, shared)
    return EllPlan("wide", cta_threads(k), 0, 0, shards, tasks, pods)


# B2 staged: ids per block (its repeat scan is O(B²) per block), the CTA
# that stages the block (the updates run on one warp of it, which holds w
# in registers, DENSE_ENTRIES_PER_LANE words a lane at most)
DENSE_STAGED_MAX_IDS = 1024
DENSE_STAGED_THREADS = 256
DENSE_ENTRIES_PER_LANE = 8
DENSE_STAGED_MAX_D = WARP * DENSE_ENTRIES_PER_LANE


# B2 stream: B3's ring fed by an id list, ring of DENSE_STREAM_STAGES
# stages of DENSE_STREAM_ROWS rows (a producer lane a row's id)
DENSE_STREAM_ROWS = 32
DENSE_STREAM_STAGES = 4

# B2 and B3 split: rows of DENSE_STAGED_MAX_D < d ≤ DENSE_SPLIT_MAX_D
# floats, w split over at most DENSE_SPLIT_MAX_WARPS consumer warps,
# DENSE_SPLIT_LANE[0] words a lane up to DENSE_SPLIT_MAX_WARPS warps of
# them, else DENSE_SPLIT_LANE[1]; B2 stream's producer gathers the rows
# into a ring of DENSE_STREAM_STAGES stages of as many rows
# (DENSE_SPLIT_ROWS, in order of preference) as fit
DENSE_SPLIT_MAX_WARPS = 16
DENSE_SPLIT_LANE = (8, 16)
DENSE_SPLIT_MAX_D = WARP * DENSE_SPLIT_LANE[-1] * DENSE_SPLIT_MAX_WARPS
DENSE_SPLIT_ROWS = (8, 4, 2, 1)


class DensePlan(NamedTuple):
    """B2's launch for a block of ``b`` ids over dense rows of ``d``
    floats: ``variant`` "staged" (the block's rows and the ids' α, q, y,
    act in shared memory, w in the registers of one warp, ``per_lane``
    words a lane), "stream" (the rows gathered by id through a ring of
    ``stages`` stages of ``tile_rows`` rows by a producer warp, w in the
    registers of one consumer warp, ``per_lane`` words a lane), "split"
    (the stream kernel's ring, w split over the registers of ``warps``
    consumer warps, ``per_lane`` words a lane) or "wide" (rows and w in
    device memory, one update at a time across ``threads``).
    ``smem_bytes`` is the kernel's dynamic shared memory (0 for wide),
    per CTA; the grid holds ``tasks`` × ``pods`` × ``shards`` CTAs, one a
    (task, pod, data shard) triple."""

    variant: str
    threads: int
    per_lane: int
    smem_bytes: int
    shards: int = 1
    tasks: int = 1
    pods: int = 1
    tile_rows: int = 0
    stages: int = 0
    warps: int = 0


def dcd_dense_staged_bytes(b: int, d: int) -> int:
    """Shared memory of B2's staged kernel: the block's b rows of d
    floats and eight b-word id arrays (id, α, q, y, act, running α,
    previous occurrence, last occurrence)."""
    return 4 * b * d + 32 * b


def dcd_dense_stream_bytes(tile_rows: int, stages: int, d: int) -> int:
    """Shared memory of B2's stream kernel: two mbarriers a stage,
    ``stages`` stages of ``tile_rows`` rows (the rows in windows of
    ``row_slot(d)`` words, then their id, previous occurrence, offset into
    the window, α, q, y and act; a stage padded to 16 bytes), and the
    running α of stages·tile_rows positions."""
    T, S = int(tile_rows), int(stages)
    stage = -(-(T * row_slot(d) + 7 * T) // 4) * 4
    return 16 * S + 4 * S * stage + 4 * S * T


def dcd_dense_split_bytes(tile_rows: int, stages: int, d: int,
                          warps: int) -> int:
    """Shared memory of B2's and B3's split kernel: B2 stream's mbarriers
    and stages, each of the ``warps`` consumer warps' running α of
    stages·tile_rows positions (padded to 16 bytes), and two slots of
    ``DENSE_SPLIT_MAX_WARPS`` partial dots."""
    T, S = int(tile_rows), int(stages)
    stage = -(-(T * row_slot(d) + 7 * T) // 4) * 4
    return (16 * S + 4 * S * stage + 4 * (-(-warps * S * T // 4) * 4)
            + 8 * DENSE_SPLIT_MAX_WARPS)


def dcd_split_layout(d: int) -> tuple:
    """The split kernel's layout for rows of ``d`` floats
    (``DENSE_STAGED_MAX_D`` < d ≤ ``DENSE_SPLIT_MAX_D``): (per_lane,
    warps, tile_rows, stages, smem_bytes) — the fewest words a lane of
    ``DENSE_SPLIT_LANE`` that at most ``DENSE_SPLIT_MAX_WARPS`` warps
    cover d with, and the most rows a stage of ``DENSE_SPLIT_ROWS`` whose
    ring of ``DENSE_STREAM_STAGES`` stages fits the shared memory one CTA
    can use."""
    d, S = int(d), DENSE_STREAM_STAGES
    per_lane = next(W for W in DENSE_SPLIT_LANE
                    if d <= WARP * W * DENSE_SPLIT_MAX_WARPS)
    warps = -(-d // (WARP * per_lane))
    for T in DENSE_SPLIT_ROWS:
        need = dcd_dense_split_bytes(T, S, d, warps)
        if need <= SMEM_PER_CTA - STATIC_SMEM:
            return per_lane, warps, T, S, need
    raise ValueError(f"rows of {d} floats: no ring of the split kernel "
                     "fits one CTA's shared memory")


@functools.lru_cache(maxsize=64)
def dcd_dense_plan(b: int, d: int, wide: bool = False,
                   shards: int = 1, tasks: int = 1,
                   pods: int = 1) -> DensePlan:
    """Pick B2's variant for a block of ``b`` ids over rows of ``d``
    floats, by shape.  The block takes the staged kernel when it holds
    at most ``DENSE_STAGED_MAX_IDS`` ids, d is at most
    ``DENSE_STAGED_MAX_D`` (one warp keeps w in registers) and the rows
    fit the shared memory one CTA can use; any other block of rows of at
    most ``DENSE_STAGED_MAX_D`` floats the stream kernel; rows of at most
    ``DENSE_SPLIT_MAX_D`` floats the split kernel (``dcd_split_layout``);
    wider rows, or ``wide`` asking for it, the wide kernel.  For staged
    and stream, ``per_lane`` is the power of two of w's words a lane
    holds (at least ⌈d / 32⌉).  ``shards``
    data shards of each of ``tasks`` tasks run ``b`` ids each, a CTA a
    (task, shard) pair (of ``pods`` pods: a (task, pod, shard) triple),
    each CTA laid out as the binary plan's."""
    b, d, shards = max(int(b), 1), max(int(d), 1), max(int(shards), 1)
    tasks, pods = max(int(tasks), 1), max(int(pods), 1)
    if not wide and d <= DENSE_STAGED_MAX_D:
        per_lane = _pow2_at_least(-(-d // WARP))
        need = dcd_dense_staged_bytes(b, d)
        if (b <= DENSE_STAGED_MAX_IDS
                and need <= SMEM_PER_CTA - STATIC_SMEM):
            return DensePlan("staged", DENSE_STAGED_THREADS, per_lane, need,
                             shards, tasks, pods)
        T, S = DENSE_STREAM_ROWS, DENSE_STREAM_STAGES
        return DensePlan("stream", 2 * WARP, per_lane,
                         dcd_dense_stream_bytes(T, S, d), shards, tasks,
                         pods, T, S)
    if not wide and d <= DENSE_SPLIT_MAX_D:
        per_lane, warps, T, S, need = dcd_split_layout(d)
        return DensePlan("split", WARP * (warps + 1), per_lane, need,
                         shards, tasks, pods, T, S, warps)
    return DensePlan("wide", cta_threads(d), 0, 0, shards, tasks, pods)


# B3 stream: one CTA of a consumer warp (w in registers, at most
# DENSE_ENTRIES_PER_LANE words a lane) and a producer warp that streams the
# rows through a ring of TILE_STREAM_STAGES stages of at most
# TILE_STREAM_ROWS rows (a multiple of 4, so that a stage's copies are
# whole 16-byte units)
TILE_STREAM_ROWS = 256
TILE_STREAM_STAGES = 2
TILE_STREAM_THREADS = 2 * WARP


class TilePlan(NamedTuple):
    """B3's launch for an in-order epoch over n rows of ``d`` floats:
    ``variant`` "stream" (rows streamed through a ring of ``stages``
    stages of ``tile_rows`` rows in shared memory, w in the registers of
    one warp, ``per_lane`` words a lane), "split" (B2's split kernel over
    rows 0..n-1: w over the registers of ``warps`` consumer warps) or
    "wide" (rows and w in device memory, one update at a time across
    ``threads``).  ``smem_bytes`` is the kernel's dynamic shared memory
    (0 for wide)."""

    variant: str
    threads: int
    per_lane: int
    tile_rows: int
    stages: int
    smem_bytes: int
    warps: int = 0


def dcd_tile_stream_bytes(tile_rows: int, stages: int, d: int) -> int:
    """Shared memory of B3's stream kernel: each of ``stages`` stages
    holds two mbarriers ("full" and "empty", 8 bytes each) and
    ``tile_rows`` rows of d floats with their α and q."""
    return stages * (16 + 4 * tile_rows * (d + 2))


@functools.lru_cache(maxsize=64)
def dcd_tile_plan(n: int, d: int, wide: bool = False) -> TilePlan:
    """Pick B3's variant for an in-order epoch over ``n`` rows of ``d``
    floats, by shape.  Rows of at most ``DENSE_STAGED_MAX_D`` floats (one
    warp keeps w in registers) take the stream kernel, rows of at most
    ``DENSE_SPLIT_MAX_D`` the split kernel (``dcd_split_layout``), wider
    ones, or all when ``wide`` asks for it, the wide kernel.  A stream
    stage holds
    ``TILE_STREAM_ROWS`` rows, or fewer where n is smaller or the ring of
    ``TILE_STREAM_STAGES`` stages would not fit the shared memory one CTA
    can use (the largest multiple of 4 that fits); ``per_lane`` is the
    power of two of w's words a lane holds (at least ⌈d / 32⌉)."""
    n, d = max(int(n), 1), max(int(d), 1)
    if wide or d > DENSE_SPLIT_MAX_D:
        return TilePlan("wide", cta_threads(d), 0, 0, 0, 0)
    if d > DENSE_STAGED_MAX_D:
        per_lane, warps, T, S, need = dcd_split_layout(d)
        return TilePlan("split", WARP * (warps + 1), per_lane, T, S, need,
                        warps)
    stages = TILE_STREAM_STAGES
    fit = (((SMEM_PER_CTA - STATIC_SMEM) // stages - 16)
           // (4 * (d + 2))) // 4 * 4
    rows = min(TILE_STREAM_ROWS, -(-n // 4) * 4, fit)
    return TilePlan("stream", TILE_STREAM_THREADS,
                    _pow2_at_least(-(-d // WARP)), rows, stages,
                    dcd_tile_stream_bytes(rows, stages, d))


# B4: a shard's columns fall into R classes (column c → class c mod R, so
# the zipf-hot low ids spread over all classes), one CTA each; every class
# of every shard writes a (B, B) partial Gram, so R is bounded by the
# partial Grams' words, by one class per GRAM_CLASS_COLS columns (a narrow
# shard needs few) and by the bucket pass's per-warp class counts.
GRAM_PARTIAL_WORDS = 1 << 21
GRAM_CLASS_COLS = 64
GRAM_MAX_CLASSES = 512
GRAM_CHUNK = 1024  # entries of a class staged in shared memory at once
GRAM_TABLE_SLOTS = 2048  # the chunk's column table (≥ 2 slots an entry)
GRAM_WALKERS = 2  # interleaved walkers of each column t of G
GRAM_THREADS = 64 * GRAM_WALKERS  # 64 columns t of G per CTA
GRAM_BUCKET_THREADS = 512
GRAM_TILE_WORDS = 4096  # G accumulator words per walker (B × tile)
# Past GRAM_SHARED_MAX_IDS ids a block's Gram no longer fits the layout
# above (the walkers' (B, tile) accumulators in shared memory, B5's
# recursion in one warp's registers): B4 and B5 take their "rows" layout,
# one column class, G written in tiles of GRAM_ROWS_TILE columns straight
# to device memory by CTAs of GRAM_ROWS_THREADS rows (one a thread), and
# B5's recursion in panels on a cluster of CTAs a (task, data shard) pair
# (its accumulators in shared memory, device memory past that), δ̃ in
# device memory.  What bounds the block then is G itself:
# b² floats for every (task, data, model) triple and their sum.
GRAM_SHARED_MAX_IDS = 1024
GRAM_ROWS_TILE = 64
GRAM_ROWS_THREADS = 256
HBM_BYTES = 80 * 10**9  # the H100's device memory


class GramPlan(NamedTuple):
    """B4's launch for m shards of d1 = d_loc + 1 words, a block of b
    ids and rows of k slots: ``classes`` column classes (one CTA per
    class and shard, and per tile of ``tile`` of G's columns, ``tiles``
    tiles), and the shared memory of the bucket pass and the Gram kernel
    in bytes.  ``data`` data shards of each of ``tasks`` tasks, each
    pair with its own block of b ids and its own view of w, multiply
    the grid and the workspace (``gram_workspace``) and change no CTA's
    layout; so do ``pods`` pods of ``data`` data shards each."""

    classes: int
    tile: int
    tiles: int
    bucket_smem: int
    gram_smem: int
    data: int = 1
    tasks: int = 1
    pods: int = 1
    layout: str = "shared"  # or "rows": past GRAM_SHARED_MAX_IDS ids


def gram_rows_bytes(tile: int, threads: int = GRAM_ROWS_THREADS) -> int:
    """Shared memory of B4's rows-layout Gram kernel: the chunk's column
    table (key, count, run end per slot), a chunk's entries staged
    (column, tile row, value, slot) and sorted (tile row, value), the
    tile rows' offsets (tile + 1), and each thread's accumulators of the
    tile's columns."""
    return (12 * GRAM_TABLE_SLOTS + 24 * GRAM_CHUNK + 4 * (tile + 1)
            + 4 * threads * tile)


def _check_gram_fits(m: int, b: int, pairs: int) -> None:
    """Raise where the block's Gram matrices cannot be allocated: b²
    floats for each of the ``pairs`` (task, data shard) pairs' m
    partials and their sum."""
    need = 4 * b * b * pairs * (m + 1)
    if need > HBM_BYTES:
        raise ValueError(
            f"a block of {b} ids needs {need / 1e9:.1f} GB for its Gram "
            f"matrices (b² floats for each of {pairs} pair(s) × ({m} "
            f"shard partials + their sum)), more than the card's "
            f"{HBM_BYTES / 1e9:.0f} GB")


@functools.lru_cache(maxsize=64)
def gram_plan(m: int, b: int, k: int, d1: int, data: int = 1,
              tasks: int = 1, pods: int = 1, m_all: int = 0) -> GramPlan:
    """Lay out B4 for a block of ``b`` ids over ``m`` shards of ``d1``
    words and rows of ``k`` slots, for each of ``data`` data shards of
    each of ``tasks`` tasks (the classes depend on m alone, so a (task,
    data shard) pair runs what the binary p = 1 launch runs, with the
    same shared memory a CTA), and of ``pods`` pods.  Past
    ``GRAM_SHARED_MAX_IDS`` ids the layout is "rows" (one class, tiles of
    ``GRAM_ROWS_TILE`` columns, ``gram_rows_bytes``).  Raises if a row is
    too long for the bucket pass to stage in shared memory, or where the
    block's Gram matrices cannot be allocated (``_check_gram_fits``).
    ``m_all`` is the whole mesh's feature shard count where these m are
    one rank's: the classes (and so each partial's summation order)
    follow the mesh's m, so a rank's launch is the one-process launch's,
    shard for shard; 0 means m."""
    m, b, k, d1, data = int(m), int(b), int(k), int(d1), max(int(data), 1)
    m_cls = max(int(m_all), m)
    tasks, pods = max(int(tasks), 1), max(int(pods), 1)
    rows = b > GRAM_SHARED_MAX_IDS
    if rows:
        _check_gram_fits(m, b, tasks * data * pods)
        classes, tile = 1, GRAM_ROWS_TILE
        gram = gram_rows_bytes(tile)
    else:
        classes = max(1, min(GRAM_PARTIAL_WORDS // (m_cls * b * b),
                             -(-d1 // GRAM_CLASS_COLS), GRAM_MAX_CLASSES))
        tile = max(1, min(b, 64, GRAM_TILE_WORDS // b))
        gram = (12 * GRAM_TABLE_SLOTS + 24 * GRAM_CHUNK + 4 * (2 * b + 1)
                + 4 * GRAM_WALKERS * b * tile)
    tiles = -(-b // tile)
    bucket = 4 * (GRAM_BUCKET_THREADS // WARP) * classes + 8 * k
    if bucket > SMEM_PER_CTA - STATIC_SMEM:
        raise ValueError(f"rows of {k} slots are too long for B4: its "
                         f"bucket pass stages a row in {bucket} bytes of "
                         f"shared memory, more than {SMEM_PER_CTA}")
    return GramPlan(classes, tile, tiles, bucket, gram, data, tasks, pods,
                    "rows" if rows else "shared")


# B5: one CTA per column class of B4's plan and per shard; it stages the
# block's ids and, when it fits, G, and applies its class's entries from
# a chunk of FEATURE_UPDATE_CHUNK staged at a time
FEATURE_UPDATE_THREADS = 128
FEATURE_UPDATE_CHUNK = 2048
# The rows layout's recursion: panels of FEATURE_ROWS_PANEL steps on a
# serial warp, FEATURE_ROWS_WORKERS worker warps for the trailing update
# (FEATURE_ROWS_COLS columns of G a lane a tile), a producer warp
# streaming G through a ring of FEATURE_ROWS_STAGES stages; the serial
# warp's ring of FEATURE_ROWS_BLOCKS blocks (its panel's rows,
# FEATURE_ROWS_LOOK columns), FEATURE_ROWS_SIGNALS panels of δ̃ in flight
FEATURE_ROWS_PANEL = 32
FEATURE_ROWS_WORKERS = 8
# the CTA's warps: the serial warp 0 alone on its SM sub-partition (warp
# w issues on sub-partition w mod 4, so warps 4 and 8 idle), the producer
# warp 1, and the FEATURE_ROWS_WORKERS others
FEATURE_ROWS_WARPS = 12
# a (task, data shard) pair's recursion runs on a thread-block cluster of
# FEATURE_ROWS_CLUSTER CTAs, each streaming its share of G's tiles
FEATURE_ROWS_CLUSTER = 4
FEATURE_ROWS_COLS = 2
FEATURE_ROWS_STAGES = 2
FEATURE_ROWS_BLOCKS = 3
FEATURE_ROWS_LOOK = 64
FEATURE_ROWS_SIGNALS = 8


class FeatureUpdatePlan(NamedTuple):
    """B5's launch for m shards of d1 words, a block of b ids and rows
    of k slots: ``classes`` CTAs per shard (B4's column classes, whose
    buckets it reads), ``threads`` per CTA, ``per_lane`` accumulators a
    lane of the recursion warp holds (a power of two ≥ ⌈b / 32⌉),
    whether G is staged in shared memory (``stage_gram``; else its row
    t is read from device memory a step ahead), and the dynamic shared
    memory in bytes.  ``data`` data shards of each of ``tasks`` tasks
    multiply the grid to R × tasks × data × m CTAs, each laid out as the
    binary plan's.  The rows layout's recursion (``feature_rows_bytes``)
    runs panels of ``panel`` steps on a cluster of ``cluster`` CTAs a
    pair, each with ``workers`` worker warps and a ring of ``stages``
    stages of G, its accumulators in shared memory when ``acc_shared``."""

    classes: int
    threads: int
    per_lane: int
    stage_gram: bool
    smem_bytes: int
    data: int = 1
    tasks: int = 1
    pods: int = 1
    layout: str = "shared"  # or "rows": past GRAM_SHARED_MAX_IDS ids
    panel: int = 0
    workers: int = 0
    stages: int = 0
    acc_shared: bool = False
    cluster: int = 0


def feature_update_bytes(b: int, stage_gram: bool,
                         chunk: int = FEATURE_UPDATE_CHUNK) -> int:
    """Shared memory of B5: G when staged (b² floats), a chunk of
    entries (local column, value), ten b-word id arrays (id, seed α, q,
    y, act, base, running α, δ̃, previous and last occurrence), and the
    rows' segment offsets (b + 1) and starts (b)."""
    return (4 * b * b if stage_gram else 0) + 8 * chunk + 4 * (12 * b + 1)


def feature_rows_bytes(b: int, stages: int, workers: int,
                       acc_shared: bool,
                       cluster: int = FEATURE_ROWS_CLUSTER) -> int:
    """Shared memory of a CTA of B5's rows-layout recursion: the
    mbarriers (full and empty a stage, one a serial block, three a δ̃
    panel in flight), padded to 16 bytes; ``stages`` stages of
    ``FEATURE_ROWS_PANEL`` rows of a tile of TC = 32·``workers``·
    ``FEATURE_ROWS_COLS`` columns of G (windows of ``row_slot`` words,
    then a window offset a row); the serial warp's
    ``FEATURE_ROWS_BLOCKS`` blocks (its panel's rows,
    ``FEATURE_ROWS_LOOK`` columns, the same way);
    ``FEATURE_ROWS_SIGNALS`` panels of δ̃ and as many look-ahead columns;
    and, when ``acc_shared``, the accumulators of the CTA's share of the
    tiles (tile x is CTA x mod ``cluster``'s)."""
    P, TC = FEATURE_ROWS_PANEL, WARP * workers * FEATURE_ROWS_COLS
    bars = 8 * (2 * stages + FEATURE_ROWS_BLOCKS + 3 * FEATURE_ROWS_SIGNALS)
    stage = P * row_slot(TC) + P
    block = P * row_slot(FEATURE_ROWS_LOOK) + P
    acc = -(-(-(-int(b) // TC)) // cluster) * TC
    return (-(-bars // 16) * 16 + 4 * stages * stage
            + 4 * FEATURE_ROWS_BLOCKS * block + 8 * FEATURE_ROWS_SIGNALS * P
            + (4 * acc if acc_shared else 0))


@functools.lru_cache(maxsize=64)
def feature_update_plan(m: int, b: int, k: int, d1: int, data: int = 1,
                        tasks: int = 1, pods: int = 1,
                        m_all: int = 0) -> FeatureUpdatePlan:
    """Lay out B5 for a block of ``b`` ids over ``m`` shards of ``d1``
    words and rows of ``k`` slots, for each of ``data`` data shards of
    each of ``tasks`` tasks: B4's classes, and G staged when the whole
    layout fits the shared memory one CTA can use (one CTA runs one
    task's recursion, so the layout does not depend on the counts).
    Past ``GRAM_SHARED_MAX_IDS`` ids the layout is "rows": a cluster of
    ``FEATURE_ROWS_CLUSTER`` CTAs a pair runs the recursion in panels of
    ``FEATURE_ROWS_PANEL`` steps (a serial warp in the first, and in
    each a producer warp streaming its share of G and
    ``FEATURE_ROWS_WORKERS`` worker warps, ``FEATURE_ROWS_WARPS`` warps in
    all; no lane registers, ``per_lane`` 0), its accumulators in shared
    memory where they fit beside the ring (``acc_shared``) and in device
    memory past that; then the scatter.  ``m_all``: as for
    ``gram_plan``."""
    classes = gram_plan(m, b, k, d1, data, tasks, pods, m_all).classes
    if int(b) > GRAM_SHARED_MAX_IDS:
        S, NW = FEATURE_ROWS_STAGES, FEATURE_ROWS_WORKERS
        acc_shared = (feature_rows_bytes(b, S, NW, True)
                      <= SMEM_PER_CTA - STATIC_SMEM)
        return FeatureUpdatePlan(
            classes, WARP * FEATURE_ROWS_WARPS, 0, False,
            feature_rows_bytes(b, S, NW, acc_shared), max(int(data), 1),
            max(int(tasks), 1), max(int(pods), 1), "rows",
            FEATURE_ROWS_PANEL, NW, S, acc_shared, FEATURE_ROWS_CLUSTER)
    stage = feature_update_bytes(b, True) <= SMEM_PER_CTA - STATIC_SMEM
    return FeatureUpdatePlan(classes, FEATURE_UPDATE_THREADS,
                             _pow2_at_least(-(-int(b) // WARP)), stage,
                             feature_update_bytes(b, stage),
                             max(int(data), 1), max(int(tasks), 1),
                             max(int(pods), 1))


class SolverMesh(NamedTuple):
    """A solver mesh as named axes and their sizes — the shape of the
    reference's ``jax.sharding.Mesh``.  The sizes are the global shard
    counts (P pods, p data shards, m feature shards).  ``device_mesh``,
    when set, is a ``torch.distributed.device_mesh.DeviceMesh`` over the
    process group's ranks whose dimension names are solver axes: each
    axis's shards are split contiguously over its ranks
    (``rank_layout``).  Without one every shard is virtual, on this
    process."""

    axis_names: tuple
    axis_sizes: tuple
    device_mesh: object = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def _live_world() -> int:
    """The world size of an initialised process group that communicates
    (0 without one; the dry-run's ``fake`` group does not count)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0
    if dist.get_backend() == "fake":
        return 0
    return dist.get_world_size()


def _check_rank_counts(shape: dict, ranks: dict) -> None:
    """Each axis's rank count divides its shard count."""
    for a, r in ranks.items():
        if a not in ("pod", "data", "model"):
            raise ValueError(f"the solver spreads 'pod', 'data' and "
                             f"'model' over ranks, not {a!r}")
        if r < 1 or shape[a] % r:
            raise ValueError(f"the {a!r} axis of {shape[a]} shards does "
                             f"not divide over {r} ranks")


def with_ranks(mesh: SolverMesh, ranks: dict) -> SolverMesh:
    """``mesh`` spread over the initialised process group: ``ranks``
    maps solver axes to their rank counts, whose product is the world
    size, laid out row-major in the mesh's axis order (a
    ``DeviceMesh`` from ``init_device_mesh``: ``cuda`` under ``nccl``,
    ``cpu`` under ``gloo``, which the layer feeds either tensor).  Each
    count must divide its axis."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    unknown = [a for a in ranks if a not in mesh.axis_names]
    if unknown:
        raise ValueError(f"ranks on {unknown}, which the mesh "
                         f"{tuple(mesh.axis_names)} does not have")
    names = tuple(a for a in mesh.axis_names if a in ranks)
    sizes = tuple(int(ranks[a]) for a in names)
    _check_rank_counts(mesh.shape, dict(zip(names, sizes)))
    world = _live_world()
    if math.prod(sizes) != world:
        raise ValueError(f"ranks {dict(zip(names, sizes))} make "
                         f"{math.prod(sizes)} processes; the process "
                         f"group has {world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return mesh._replace(device_mesh=init_device_mesh(
        kind, sizes, mesh_dim_names=names))


class RankLayout(NamedTuple):
    """This process's place on a solver mesh spread over ranks: the
    ``DeviceMesh``, the rank count of each axis it spreads (``ranks``;
    an axis not named is virtual, all its shards here) and this rank's
    coordinate on it (``coord``).  An axis of S shards over R ranks
    gives coordinate r the shards [r·S/R, (r+1)·S/R)."""

    device_mesh: object
    ranks: dict
    coord: dict

    def count(self, axis: str) -> int:
        return self.ranks.get(axis, 1)

    def span(self, axis: str, size: int) -> tuple:
        """(first, count) of this rank's shards of an axis of ``size``."""
        n = size // self.count(axis)
        return self.coord.get(axis, 0) * n, n


def rank_layout(mesh) -> RankLayout | None:
    """The rank layout of a ``SolverMesh``, or None where every shard
    is on this process (no ``DeviceMesh``, or one of a single rank: the
    one-process path).  Raises a ``ValueError`` naming both sizes where
    a ``DeviceMesh`` dimension does not divide its axis."""
    dm = getattr(mesh, "device_mesh", None)
    if dm is None:
        return None
    ranks = mesh_axes(dm)
    for a in ranks:
        if a not in mesh.axis_names:
            raise ValueError(f"the DeviceMesh's {a!r} dimension is not an "
                             f"axis of the solver mesh "
                             f"{tuple(mesh.axis_names)}")
    _check_rank_counts(mesh.shape, ranks)
    if math.prod(ranks.values()) == 1:
        return None
    return RankLayout(dm, {a: r for a, r in ranks.items() if r > 1},
                      {a: dm.get_local_rank(a) for a, r in ranks.items()
                       if r > 1})


def solver_mesh(axis: str = "data", n_devices: int | None = None
                ) -> SolverMesh:
    """The 1-D solver mesh: ``n_devices`` shards along ``axis`` (the
    reference's every local device).  On one process the shards are
    virtual and the count defaults to 1, what the reference runs on one
    chip; under an initialised process group of W > 1 ranks it defaults
    to W, one shard a rank, the mesh spread over the world
    (``with_ranks`` spreads any mesh).  ``axis="data"`` shards the rows
    (p data shards, one CTA each), ``axis="model"`` the features (the
    legacy mesh, run as (data = 1, model = n))."""
    world = _live_world() if n_devices is None else 0
    n = max(world, 1) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be ≥ 1, got {n_devices}")
    mesh = SolverMesh((axis,), (n,))
    return with_ranks(mesh, {axis: world}) if world > 1 else mesh


def solver_mesh_2d(data: int = 1, model: int = 1) -> SolverMesh:
    """The 2-D ``("data", "model")`` mesh of the feature-sharded solver:
    rows block-parallelize along ``data`` (p virtual row shards), w and
    the features shard along ``model`` (m virtual shards on one card)."""
    if int(data) < 1 or int(model) < 1:
        raise ValueError(f"mesh sizes must be ≥ 1, got data={data}, "
                         f"model={model}")
    return SolverMesh(("data", "model"), (int(data), int(model)))


def solver_mesh_tasks(task: int = 2, data: int | None = None,
                      model: int = 1, n_devices: int | None = None
                      ) -> SolverMesh:
    """The mesh with a leading ``task`` axis of the multi-task
    (one-vs-rest) solver: the K tasks share one X while the per-class
    (α, w) stacks split their leading (K,) axis over ``task``.  On one
    card the task shards are virtual, like the data shards: the K tasks
    run as a task dimension of the same launches whatever the axis's
    size, which only admits K (``task_axis_policy``).  ``data`` defaults
    to ``n_devices // (task · model)`` (1 without ``n_devices``);
    ``model > 1`` appends the feature axis as ``solver_mesh_2d``
    does."""
    if data is None:
        data = (1 if n_devices is None
                else max(int(n_devices) // (int(task) * int(model)), 1))
    if int(task) < 1 or int(data) < 1 or int(model) < 1:
        raise ValueError(f"mesh sizes must be ≥ 1, got task={task}, "
                         f"data={data}, model={model}")
    if int(model) > 1:
        return SolverMesh(("task", "data", "model"),
                          (int(task), int(data), int(model)))
    return SolverMesh(("task", "data"), (int(task), int(data)))


def task_axis_policy(n_tasks: int, *, mesh, pipeline: bool = True) -> int:
    """The reference's admission rule for the multi-task task axis, its
    messages word for word: K ≥ 1; ``pipeline=True`` (the host driver
    has no per-task carry); a ``task`` mesh axis needs K divisible by
    its size and does not compose with a ``pod`` axis.  Returns the
    validated K."""
    K = int(n_tasks)
    if K < 1:
        raise ValueError(f"n_tasks must be >= 1, got {n_tasks}")
    if not pipeline:
        raise ValueError(
            "a multi-task solve needs pipeline=True — the per-task "
            "state (α/w stacks, latches, record buffers) lives in the "
            "on-device epoch-scan carry; the host driver path has no "
            "carry to put it in")
    if "task" in mesh.axis_names:
        t = mesh.shape["task"]
        if K % t:
            raise ValueError(
                f"n_tasks={K} does not divide over the task mesh axis "
                f"of size {t} — the per-class state stack must shard "
                "evenly (no padding classes)")
        if "pod" in mesh.axis_names:
            raise ValueError(
                "a 'task' mesh axis does not compose with a 'pod' axis "
                "— run one multi-task solve per pod instead")
    return K


def solver_mesh_3d(pod: int = 2, data: int | None = None, model: int = 1,
                   n_devices: int | None = None) -> SolverMesh:
    """The 3-D ``(pod, data, model)`` mesh of the pod solver (Hybrid-DCA):
    each pod runs the pipelined 1-D or 2-D solve on its own contiguous
    row shard — rows over ``data``, features over ``model``, both
    pod-local — while the ``pod`` axis carries only the per-epoch merge
    of the pods' Δw, which ``pod_delay_rounds`` may keep in flight.  On
    one card every axis is virtual: P·p CTAs (or CTA groups) a round.
    The mesh always carries ``model`` (the 2-D solver, even at m = 1), as
    the reference's does; a 1-D pod mesh is ``SolverMesh(("pod",
    "data"), (P, p))``.  ``data`` defaults to ``n_devices // (pod ·
    model)`` (1 without ``n_devices``)."""
    if data is None:
        data = (1 if n_devices is None
                else max(int(n_devices) // (int(pod) * int(model)), 1))
    if int(pod) < 1 or int(data) < 1 or int(model) < 1:
        raise ValueError(f"mesh sizes must be ≥ 1, got pod={pod}, "
                         f"data={data}, model={model}")
    return SolverMesh(("pod", "data", "model"),
                      (int(pod), int(data), int(model)))


def pod_merge_policy(pod_delay_rounds: int, *, n_pods: int,
                     pipeline: bool = True, record: bool = True,
                     shrink_every: int = 0, adaptive: bool = False,
                     overlap="auto") -> int:
    """The reference's admission and staleness rule for the cross-pod
    merge, its messages word for word.  ``pod_delay_rounds = k`` lets the
    merge issued at outer round t land at t + k (a FIFO of k in-flight
    scaled Δw sums); k = 0 is the synchronous CoCoA outer round.  Raises
    for k < 0, ``n_pods`` < 1, ``pipeline=False``, ``shrink_every``,
    ``overlap=True`` and ``adaptive`` without ``record``.  Returns the
    validated k."""
    k = int(pod_delay_rounds)
    if k < 0:
        raise ValueError(
            f"pod_delay_rounds must be >= 0, got {pod_delay_rounds}")
    if int(n_pods) < 1:
        raise ValueError(f"n_pods must be >= 1, got {n_pods}")
    if not pipeline:
        raise ValueError(
            "a pod mesh needs pipeline=True — the cross-pod merge scan "
            "(and its in-flight delayed aggregates) lives in the "
            "on-device epoch-scan carry; the host driver path has no "
            "carry to put it in")
    if shrink_every:
        raise ValueError(
            "shrink_every is not composed with the pod merge loop — "
            "the active mask needs the dyn round scan, which the pod "
            "path's static inner rounds do not run")
    if overlap is True:
        raise ValueError(
            "overlap=True is not composed with the pod merge loop — "
            "the in-flight (base, Gram) psum is only valid under the "
            "plain epoch schedule, not the merge-rescaled one; leave "
            "overlap='auto'")
    if adaptive and not record:
        raise ValueError(
            "adaptive=True needs record=True — the pod-level anneal "
            "latch reads the on-device duality-gap buffer as its input "
            "signal")
    return k


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``SolverMesh`` or of a
    ``torch.distributed.device_mesh.DeviceMesh`` (its
    ``mesh_dim_names``), in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, (mesh.shape[a]
                                      for a in mesh.axis_names)))


def data_axes(mesh) -> tuple:
    """Axes that form the data-parallel dimension."""
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def dp_size(mesh) -> int:
    """The data-parallel shard count: the product of ``data_axes``."""
    axes = mesh_axes(mesh)
    return math.prod(axes[a] for a in data_axes(mesh))


# ------------------------------------------------ the production mesh ----


def make_fake_mesh(shape, axis_names):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over a ``fake``
    process group of prod(shape) ranks, this process rank 0 — the
    counterpart of the reference's placeholder CPU devices.  Its
    collectives move nothing; a tensor on it is this rank's shard.

    A ``fake`` default group of another world size is replaced (the
    dry-run alternates 256 and 512 ranks); any other initialised group
    of another size raises, and is never replaced."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if dist.is_initialized():
        if dist.get_world_size() != n:
            if dist.get_backend() != "fake":
                raise RuntimeError(
                    f"a {dist.get_backend()} process group of "
                    f"{dist.get_world_size()} ranks is initialised; the "
                    f"{tuple(shape)} mesh needs {n}")
            dist.destroy_process_group()
    if not dist.is_initialized():
        # registers torch's "fake" backend (no communication: every
        # rank's collectives are shape-only)
        import torch.testing._internal.distributed.fake_pg  # noqa: F401

        dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                                world_size=n)
    return init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_rank_mesh(shape, axis_names, *, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over the
    initialised default process group, one rank a mesh point (row-major
    in the group's ranks) — the live counterpart of ``make_fake_mesh``,
    on which DTensors hold real values and collectives move them.  Its
    device type is ``device``'s (the card unless the caller asks for
    the CPU); gloo feeds either.  Raises where no group is initialised,
    where the group is the dry-run's ``fake`` one, or where its world
    size is not prod(shape)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    world = _live_world()
    if world == 0:
        raise RuntimeError(f"the {tuple(shape)} mesh needs an initialised "
                           f"process group of {n} ranks; there is none")
    if world != n:
        raise ValueError(f"the {tuple(shape)} mesh needs {n} ranks; the "
                         f"{dist.get_backend()} process group has {world}")
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (data=16, model=16) = 256 cards.  Multi-pod: (pod=2,
    data=16, model=16) = 512; the ``pod`` axis composes with ``data`` for
    the data-parallel gradient reduction.  A ``DeviceMesh`` over a
    ``fake`` group (``make_fake_mesh``): the dry-run counts one card's
    share of a cell on it without a card or a byte of device memory."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_fake_mesh((16, 16), ("data", "model"))


def pipeline_overlap(overlap, *, two_d: bool, fused: bool,
                     delay_rounds: int) -> bool:
    """Resolve the solver's ``overlap`` knob ∈ {False, True, "auto"} —
    whether the 2-D block round double-buffers its ``model``-axis
    (base, Gram) psum behind the next block's gram kernel (DESIGN.md
    §11).  When a round pipelines is *distribution* policy.

    The overlapped round needs (a) the fused 2-D engine, whose split
    gram/update phases expose an aggregate that can stay in flight — the
    unfused engine psums per update and the 1-D meshes have no
    ``model``-axis psum at all — and (b) ``delay_rounds ≥ 1``, the
    staleness bookkeeping (carried in-flight Δw) the overlapped schedule
    piggybacks on.  ``"auto"`` enables it exactly there; forcing ``True``
    elsewhere raises rather than silently changing semantics."""
    if overlap == "auto":
        return bool(two_d and fused and delay_rounds >= 1)
    overlap = bool(overlap)
    if not overlap:
        return False
    if not two_d:
        raise ValueError(
            "overlap=True needs a 2-D ('data', 'model') mesh — a 1-D "
            "mesh has no model-axis psum to double-buffer")
    if not fused:
        raise ValueError(
            "overlap=True needs the fused kernel path (use_kernel=True "
            "or an admitting 'auto') — only the split gram/update "
            "phases expose a (base, Gram) aggregate to keep in flight")
    if delay_rounds < 1:
        raise ValueError(
            "overlap=True needs delay_rounds >= 1 — the overlapped "
            "round carries its aggregates with the delayed-round "
            "bookkeeping")
    return True


def adaptive_delay_policy(gap_prev, gap_new, *, improve_ratio: float = 0.95):
    """The gap-trend controller of the adaptive delay: 1 (the delayed
    round, one round of staleness) while the gap improves by at least
    ``1 − improve_ratio`` from one record to the next, 0 (synchronous)
    once it stalls or rises.  Elementwise on tensors, so the solver
    keeps the flag on the device; returns int32 0/1.  The solver applies
    it through a one-way latch (it only ever lowers the carried flag)."""
    return (gap_new <= improve_ratio * gap_prev).to(torch.int32)


def watchdog_trip(gap_prev, gap_new, eps_prev, eps_new, n_bad, *,
                  blowup: float = 4.0, floor: float = 1e-3):
    """The divergence watchdog of the segmented solve, the reference's
    rule: from the last *healthy* record's (gap, ε) — +inf before the
    first, which then only sets the baseline — the fresh record and
    ``n_bad``, the count of non-finite entries in (α, ŵ), an int32 code
    a task:

      0  healthy — the record becomes the next baseline;
      1  divergence trend — the gap or ε past ``blowup`` × its last
         healthy value + ``floor`` (the floor keeps float noise around a
         converged ε of ~1e-7 from tripping; a dropped or doubled pod
         merge moves ε by O(‖Δw‖));
      2  non-finite — anything NaN/Inf in α, ŵ, the gap or ε.

    Elementwise torch ops on (K,) tensors: the solver keeps the code on
    the device and latches its max, and the host reads it once a
    segment."""
    nonfin = ((n_bad > 0) | ~torch.isfinite(gap_new)
              | ~torch.isfinite(eps_new))
    div = ((gap_new > blowup * gap_prev + floor)
           | (eps_new > blowup * eps_prev + floor))
    return torch.where(nonfin, 2, torch.where(div, 1, 0)).to(torch.int32)


def degrade_ladder(rung: int, *, delay_rounds: int, pod_delay_rounds: int,
                   overlap) -> dict:
    """Which asynchrony a retry of a tripped segment may keep, the
    reference's ladder.  Rung 0 replays with the solve's own knobs (a
    transient fault: the replay from the healthy boundary is the
    fault-free solve bit for bit).  Rung 1, once a same-knob replay trips
    again, is synchronous: ``delay_rounds`` 0, the pod FIFO drained
    (``pod_delay_rounds`` 0) and no overlap — every source of staleness
    removed.  Rungs are sticky and the retries bounded; past them the
    solve raises ``SolverDiverged``."""
    if rung <= 0:
        return {"rung": 0, "delay_rounds": int(delay_rounds),
                "pod_delay_rounds": int(pod_delay_rounds),
                "overlap": overlap}
    return {"rung": 1, "delay_rounds": 0, "pod_delay_rounds": 0,
            "overlap": False}


# --- the serving engine's admission and degradation policy -----------
#
# What load the serving engine may admit and how it backs off under
# pressure decides how much work reaches the card per dispatch, so it
# is distribution policy, the reference's rules word for word; the
# engine in ``repro_torch.serve`` only consumes them.


def serve_admission_policy(*, queue_depth: int, max_batch: int,
                           deadline_s: float, swap_grace_s: float) -> dict:
    """Validate and normalise the serving admission knobs.
    ``queue_depth`` bounds the request queue (past it, offers are refused
    and the caller sheds with a backpressure outcome); ``max_batch`` is
    the scoring dispatch's fixed batch shape (the degrade ladder lowers
    only the live count); ``deadline_s`` is the default per-request
    deadline; ``swap_grace_s`` bounds how long a publish waits for pinned
    readers to drain (stragglers finish on the old snapshot)."""
    depth, batch = int(queue_depth), int(max_batch)
    if depth < 1:
        raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
    if batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if not (float(deadline_s) > 0.0):
        raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
    if float(swap_grace_s) < 0.0:
        raise ValueError(
            f"swap_grace_s must be >= 0, got {swap_grace_s}")
    return {"queue_depth": depth, "max_batch": batch,
            "deadline_s": float(deadline_s),
            "swap_grace_s": float(swap_grace_s)}


def serve_rung(occupancy: float, prev_rung: int = 0, *,
               up: tuple = (0.5, 0.85),
               down: tuple = (0.2, 0.6)) -> int:
    """The rung of ``serve_degrade_ladder`` for a queue fill
    ``occupancy`` ∈ [0, 1], with hysteresis: climb to rung r + 1 while
    occupancy ≥ ``up[r]``, descend to r − 1 only once it has fallen
    below ``down[r − 1]``.  Not sticky: overload is a load condition,
    not a fault."""
    occ = float(occupancy)
    r = int(prev_rung)
    if not (0 <= r <= len(up)):
        raise ValueError(f"prev_rung out of range: {prev_rung}")
    while r < len(up) and occ >= up[r]:
        r += 1
    while r > 0 and occ < down[r - 1]:
        r -= 1
    return r


def serve_degrade_ladder(rung: int, *, max_batch: int) -> dict:
    """Which throughput knobs each pressure rung keeps.  Rung 0 is full
    service (the whole ``max_batch``, incremental training allowed);
    rung 1 scores ``max_batch // 4`` live rows a dispatch (the shape is
    unchanged) so deadlines are shed at a finer cadence; rung 2 also
    pauses incremental training and answers from the last healthy
    snapshot only.  Rungs above 2 clamp to 2."""
    r = max(0, min(int(rung), 2))
    if int(max_batch) < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    live = int(max_batch) if r == 0 else max(1, int(max_batch) // 4)
    return {"rung": r, "max_batch": live, "train": r < 2}


def drift_trip(err_base, err_new, *, ratio: float = 2.0,
               floor: float = 0.05):
    """The drift trigger of the warm-start re-solve, the serving twin of
    ``watchdog_trip``: 1 where the published model's error on freshly
    ingested rows ``err_new`` exceeds ``ratio`` × its error on the data
    it was trained on plus ``floor`` (the floor keeps noise on a
    near-perfect baseline from tripping), else 0.  Elementwise float32
    torch ops; returns int32 (0-d for scalar inputs)."""
    base = torch.as_tensor(err_base, dtype=torch.float32)
    new = torch.as_tensor(err_new, dtype=torch.float32)
    return (new > ratio * base + floor).to(torch.int32)


class SelfTuning(NamedTuple):
    """Resolved self-tuning configuration of one solve (see
    ``resolve_self_tuning``)."""

    shrink_every: int
    repack: bool
    adaptive: bool
    overlap: bool


def resolve_self_tuning(shrink_every, repack, adaptive, *, overlap_knob,
                        overlap_on: bool, pipeline: bool,
                        record: bool) -> SelfTuning:
    """Resolve and validate the solver's self-tuning knobs, the
    reference's rule word for word.  ``shrink_every`` ∈ {0 = off, k ≥ 1}
    recomputes the active mask every k epochs; ``repack`` ∈ {False,
    True, "auto"} draws the epochs whose active fraction is below the
    threshold over the compacted active set; ``adaptive`` runs the
    gap-trend delay controller, which reads the recorded gap.  The
    overlapped 2-D round keeps a (base, Gram) in flight that holds only
    for the block sequence it was issued against, so ``overlap="auto"``
    resolves off under shrinking or the adaptive delay, while an
    explicit ``overlap=True`` keeps plain masked shrinking and rejects
    repack and the adaptive delay."""
    every = int(shrink_every or 0)
    if every < 0:
        raise ValueError(f"shrink_every must be >= 0, got {shrink_every}")
    adaptive = bool(adaptive)
    if (every or adaptive) and not pipeline:
        raise ValueError(
            "shrink_every/adaptive need pipeline=True — the active mask "
            "and delay flag live in the on-device epoch-scan carry; the "
            "host driver path has no carry to put them in")
    if adaptive and not record:
        raise ValueError(
            "adaptive=True needs record=True — the gap-trend controller "
            "reads the on-device duality-gap buffer as its input signal")
    if repack not in (False, True, "auto"):
        raise ValueError(f"repack must be False/True/'auto', got {repack!r}")
    if repack is True and not every:
        raise ValueError("repack=True needs shrink_every >= 1 — there is "
                         "no active set to compact without shrinking")
    if overlap_on and (every or adaptive):
        if overlap_knob == "auto":
            overlap_on = False
        elif repack is True or adaptive:
            raise ValueError(
                "overlap=True is incompatible with repack/adaptive — the "
                "in-flight (base, Gram) psum is only valid for a fixed "
                "block sequence under a fixed delay schedule")
    if repack == "auto":
        repack = bool(every) and not overlap_on
    if repack and overlap_on:
        raise ValueError(
            "repack=True is incompatible with the overlapped schedule — "
            "the repacked draw changes the block sequence the in-flight "
            "gram was issued against")
    return SelfTuning(every, bool(repack), adaptive, overlap_on)

"""Device, mesh and launch-width policy of the port — the counterpart of
the part of ``repro/dist/mesh.py`` the ported slices use.

``resolve_device`` is where every entry point decides where it runs:
on the card unless the caller asks for the CPU, and never quietly on the
CPU when the card is missing.  ``SolverMesh`` names the solver's axes
and their sizes, without devices: on one card the reference's ``model``
axis becomes m virtual feature shards, a leading tensor dimension.
``pipeline_overlap`` is the reference's rule for the overlapped 2-D
round.  ``lane_pad`` and ``cta_threads`` size a kernel's thread block.
The reference's 128-lane padding of d and k is TPU tiling, not
semantics: the CUDA kernels take any width, so the port pads nothing but
the thread count, which rounds up to whole warps.

The reference admits a shape to a kernel by its VMEM footprint
(``*_kernel_fits``); the port's counterparts size the kernels' shared
memory against the 227 KB one CTA can use on Hopper: ``dcd_ell_plan``
picks B1's variant (the block staged in shared memory, or the wide
kernel that reads its rows from device memory), ``dcd_dense_plan``
picks B2's (the block's dense rows staged, or the wide kernel),
``dcd_tile_plan`` B3's (the rows streamed through a ring of stages, or
the wide kernel),
``gram_plan`` lays out B4's column classes, CTAs and workspace, and
``feature_update_plan`` B5's (one CTA per class and shard, G staged in
shared memory when it fits).
"""

from __future__ import annotations

import functools
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


class EllPlan(NamedTuple):
    """B1's launch for a block of ``b`` ids over rows of ``k`` slots:
    ``variant`` "staged" (the block's rows, a column table of
    ``table_slots`` entries and the ids' α, q, y, act in shared memory)
    or "wide" (rows and w in device memory, one update at a time across
    ``threads``).  ``smem_bytes`` is the staged kernel's dynamic shared
    memory (0 for wide)."""

    variant: str
    threads: int
    table_slots: int
    smem_bytes: int


def dcd_ell_staged_bytes(b: int, k: int, table_slots: int) -> int:
    """Shared memory of B1's staged kernel: the column table (key and w
    per slot), the block's b·k (slot, value) pairs, and eight b-word id
    arrays (id, α, q, y, act, running α, previous occurrence, repeated
    column)."""
    return 8 * table_slots + 8 * b * k + 32 * b


@functools.lru_cache(maxsize=64)
def dcd_ell_plan(b: int, k: int, wide: bool = False) -> EllPlan:
    """Pick B1's variant for a block of ``b`` ids over rows of ``k``
    slots, by shape.  The column table has a power-of-two size of at
    least 1.5 slots per entry (a load ≤ 2/3 under linear probing: every
    real entry may be a distinct column).  The block takes the staged
    kernel when it holds at most ``ELL_STAGED_MAX_IDS`` ids, its rows at
    most ``ELL_STAGED_MAX_SLOTS`` slots (the update warp keeps a row in
    registers) and it fits the 227 KB of shared memory one CTA can use;
    else, or when ``wide`` asks for it, the wide kernel."""
    b, k = max(int(b), 1), max(int(k), 1)
    slots = max(WARP, _pow2_at_least(-(-3 * b * k // 2)))
    need = dcd_ell_staged_bytes(b, k, slots)
    if (not wide and b <= ELL_STAGED_MAX_IDS and k <= ELL_STAGED_MAX_SLOTS
            and need <= SMEM_PER_CTA - STATIC_SMEM):
        return EllPlan("staged", ELL_STAGED_THREADS, slots, need)
    return EllPlan("wide", cta_threads(k), 0, 0)


# B2 staged: ids per block (its repeat scan is O(B²) per block), the CTA
# that stages the block (the updates run on one warp of it, which holds w
# in registers, DENSE_ENTRIES_PER_LANE words a lane at most)
DENSE_STAGED_MAX_IDS = 1024
DENSE_STAGED_THREADS = 256
DENSE_ENTRIES_PER_LANE = 8
DENSE_STAGED_MAX_D = WARP * DENSE_ENTRIES_PER_LANE


class DensePlan(NamedTuple):
    """B2's launch for a block of ``b`` ids over dense rows of ``d``
    floats: ``variant`` "staged" (the block's rows and the ids' α, q, y,
    act in shared memory, w in the registers of one warp, ``per_lane``
    words a lane) or "wide" (rows and w in device memory, one update at
    a time across ``threads``).  ``smem_bytes`` is the staged kernel's
    dynamic shared memory (0 for wide)."""

    variant: str
    threads: int
    per_lane: int
    smem_bytes: int


def dcd_dense_staged_bytes(b: int, d: int) -> int:
    """Shared memory of B2's staged kernel: the block's b rows of d
    floats and eight b-word id arrays (id, α, q, y, act, running α,
    previous occurrence, last occurrence)."""
    return 4 * b * d + 32 * b


@functools.lru_cache(maxsize=64)
def dcd_dense_plan(b: int, d: int, wide: bool = False) -> DensePlan:
    """Pick B2's variant for a block of ``b`` ids over rows of ``d``
    floats, by shape.  The block takes the staged kernel when it holds
    at most ``DENSE_STAGED_MAX_IDS`` ids, d is at most
    ``DENSE_STAGED_MAX_D`` (one warp keeps w in registers) and the rows
    fit the shared memory one CTA can use; else, or when ``wide`` asks
    for it, the wide kernel.  ``per_lane`` is the power of two of w's
    words a lane holds (at least ⌈d / 32⌉)."""
    b, d = max(int(b), 1), max(int(d), 1)
    need = dcd_dense_staged_bytes(b, d)
    if (not wide and b <= DENSE_STAGED_MAX_IDS and d <= DENSE_STAGED_MAX_D
            and need <= SMEM_PER_CTA - STATIC_SMEM):
        return DensePlan("staged", DENSE_STAGED_THREADS,
                         _pow2_at_least(-(-d // WARP)), need)
    return DensePlan("wide", cta_threads(d), 0, 0)


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
    one warp, ``per_lane`` words a lane) or "wide" (rows and w in device
    memory, one update at a time across ``threads``).  ``smem_bytes`` is
    the stream kernel's dynamic shared memory (0 for wide)."""

    variant: str
    threads: int
    per_lane: int
    tile_rows: int
    stages: int
    smem_bytes: int


def dcd_tile_stream_bytes(tile_rows: int, stages: int, d: int) -> int:
    """Shared memory of B3's stream kernel: each of ``stages`` stages
    holds two mbarriers ("full" and "empty", 8 bytes each) and
    ``tile_rows`` rows of d floats with their α and q."""
    return stages * (16 + 4 * tile_rows * (d + 2))


@functools.lru_cache(maxsize=64)
def dcd_tile_plan(n: int, d: int, wide: bool = False) -> TilePlan:
    """Pick B3's variant for an in-order epoch over ``n`` rows of ``d``
    floats, by shape.  Rows of at most ``DENSE_STAGED_MAX_D`` floats (one
    warp keeps w in registers) take the stream kernel, else, or when
    ``wide`` asks for it, the wide kernel.  A stage holds
    ``TILE_STREAM_ROWS`` rows, or fewer where n is smaller or the ring of
    ``TILE_STREAM_STAGES`` stages would not fit the shared memory one CTA
    can use (the largest multiple of 4 that fits); ``per_lane`` is the
    power of two of w's words a lane holds (at least ⌈d / 32⌉)."""
    n, d = max(int(n), 1), max(int(d), 1)
    if wide or d > DENSE_STAGED_MAX_D:
        return TilePlan("wide", cta_threads(d), 0, 0, 0, 0)
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


class GramPlan(NamedTuple):
    """B4's launch for m shards of d1 = d_loc + 1 words, a block of b
    ids and rows of k slots: ``classes`` column classes (one CTA per
    class and shard, and per tile of ``tile`` of G's columns, ``tiles``
    tiles), and the shared memory of the bucket pass and the Gram kernel
    in bytes."""

    classes: int
    tile: int
    tiles: int
    bucket_smem: int
    gram_smem: int


@functools.lru_cache(maxsize=64)
def gram_plan(m: int, b: int, k: int, d1: int) -> GramPlan:
    """Lay out B4 for a block of ``b`` ids over ``m`` shards of ``d1``
    words and rows of ``k`` slots.  Raises if a row is too long for the
    bucket pass to stage in shared memory."""
    m, b, k, d1 = int(m), int(b), int(k), int(d1)
    classes = max(1, min(GRAM_PARTIAL_WORDS // (m * b * b),
                         -(-d1 // GRAM_CLASS_COLS), GRAM_MAX_CLASSES))
    tile = max(1, min(b, 64, GRAM_TILE_WORDS // b))
    tiles = -(-b // tile)
    bucket = 4 * (GRAM_BUCKET_THREADS // WARP) * classes + 8 * k
    gram = (12 * GRAM_TABLE_SLOTS + 24 * GRAM_CHUNK + 4 * (2 * b + 1)
            + 4 * GRAM_WALKERS * b * tile)
    if bucket > SMEM_PER_CTA - STATIC_SMEM:
        raise ValueError(f"rows of {k} slots are too long for B4: its "
                         f"bucket pass stages a row in {bucket} bytes of "
                         f"shared memory, more than {SMEM_PER_CTA}")
    return GramPlan(classes, tile, tiles, bucket, gram)


# B5: one CTA per column class of B4's plan and per shard; it stages the
# block's ids and, when it fits, G, and applies its class's entries from
# a chunk of FEATURE_UPDATE_CHUNK staged at a time
FEATURE_UPDATE_THREADS = 128
FEATURE_UPDATE_CHUNK = 2048


class FeatureUpdatePlan(NamedTuple):
    """B5's launch for m shards of d1 words, a block of b ids and rows
    of k slots: ``classes`` CTAs per shard (B4's column classes, whose
    buckets it reads), ``threads`` per CTA, ``per_lane`` accumulators a
    lane of the recursion warp holds (a power of two ≥ ⌈b / 32⌉),
    whether G is staged in shared memory (``stage_gram``; else its row
    t is read from device memory a step ahead), and the dynamic shared
    memory in bytes."""

    classes: int
    threads: int
    per_lane: int
    stage_gram: bool
    smem_bytes: int


def feature_update_bytes(b: int, stage_gram: bool,
                         chunk: int = FEATURE_UPDATE_CHUNK) -> int:
    """Shared memory of B5: G when staged (b² floats), a chunk of
    entries (local column, value), ten b-word id arrays (id, seed α, q,
    y, act, base, running α, δ̃, previous and last occurrence), and the
    rows' segment offsets (b + 1) and starts (b)."""
    return (4 * b * b if stage_gram else 0) + 8 * chunk + 4 * (12 * b + 1)


@functools.lru_cache(maxsize=64)
def feature_update_plan(m: int, b: int, k: int, d1: int) -> FeatureUpdatePlan:
    """Lay out B5 for a block of ``b`` ids over ``m`` shards of ``d1``
    words and rows of ``k`` slots: B4's classes, and G staged when the
    whole layout fits the shared memory one CTA can use."""
    classes = gram_plan(m, b, k, d1).classes
    stage = feature_update_bytes(b, True) <= SMEM_PER_CTA - STATIC_SMEM
    return FeatureUpdatePlan(classes, FEATURE_UPDATE_THREADS,
                             _pow2_at_least(-(-int(b) // WARP)), stage,
                             feature_update_bytes(b, stage))


class SolverMesh(NamedTuple):
    """A solver mesh as named axes and their sizes — the shape of the
    reference's ``jax.sharding.Mesh``, with no devices behind it."""

    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def solver_mesh_2d(data: int = 1, model: int = 1) -> SolverMesh:
    """The 2-D ``("data", "model")`` mesh of the feature-sharded solver:
    rows block-parallelize along ``data``, w and the features shard along
    ``model`` (m virtual shards on one card)."""
    if int(data) < 1 or int(model) < 1:
        raise ValueError(f"mesh sizes must be ≥ 1, got data={data}, "
                         f"model={model}")
    return SolverMesh(("data", "model"), (int(data), int(model)))


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

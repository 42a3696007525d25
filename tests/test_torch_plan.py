"""The kernels' shape policy in ``repro_torch.dist.mesh``: which variant
B1, B2 and B3 take, how B4 lays out its column classes and workspace and B5
its CTAs and staged G, and that all stay within the shared memory one
Hopper CTA can use.  Pure
arithmetic on shapes, so it runs on the CPU; the layouts' counts are
held to numpy counts of the same quantities."""

import numpy as np
import pytest
import torch

from repro_torch.dist import mesh
from repro_torch.dist.mesh import (
    GRAM_CHUNK,
    GRAM_TABLE_SLOTS,
    SMEM_PER_CTA,
    STATIC_SMEM,
    FEATURE_UPDATE_CHUNK,
    dcd_dense_plan,
    dcd_dense_staged_bytes,
    dcd_ell_plan,
    dcd_ell_staged_bytes,
    dcd_tile_plan,
    dcd_tile_stream_bytes,
    feature_update_bytes,
    feature_update_plan,
    gram_plan,
)
from repro_torch.kernels.dcd_feature import gram_workspace

WEBSPAM_SPLIT = dict(m=4, b=64, k=3136, d1=4_152_287)  # d = 16,609,143
LIMIT = SMEM_PER_CTA - STATIC_SMEM

# (b ids, k slots) -> variant
ELL_SHAPES = {
    "rcv1": ((64, 73), "staged"),
    "rows_128_slots": ((64, 128), "staged"),
    "webspam_rows": ((64, 3728), "wide"),
    "rows_1100_wide": ((4, 1100), "wide"),
    "one_id": ((1, 1), "staged"),
    "too_many_ids": ((mesh.ELL_STAGED_MAX_IDS + 1, 1), "wide"),
    "rows_too_long_for_registers": ((1, 4 * 32 + 1), "wide"),
}


@pytest.mark.parametrize("name", sorted(ELL_SHAPES))
def test_b1_variant_by_shape(name):
    (b, k), variant = ELL_SHAPES[name]
    plan = dcd_ell_plan(b, k)
    assert plan.variant == variant
    if variant == "wide":
        assert plan.smem_bytes == 0 and plan.threads == mesh.cta_threads(k)
    else:
        assert plan.threads == mesh.ELL_STAGED_THREADS
    wide = dcd_ell_plan(b, k, wide=True)  # asked for: wide at any shape
    assert wide == mesh.EllPlan("wide", mesh.cta_threads(k), 0, 0)


@pytest.mark.parametrize("b", [1, 7, 64, 200, 1024])
@pytest.mark.parametrize("k", [1, 37, 73, 129, 600, 2048])
def test_b1_staged_fits_one_cta(b, k):
    """Every staged plan fits the 227 KB, keeps the column table at most
    2/3 full with every entry a distinct column, and gives each lane of
    its update warp at most four entries of a row; a block that would
    not fit takes the wide kernel."""
    plan = dcd_ell_plan(b, k)
    table = max(32, 1 << int(np.ceil(np.log2(np.ceil(1.5 * b * k)))))
    need = 4 * table * 2 + 4 * b * k * 2 + 4 * b * 8  # the arrays' bytes
    if plan.variant == "staged":
        assert plan.table_slots == table and plan.smem_bytes == need
        assert plan.smem_bytes <= LIMIT
        assert 3 * b * k <= 2 * plan.table_slots
        assert k <= 4 * 32 and 32 <= plan.threads <= 1024
    else:
        assert need > LIMIT or b > mesh.ELL_STAGED_MAX_IDS or k > 4 * 32


def test_b1_staged_bytes_count_the_arrays():
    """The bytes are the arrays the kernel carves: the table's keys and
    w, the block's slots and values, and eight per-id arrays."""
    b, k, slots = 64, 73, 8192
    arrays = [np.empty(slots, np.int32), np.empty(slots, np.float32),
              np.empty(b * k, np.int32), np.empty(b * k, np.float32)]
    arrays += [np.empty(b, np.int32)] * 8
    assert dcd_ell_staged_bytes(b, k, slots) == sum(a.nbytes for a in arrays)


def test_b4_plan_at_the_webspam_split():
    plan = gram_plan(**WEBSPAM_SPLIT)
    m, b = WEBSPAM_SPLIT["m"], WEBSPAM_SPLIT["b"]
    assert plan.classes == 128 and (plan.tile, plan.tiles) == (64, 1)
    assert plan.bucket_smem <= LIMIT and plan.gram_smem <= LIMIT
    assert 2 * plan.gram_smem <= SMEM_PER_CTA  # two CTAs an SM
    # the partial Grams stay within their budget
    assert m * plan.classes * b * b <= mesh.GRAM_PARTIAL_WORDS


def test_b4_bytes_count_the_arrays():
    """The bytes are the arrays the kernels carve: the bucket pass's
    per-warp class counts and one staged row (ids and values); the Gram
    kernel's table (key, count, run end per slot), a chunk's entries
    staged (column, row, value, slot) and sorted (row, value), the rows'
    offsets (B + 1) and starts (B), and each walker's (B, tile) block of
    G."""
    m, b, k, d1 = 4, 64, 3136, 4_152_287
    plan = gram_plan(m, b, k, d1)
    i32, f32 = np.int32, np.float32
    warps = mesh.GRAM_BUCKET_THREADS // 32
    bucket = [np.empty((warps, plan.classes), i32), np.empty(k, i32),
              np.empty(k, f32)]
    gram = [np.empty(GRAM_TABLE_SLOTS, i32)] * 3
    gram += [np.empty(GRAM_CHUNK, t) for t in (i32, i32, f32, i32, i32, f32)]
    gram += [np.empty(b + 1, i32), np.empty(b, i32)]
    walkers = mesh.GRAM_THREADS // 64  # the kernel's walkers per column
    gram += [np.empty((walkers, b, plan.tile), f32)]
    assert plan.bucket_smem == sum(a.nbytes for a in bucket)
    assert plan.gram_smem == sum(a.nbytes for a in gram)


@pytest.mark.parametrize("m,b,k,d1", [(4, 1, 3136, 4_152_287),
                                      (2, 1024, 20, 501),
                                      (3, 48, 40, 501),
                                      (2, 16, 1100, 30_001),
                                      (1, 64, 73, 47_237)])
def test_b4_plan_fits_one_cta(m, b, k, d1):
    plan = gram_plan(m, b, k, d1)
    assert 1 <= plan.classes <= mesh.GRAM_MAX_CLASSES
    assert plan.classes <= max(1, -(-d1 // mesh.GRAM_CLASS_COLS))
    assert plan.tile * plan.tiles >= b > plan.tile * (plan.tiles - 1)
    assert plan.tile <= 64 and b * plan.tile <= max(b, mesh.GRAM_TILE_WORDS)
    assert plan.bucket_smem <= LIMIT and plan.gram_smem <= LIMIT
    assert GRAM_TABLE_SLOTS >= 2 * GRAM_CHUNK  # the chunk's table ≤ 1/2 full


def test_b4_plan_raises_on_rows_too_long_to_stage():
    with pytest.raises(ValueError, match="too long for B4"):
        gram_plan(1, 64, 40_000, 1000)


@pytest.mark.parametrize("d1", [1, 63, 501, 30_001, 4_152_287])
def test_b4_classes_partition_the_columns(d1):
    """Column c goes to class c mod R as local column c div R: every
    column of the shard lands in exactly one (class, local column), so a
    class's local ids are distinct, as its column table assumes."""
    R = gram_plan(4, 64, 16, d1).classes
    c = np.arange(d1 - 1)  # the real columns; d1 - 1 is the dummy slot
    pairs = (c % R) * (-(-d1 // R)) + c // R
    assert np.unique(pairs).size == c.size
    assert (c // R).max(initial=0) < -(-d1 // R)


def test_b4_class_counts_of_a_webspam_block():
    """A block drawn by the webspam law spreads its real entries evenly
    over the classes, zipf-hot low columns included (contiguous column
    ranges would put half of them in the first); numpy's count of each
    class's entries stays within 20% of the mean, so shard 0's CTAs
    carry equal work (about 1,250 entries each: two chunks)."""
    rng = np.random.default_rng(0)
    d_loc, R = WEBSPAM_SPLIT["d1"] - 1, gram_plan(**WEBSPAM_SPLIT).classes
    # shard 0's entries of 64 rows: zipf-0.9 columns, about 3,031 a row
    p = 1.0 / np.arange(1, d_loc + 1) ** 0.9
    rows = [np.unique(rng.choice(d_loc, 3031, p=p / p.sum()))
            for _ in range(64)]
    counts = np.bincount(np.concatenate(rows) % R, minlength=R)
    assert counts.sum() == sum(r.size for r in rows)
    assert 0.8 * counts.mean() < counts.min() <= counts.max() < (
        1.2 * counts.mean())
    assert GRAM_CHUNK < counts.max() <= 2 * GRAM_CHUNK
    ranges = np.bincount(np.concatenate(rows) // -(-d_loc // R), minlength=R)
    assert ranges.max() > 0.4 * counts.sum()  # what contiguous ranges give


def test_gram_workspace_follows_the_plan():
    m, b, k, d1 = 3, 48, 40, 30_001
    plan = gram_plan(m, b, k, d1)
    ws = gram_workspace(m, b, k, d1, torch.device("cpu"))
    assert tuple(ws.lc.shape) == tuple(ws.v.shape) == (m, b, k)
    assert tuple(ws.roff.shape) == (m, b, plan.classes + 1)
    assert tuple(ws.part.shape) == (m, plan.classes, b, b)
    one = gram_workspace(2, 1024, 20, 501, torch.device("cpu"))
    assert gram_plan(2, 1024, 20, 501).classes == 1
    assert tuple(one.part.shape) == (2, 0, 1024, 1024)  # G written directly


# (b ids, d floats) -> variant, w's words a lane of the staged kernel
DENSE_SHAPES = {
    "covtype": ((64, 54), "staged", 2),
    "one_float_rows": ((64, 1), "staged", 1),
    "largest_staged_d": ((64, mesh.DENSE_STAGED_MAX_D), "staged", 8),
    "one_past_the_largest_d": ((64, mesh.DENSE_STAGED_MAX_D + 1), "wide", 0),
    "block_too_large_for_smem": ((1024, 200), "wide", 0),
    "too_many_ids": ((mesh.DENSE_STAGED_MAX_IDS + 1, 1), "wide", 0),
}


@pytest.mark.parametrize("name", sorted(DENSE_SHAPES))
def test_b2_variant_by_shape(name):
    (b, d), variant, per_lane = DENSE_SHAPES[name]
    plan = dcd_dense_plan(b, d)
    assert (plan.variant, plan.per_lane) == (variant, per_lane)
    if variant == "staged":
        assert plan.threads == mesh.DENSE_STAGED_THREADS
        assert plan.smem_bytes == dcd_dense_staged_bytes(b, d) <= LIMIT
        assert 32 * plan.per_lane >= d
        assert plan.per_lane == 1 or d > 16 * plan.per_lane
    else:
        assert plan.smem_bytes == 0 and plan.threads == mesh.cta_threads(d)
    wide = dcd_dense_plan(b, d, wide=True)  # asked for: wide at any shape
    assert wide == mesh.DensePlan("wide", mesh.cta_threads(d), 0, 0)


def test_b2_staged_bytes_count_the_arrays():
    """The bytes are the arrays the kernel carves: the block's rows and
    eight per-id arrays; at 1,024 ids of 200 floats they exceed one
    CTA's shared memory."""
    b, d = 64, 54
    arrays = [np.empty((b, d), np.float32)] + [np.empty(b, np.int32)] * 8
    assert dcd_dense_staged_bytes(b, d) == sum(a.nbytes for a in arrays)
    assert np.empty((1024, 200), np.float32).nbytes > LIMIT


@pytest.mark.parametrize("b", [1, 64, 200, 256, 1024])
def test_b5_plan_follows_b4_and_fits_one_cta(b):
    """B5 runs one CTA per B4 column class and shard (it reads B4's
    buckets), stages G when the whole layout fits, and gives each lane
    of its recursion warp a power of two of G's columns."""
    m, k, d1 = 4, 3136, 4_152_287
    plan = feature_update_plan(m, b, k, d1)
    assert plan.classes == gram_plan(m, b, k, d1).classes
    assert plan.stage_gram == (feature_update_bytes(b, True) <= LIMIT)
    assert plan.smem_bytes == feature_update_bytes(b, plan.stage_gram)
    assert plan.smem_bytes <= LIMIT and plan.threads >= 64
    assert 32 * plan.per_lane >= b
    assert plan.per_lane == 1 or b > 16 * plan.per_lane
    assert plan.per_lane & (plan.per_lane - 1) == 0


def test_b5_plan_at_the_webspam_split():
    plan = feature_update_plan(**WEBSPAM_SPLIT)
    assert plan.classes == 128 and plan.stage_gram and plan.per_lane == 2
    assert not feature_update_plan(4, 256, 3136, 4_152_287).stage_gram


def test_b5_bytes_count_the_arrays():
    """The bytes are the arrays the kernel carves: G when staged, a
    chunk of entries (local column, value), ten per-id arrays (id, seed
    α, q, y, act, base, running α, δ̃, previous and last occurrence),
    and the rows' segment offsets (B + 1) and starts (B)."""
    b = 64
    ids = [np.empty(b, np.int32)] + [np.empty(b, np.float32)] * 7 + [
        np.empty(b, np.int32), np.empty(b, np.int32),
        np.empty(b + 1, np.int32), np.empty(b, np.int32)]
    chunk = [np.empty(FEATURE_UPDATE_CHUNK, np.int32),
             np.empty(FEATURE_UPDATE_CHUNK, np.float32)]
    g = np.empty((b, b), np.float32)
    assert feature_update_bytes(b, False) == sum(
        a.nbytes for a in ids + chunk)
    assert feature_update_bytes(b, True) == sum(
        a.nbytes for a in ids + chunk + [g])


# B3: rows of d floats, n rows; T is the most rows a stage holds
TILE_T = mesh.TILE_STREAM_ROWS


@pytest.mark.parametrize("n", [1, TILE_T - 1, TILE_T, 3 * TILE_T + 5])
@pytest.mark.parametrize("d", [1, 54, mesh.DENSE_STAGED_MAX_D,
                               mesh.DENSE_STAGED_MAX_D + 1])
def test_b3_variant_by_shape(d, n):
    """Rows of at most 256 floats stream through a ring of stages that
    fits one CTA, each stage a multiple of 4 rows and no more than n
    needs; each lane of the consumer warp holds a power of two of w's
    words, at most 8.  Wider rows, or ``wide=True``, take the wide
    kernel."""
    plan = dcd_tile_plan(n, d)
    wide = mesh.TilePlan("wide", mesh.cta_threads(d), 0, 0, 0, 0)
    if d > mesh.DENSE_STAGED_MAX_D:
        assert plan == wide
    else:
        assert plan.variant == "stream"
        assert plan.threads == mesh.TILE_STREAM_THREADS == 64
        assert 32 * plan.per_lane >= d
        assert plan.per_lane == 1 or d > 16 * plan.per_lane
        assert plan.per_lane & (plan.per_lane - 1) == 0
        assert plan.per_lane <= mesh.DENSE_ENTRIES_PER_LANE
        assert plan.tile_rows % 4 == 0 and 4 <= plan.tile_rows <= TILE_T
        assert plan.tile_rows <= max(4, -(-n // 4) * 4)
        assert plan.stages >= 2
        assert plan.smem_bytes == dcd_tile_stream_bytes(
            plan.tile_rows, plan.stages, d) <= LIMIT
    assert dcd_tile_plan(n, d, wide=True) == wide  # asked for: any shape


def test_b3_stream_ring_fits_one_cta():
    """At d = 256 a ring of full stages would not fit one CTA's 227 KB:
    the stages shrink to the most rows (a multiple of 4) that fit."""
    d, n, S = mesh.DENSE_STAGED_MAX_D, 10_000, mesh.TILE_STREAM_STAGES
    assert dcd_tile_stream_bytes(TILE_T, S, d) > LIMIT
    plan = dcd_tile_plan(n, d)
    assert plan.variant == "stream" and plan.stages == S
    assert plan.tile_rows < TILE_T and plan.smem_bytes <= LIMIT
    assert dcd_tile_stream_bytes(plan.tile_rows + 4, S, d) > LIMIT
    cov = dcd_tile_plan(581_012, 54)  # covtype: full stages, 2 words a lane
    assert (cov.tile_rows, cov.stages, cov.per_lane) == (TILE_T, S, 2)
    assert cov.smem_bytes == 114_720 <= LIMIT


def test_b3_stream_bytes_count_the_ring():
    """The bytes are what the kernel carves: each stage's "full" and
    "empty" mbarriers, its rows, and their α and q."""
    T, S, d = 256, 2, 54
    stage = [np.empty(2, np.uint64), np.empty((T, d), np.float32),
             np.empty(T, np.float32), np.empty(T, np.float32)]
    assert dcd_tile_stream_bytes(T, S, d) == S * sum(a.nbytes for a in stage)



@pytest.mark.parametrize("shards", [1, 2, 8, 150])
def test_shard_grid_plans_keep_each_ctas_layout(shards):
    """p data shards multiply the grid and B4's workspace, and change no
    CTA's layout: every plan at p shards is the p = 1 plan with its
    shard count, and the workspace holds p·m (data, model) pairs."""
    for b, k in [(64, 73), (64, 3728)]:
        plan = dcd_ell_plan(b, k, False, shards)
        assert plan == dcd_ell_plan(b, k)._replace(shards=shards)
    for b, d in [(64, 54), (64, 300)]:
        plan = dcd_dense_plan(b, d, False, shards)
        assert plan == dcd_dense_plan(b, d)._replace(shards=shards)
    m, b, k, d1 = 2, 16, 40, 501
    g = gram_plan(m, b, k, d1, shards)
    assert g == gram_plan(m, b, k, d1)._replace(data=shards)
    u = feature_update_plan(m, b, k, d1, shards)
    assert u == feature_update_plan(m, b, k, d1)._replace(data=shards)
    ws = gram_workspace(m, b, k, d1, torch.device("cpu"), shards)
    assert tuple(ws.lc.shape) == tuple(ws.v.shape) == (shards * m, b, k)
    assert tuple(ws.roff.shape) == (shards * m, b, g.classes + 1)
    assert tuple(ws.part.shape) == (shards * m, g.classes, b, b)


@pytest.mark.parametrize("tasks", [1, 3, 53])
@pytest.mark.parametrize("shards", [1, 8])
def test_task_grid_plans_keep_each_ctas_layout(tasks, shards):
    """A task dimension multiplies the CTAs and changes no CTA's layout:
    one CTA holds one (task, shard) pair's block, so its shared memory,
    threads and variant are the binary plan's, at the main paths'
    shapes (rcv1 K = 53, covtype K = 7, webspam split K = 4)."""
    for wide in (False, True):
        got = dcd_ell_plan(64, 73, wide, shards, tasks)
        assert got == dcd_ell_plan(64, 73, wide)._replace(shards=shards,
                                                          tasks=tasks)
        assert got.smem_bytes <= LIMIT
        got = dcd_dense_plan(64, 54, wide, shards, tasks)
        assert got == dcd_dense_plan(64, 54, wide)._replace(shards=shards,
                                                            tasks=tasks)
    s = WEBSPAM_SPLIT
    g = gram_plan(s["m"], s["b"], s["k"], s["d1"], shards, tasks)
    assert g == gram_plan(s["m"], s["b"], s["k"], s["d1"])._replace(
        data=shards, tasks=tasks)
    u = feature_update_plan(s["m"], s["b"], s["k"], s["d1"], shards, tasks)
    assert u == feature_update_plan(s["m"], s["b"], s["k"], s["d1"])._replace(
        data=shards, tasks=tasks)
    assert max(g.bucket_smem, g.gram_smem, u.smem_bytes) <= LIMIT


def test_gram_workspace_carries_the_task_pairs():
    """B4's workspace has a row block per (task, data, model) triple."""
    ws = gram_workspace(2, 8, 5, 33, "cpu", data=3, tasks=4)
    plan = gram_plan(2, 8, 5, 33, 3, 4)
    assert ws.lc.shape == ws.v.shape == (4 * 3 * 2, 8, 5)
    assert ws.roff.shape == (24, 8, plan.classes + 1)


# B4's and B5's plans below the rows layout, as the shared layout gave
# them before it existed (GramPlan and FeatureUpdatePlan fields, in order)
SHARED_PLANS = {
    (4, 64, 3136, 4_152_287): ((128, 64, 1, 33280, 82436, 1, 1, 1),
                               (128, 128, 2, True, 35844, 1, 1, 1)),
    (2, 1024, 20, 501): ((1, 4, 256, 224, 90116, 1, 1, 1),
                         (1, 128, 32, False, 65540, 1, 1, 1)),
    (3, 48, 40, 501): ((8, 48, 1, 832, 67972, 1, 1, 1),
                       (8, 128, 2, True, 27908, 1, 1, 1)),
    (4, 256, 3136, 4_152_287): ((8, 16, 16, 25600, 83972, 1, 1, 1),
                                (8, 128, 8, False, 28676, 1, 1, 1)),
    (1, 1, 73, 47_237): ((512, 1, 1, 33352, 49172, 1, 1, 1),
                         (512, 128, 1, True, 16440, 1, 1, 1)),
    (4, 64, 40, 1000, 2, 3, 1): ((16, 64, 1, 1344, 82436, 2, 3, 1),
                                 (16, 128, 2, True, 35844, 2, 3, 1)),
}


@pytest.mark.parametrize("shape", sorted(SHARED_PLANS))
def test_b4_b5_plans_below_the_rows_layout_are_unchanged(shape):
    g, u = gram_plan(*shape), feature_update_plan(*shape)
    assert g.layout == u.layout == "shared"
    assert (tuple(g)[:8], tuple(u)[:8]) == SHARED_PLANS[shape]


@pytest.mark.parametrize("b", [1025, 4096, 12_000])
def test_b4_rows_layout_past_1024_ids(b):
    """Past ``GRAM_SHARED_MAX_IDS`` B4 takes one column class and tiles of
    64 columns of G, whatever the width; its Gram kernel's bytes do not
    grow with b and are the arrays it carves: the chunk's table (key,
    count, run end), a chunk's entries staged (column, tile row, value,
    slot) and sorted (tile row, value), the tile rows' offsets and each
    thread's tile of accumulators."""
    m, k, d1 = 4, 100, 12_001
    plan = gram_plan(m, b, k, d1)
    assert plan.layout == "rows" and plan.classes == 1
    assert (plan.tile, plan.tiles) == (mesh.GRAM_ROWS_TILE, -(-b // 64))
    i32, f32 = np.int32, np.float32
    arrays = [np.empty(GRAM_TABLE_SLOTS, i32)] * 3
    arrays += [np.empty(GRAM_CHUNK, t) for t in (i32, i32, f32, i32, i32,
                                                 f32)]
    arrays += [np.empty(plan.tile + 1, i32),
               np.empty((plan.tile, mesh.GRAM_ROWS_THREADS), f32)]
    assert plan.gram_smem == sum(a.nbytes for a in arrays) <= LIMIT
    assert plan.bucket_smem == 4 * (mesh.GRAM_BUCKET_THREADS // 32) + 8 * k
    ws = gram_workspace(m, b, k, d1, torch.device("meta"), 2, 3)
    assert tuple(ws.part.shape) == (2 * 3 * m, 0, b, b)  # G written directly
    assert tuple(ws.roff.shape) == (2 * 3 * m, b, 2)


@pytest.mark.parametrize("b,acc_in_smem", [(1025, True), (4096, True),
                                           (57_856, True), (57_857, False),
                                           (100_000, False)])
def test_b5_rows_layout_past_1024_ids(b, acc_in_smem):
    """B5's rows layout: one recursion CTA a pair, no lane registers, its
    b accumulators in shared memory while they fit one CTA's and in
    device memory past that."""
    plan = feature_update_plan(1, b, 10, 101)
    assert plan.layout == "rows" and plan.classes == 1
    assert plan.threads == mesh.FEATURE_UPDATE_ROWS_THREADS <= 1024
    assert plan.per_lane == 0 and not plan.stage_gram
    assert plan.smem_bytes == (4 * b if acc_in_smem else 0) <= LIMIT


def test_rows_layout_raises_only_where_the_grams_cannot_be_allocated():
    """The limit is the card's memory for the Gram matrices (b² floats for
    each pair's m partials and their sum), not a count of ids."""
    gram_plan(1, 70_000, 10, 101)  # 39 GB: allocatable
    with pytest.raises(ValueError, match="Gram matrices"):
        gram_plan(4, 70_000, 10, 101)  # 98 GB
    with pytest.raises(ValueError, match="80 GB"):
        feature_update_plan(1, 4096, 10, 101, 64, 16)  # 1,024 pairs


# --- a rank's launch on a mesh spread over ranks: the one-process layout

@pytest.mark.parametrize("m_loc", [1, 2])
def test_rank_b4_b5_plans_keep_the_mesh_classes(m_loc):
    """A rank holding m_loc of the webspam split's m = 4 feature shards
    lays out B4 and B5 for the mesh's m (``m_all``): the column classes,
    and so each partial's summation order, are the one-process launch's;
    without ``m_all`` its own m_loc would give it other classes (more of
    them, since the partial Grams' budget is per shard)."""
    s = WEBSPAM_SPLIT
    whole = gram_plan(s["m"], s["b"], s["k"], s["d1"])
    rank = gram_plan(m_loc, s["b"], s["k"], s["d1"], m_all=s["m"])
    assert rank == whole
    assert gram_plan(m_loc, s["b"], s["k"], s["d1"]).classes > whole.classes
    assert (feature_update_plan(m_loc, s["b"], s["k"], s["d1"],
                                m_all=s["m"])
            == feature_update_plan(s["m"], s["b"], s["k"], s["d1"]))
    ws = gram_workspace(m_loc, s["b"], s["k"], 65, "cpu", 1, 1, m_all=4)
    full = gram_workspace(4, s["b"], s["k"], 65, "cpu")
    assert ws.roff.shape[-1] == full.roff.shape[-1]
    assert ws.lc.shape[0] == m_loc and ws.part.shape[1:] == full.part.shape[1:]


@pytest.mark.parametrize("p,p_loc", [(8, 4), (4, 2), (2, 1)])
def test_rank_b1_b2_plans_keep_each_ctas_layout(p, p_loc):
    """A rank running p_loc of p data shards launches B1 and B2 with the
    one-process layout a CTA (variant, threads, table, shared memory):
    the plans depend on the block and the row width alone."""
    for b, k in [(64, 73), (64, 3728)]:
        a, r = dcd_ell_plan(b, k, shards=p), dcd_ell_plan(b, k, shards=p_loc)
        assert a[:4] == r[:4]
    for b, d in [(64, 54), (64, 300)]:
        a = dcd_dense_plan(b, d, shards=p)
        r = dcd_dense_plan(b, d, shards=p_loc)
        assert a[:4] == r[:4]

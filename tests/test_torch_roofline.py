"""The port's per-device counter and roofline report
(``repro_torch.launch.roofline``), mirroring ``tests/test_roofline.py``:
exact matmul FLOPs, loops multiplying by their trips, the collective
wire model on DTensor redistributions over a fake (4,) mesh, the
report's terms under the H100's constants and against the reference's
report; then the smoke train steps' counted FLOPs against the
reference's ``analyze_hlo`` of its own compiled step."""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch import roofline as ref_rl
from repro_torch.launch import roofline as rl
from repro_torch.launch.roofline import OpCounter, OpStats, roofline_report


def _count(fn, *args):
    with OpCounter() as oc:
        fn(*args)
    return oc


def test_matmul_flops_exact():
    M, K, N = 64, 128, 32
    oc = _count(lambda a, b: a @ b, torch.empty(M, K, device="meta"),
                torch.empty(K, N, device="meta"))
    assert oc.stats.flops == 2 * M * K * N
    # bytes: the operands read and the result written once
    assert oc.stats.bytes == 4 * (M * K + K * N + M * N)
    # a batched einsum reaches dispatch as bmm: 2·∏(result)·∏(contraction)
    oc = _count(lambda a, b: torch.einsum("bik,bkj->bij", a, b),
                torch.empty(3, M, K), torch.empty(3, K, N))
    assert oc.stats.flops == 2 * 3 * M * K * N


def test_elementwise_counts_no_flops_and_views_no_bytes():
    x = torch.empty(64, 32, device="meta")
    oc = _count(lambda t: torch.tanh(t).reshape(32, 64).t(), x)
    assert oc.stats.flops == 0
    assert oc.stats.bytes == 2 * x.numel() * 4  # tanh only
    # an in-place copy into a slice moves the slice, not the buffer
    big = torch.empty(1024, 64, device="meta")
    oc = _count(lambda b, s: b[:8].copy_(s), big, torch.empty(8, 64,
                                                              device="meta"))
    assert oc.stats.bytes == 2 * 8 * 64 * 4


def test_loop_multiplies_by_trip_count():
    L, D = 7, 32
    ws = [torch.empty(D, D, device="meta") for _ in range(L)]

    def f(x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    oc = _count(f, torch.empty(4, D, device="meta"))
    assert oc.stats.flops == 2 * 4 * D * D * L


def test_nested_loops_compose():
    D, L = 16, 5

    def f(x):
        for _ in range(L):
            for _ in range(3):
                x = torch.tanh(x @ torch.empty(D, D, device="meta"))
        return x

    oc = _count(f, torch.empty(2, D, device="meta"))
    assert oc.stats.flops == 2 * 2 * D * D * 3 * L


def test_temp_peak_tracks_live_bytes():
    def f(x):
        a = x * 2  # 4 KiB live
        b = a + 1  # 8 KiB live
        del a
        c = b * 3  # 8 KiB live (a freed)
        return c

    oc = _count(f, torch.empty(1024, device="meta"))
    assert oc.temp_peak == 2 * 4096


@pytest.fixture(scope="module")
def fake_mesh():
    """``make_fake_mesh``: DeviceMeshes over a fake process group, which
    is torn down after the module so no later test file in the worker
    sees it."""
    import torch.distributed as dist

    from repro_torch.dist.mesh import make_fake_mesh

    yield make_fake_mesh
    if dist.is_initialized():
        dist.destroy_process_group()


def test_collective_wire_model(fake_mesh):
    mesh4 = fake_mesh((4,), ("model",))
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    n = 128
    b = n * 4  # the full tensor's bytes

    def dt(placement, shape=(n,)):
        local = list(shape)
        if isinstance(placement, Shard):
            local[placement.dim] //= 4
        return DTensor.from_local(torch.empty(local, device="meta"), mesh4,
                                  [placement], run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape).stride())

    with OpCounter() as oc:
        dt(Partial()).redistribute(mesh4, [Replicate()])  # all-reduce
        dt(Shard(0)).redistribute(mesh4, [Replicate()])  # all-gather
        dt(Partial()).redistribute(mesh4, [Shard(0)])  # reduce-scatter
        dt(Shard(0), (16, 8)).redistribute(mesh4, [Shard(1)])  # all-to-all
    st = oc.stats
    assert st.bytes_by_kind["all-reduce"] == 2 * b
    assert st.bytes_by_kind["all-gather"] == b
    # reduce-scatter's result is one shard, b/4: ≈ result × group
    assert st.bytes_by_kind["reduce-scatter"] == (b // 4) * 4
    # DTensor's CPU fallback gathers and chunks; billed as one all-to-all
    # of its result, (16, 2) float32
    assert st.bytes_by_kind["all-to-all"] == 16 * 2 * 4
    assert dict(st.count_by_kind) == {"all-reduce": 1, "all-gather": 1,
                                      "reduce-scatter": 1, "all-to-all": 1}
    assert st.collective_bytes == sum(st.bytes_by_kind.values())
    assert st.flops == 0


def test_report_terms_and_dominance():
    st = OpStats(flops=rl.PEAK_FLOPS_FP32, bytes=rl.HBM_BW * 2,
                 collective_bytes=rl.N_LINKS * rl.LINK_BW * 0.5)
    rep = roofline_report(stats=st, n_chips=4,
                          model_flops_total=rl.PEAK_FLOPS_FP32 * 2,
                          peak_flops=rl.PEAK_FLOPS_FP32)
    assert rep["t_compute_s"] == pytest.approx(1.0)
    assert rep["t_memory_s"] == pytest.approx(2.0)
    assert rep["t_collective_s"] == pytest.approx(0.5)
    assert rep["dominant"] == "memory"
    assert rep["useful_flops_fraction"] == pytest.approx(0.5)
    assert rep["roofline_mfu_bound"] == pytest.approx(0.5 / 2.0)
    # the H100's constants, and the peak picked from the matmul dtype
    assert rl.N_LINKS * rl.LINK_BW == 450e9 and rl.HBM_BW == 3.35e12
    assert rl.peak_flops_for(torch.bfloat16) == 989e12
    assert rl.peak_flops_for(torch.float32, allow_tf32=True) == 495e12
    assert rl.peak_flops_for(torch.float32, allow_tf32=False) == 67e12


def test_report_matches_reference_under_its_constants():
    """The same stats through both reports: each term is the
    reference's, scaled by the ratio of the two machines' constants."""
    kw = dict(flops=3.1e15, bytes=7.7e12, collective_bytes=2.9e11)
    ref = ref_rl.roofline_report(stats=ref_rl.HloStats(**kw), n_chips=256,
                                 model_flops_total=5e17)
    got = roofline_report(stats=OpStats(**kw), n_chips=256,
                          model_flops_total=5e17)
    assert got["t_compute_s"] == pytest.approx(
        ref["t_compute_s"] * ref_rl.PEAK_FLOPS / rl.PEAK_FLOPS)
    assert got["t_memory_s"] == pytest.approx(
        ref["t_memory_s"] * ref_rl.HBM_BW / rl.HBM_BW)
    assert got["t_collective_s"] == pytest.approx(
        ref["t_collective_s"] * ref_rl.N_LINKS * ref_rl.LINK_BW
        / (rl.N_LINKS * rl.LINK_BW))
    assert got["useful_flops_fraction"] == ref["useful_flops_fraction"]
    same = set(ref) - {"xla_cost_analysis_flops_raw",
                       "xla_cost_analysis_bytes_raw"}
    assert same <= set(got) and "torch_flop_counter_flops_raw" in got


# ------------------------------------------------- the smoke train steps

# the port's counted FLOPs of one smoke train step (B = 2, S = 16, float32,
# remat on, one microbatch) on a 1 × 1 mesh against the reference's
# ``analyze_hlo`` of its compiled step on the same config and shapes:
# measured port / reference − 1 on jax 0.9.0's CPU compiler: the dense
# and MoE steps count the same matmuls; mamba2's SSD parts by −0.18 %
MEASURED_GAP = {"minicpm-2b": 0.0, "mamba2-780m": -0.0018,
                "granite-moe-3b-a800m": 0.0}
FLOP_RTOL = 0.05


def _ref_step_flops(arch):
    from repro.configs import get_smoke_config
    from repro.optim.schedules import make_schedule
    from repro.train.step import init_train_state, make_train_step

    from _lm_cases import train_batch

    cfg = get_smoke_config(arch)
    step = make_train_step(cfg, schedule=make_schedule(
        "cosine", peak_lr=3e-4, total_steps=10_000, warmup_steps=100),
        remat=True)
    state = jax.eval_shape(lambda k: init_train_state(cfg, k),
                           jax.random.PRNGKey(0))
    batch = {k: jax.ShapeDtypeStruct(v.shape, jnp.asarray(v).dtype)
             for k, v in train_batch(cfg).items()}
    hlo = jax.jit(step, donate_argnums=(0,)).lower(state, batch).compile()
    return ref_rl.analyze_hlo(hlo.as_text()).flops


@pytest.mark.parametrize("arch", sorted(MEASURED_GAP))
def test_smoke_train_step_flops_match_reference(arch, fake_mesh):
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import run_cell

    from _lm_cases import B, S

    r = run_cell(arch, "smoke", cfg=get_smoke_config(arch),
                 shape=InputShape("smoke_train", S, B, "train"),
                 mesh=fake_mesh((1, 1), ("data", "model")), microbatches=1,
                 dtypes=dict(dtype=torch.float32, m_dtype=torch.float32,
                             v_dtype=torch.float32, master=False))
    port = r["roofline"]["flops_per_device"]
    ref = _ref_step_flops(arch)
    gap = port / ref - 1
    print(f"{arch}: port {port:.6g}, reference {ref:.6g}, gap {gap:+.4f}")
    assert abs(gap) <= FLOP_RTOL
    assert gap == pytest.approx(MEASURED_GAP[arch], abs=5e-4)
    # on one device the counter's FLOPs are torch's own count
    assert port == r["roofline"]["torch_flop_counter_flops_raw"]

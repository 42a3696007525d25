"""The port's dry-run (``repro_torch.launch.dryrun``, ``launch.specs``,
``models.transformer.param_specs``, ``train.step.train_state_specs``)
against the reference's: the meta stand-ins' shapes and dtypes and the
cell policies for every arch × shape; ``run_cell`` on smoke configs over
fake (2, 2) and (2, 2, 2) meshes for the dense, SSM, MoE (both dispatch
codecs), hybrid and encdec families, writing the reference's JSON keys
with finite, nonzero terms; and ``rules`` on a 1 × 1 mesh leaving a
smoke model's bits as they are."""

import dataclasses
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, SHAPES, get_config
from repro_torch.configs import get_config as port_config
from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import SHAPES as PORT_SHAPES
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun
from repro_torch.tree import leaves_with_names, map_layer_groups

CELLS = [(a, s) for a in ARCHS for s in SHAPES]


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module.  Importing it sets ``XLA_FLAGS``
    to 512 host devices: jax's backend is started first (so this worker
    keeps its devices) and the variable is restored at once, so no later
    child process of the worker inherits it."""
    jax.devices()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
        if "XLA_FLAGS" not in os.environ or not os.environ["XLA_FLAGS"]:
            mp.delenv("XLA_FLAGS")
        import repro.launch.dryrun as ref
    assert "512" not in os.environ.get("XLA_FLAGS", "")
    return ref


def _ref_named(tree):
    """{name: (shape, dtype name)} of the reference's stand-ins."""
    return {n: (tuple(v.shape), str(v.dtype))
            for n, v in leaves_with_names(tree) if hasattr(v, "shape")}


def _port_named(tree):
    """The port's stand-ins read through the reference's stacked view: a
    layer group's L per-layer leaves as one (L, …) leaf."""
    def stack(layers):
        return {k: [lp[k] for lp in layers] for k in layers[0]}

    if isinstance(tree, dict) and any(k in tree for k in (
            "attn", "ssm", "periods", "enc_attn")):
        tree = map_layer_groups(tree, stack, lambda t: t)
    out = {}
    for n, v in leaves_with_names(tree):
        if not isinstance(v, torch.Tensor):
            continue
        parts = n.split("/")
        if parts[-1].isdigit() and len(parts) > 1:  # a stacked group leaf
            n = "/".join(parts[:-1])
            shape, dt = out.get(n, ((0,) + tuple(v.shape), None))
            out[n] = ((shape[0] + 1,) + tuple(v.shape),
                      str(v.dtype).replace("torch.", ""))
        else:
            out[n] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_match_reference(arch, ref_dryrun):
    from repro.train.step import train_state_specs as ref_state_specs
    from repro_torch.models.transformer import param_specs
    from repro_torch.train.step import train_state_specs

    cfg, pcfg = get_config(arch), port_config(arch)
    r_st = ref_state_specs(cfg, **ref_dryrun.state_dtypes_for(cfg))
    # the state's parameters are ``param_specs``'s, bf16 both
    assert _port_named(param_specs(pcfg)) == _ref_named(r_st.params)
    p_st = train_state_specs(pcfg, **dryrun.state_dtypes_for(pcfg))
    for field in ("params", "m", "v"):
        r = r_st.params if field == "params" else getattr(r_st.opt, field)
        p = p_st.params if field == "params" else getattr(p_st.opt, field)
        assert _port_named(p) == _ref_named(r), field
    for r, p in ((r_st.step, p_st.step), (r_st.opt.count, p_st.opt.count)):
        assert tuple(p.shape) == tuple(r.shape) and str(p.dtype) == \
            f"torch.{r.dtype}"
    assert p_st.opt.master is None and r_st.opt.master is None
    assert all(t.device.type == "meta" for _, t in leaves_with_names(p_st)
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_cell_specs_and_policies_match_reference(arch, shape_name,
                                                 ref_dryrun):
    from repro.launch.specs import batch_specs as ref_batch
    from repro.launch.specs import cache_specs as ref_cache
    from repro_torch.launch.specs import batch_specs, cache_specs

    cfg, pcfg = get_config(arch), port_config(arch)
    shape, pshape = SHAPES[shape_name], PORT_SHAPES[shape_name]
    assert _port_named(batch_specs(pcfg, pshape)) == _ref_named(
        ref_batch(cfg, shape))
    if shape.kind != "train":
        assert _port_named(cache_specs(pcfg, pshape)) == {
            k: v for k, v in _ref_named(ref_cache(cfg, shape)).items()
            if k != "length"}
    assert dryrun.microbatches_for(pcfg, pshape) == \
        ref_dryrun.microbatches_for(cfg, shape)
    assert dryrun.model_flops_for(pcfg, pshape) == \
        ref_dryrun.model_flops_for(cfg, shape)
    r, p = ref_dryrun.state_dtypes_for(cfg), dryrun.state_dtypes_for(pcfg)
    assert {k: str(v).replace("torch.", "") for k, v in p.items()} == {
        k: str(v if k == "master" else np.dtype(v)) for k, v in r.items()}
    assert pcfg.n_params() == cfg.n_params()
    assert pcfg.n_active_params() == cfg.n_active_params()


# ----------------------------------------------------------- the cells


@pytest.fixture(scope="module")
def fake_mesh():
    """``make_fake_mesh``; the fake process group is torn down after the
    module so no later test file in the worker sees it."""
    import torch.distributed as dist

    from repro_torch.dist.mesh import make_fake_mesh

    yield make_fake_mesh
    if dist.is_initialized():
        dist.destroy_process_group()


def _smoke(arch, dispatch=None):
    """A smoke config at one work unit's depth (the counts a layer are
    the same; the cells stay within the tests' time)."""
    cfg = get_smoke_config(arch)
    depth = {"n_layers": cfg.attn_period or 1}
    if cfg.is_encdec:
        depth["n_enc_layers"] = 1
    if dispatch:
        depth["moe_dispatch"] = dispatch
    return dataclasses.replace(cfg, **depth)


FAMILIES = [("minicpm-2b", None), ("mamba2-780m", None),
            ("granite-moe-3b-a800m", "scatter"),
            ("granite-moe-3b-a800m", "einsum"),
            ("jamba-1.5-large-398b", None), ("whisper-small", None)]
MESH_2D = ((2, 2), ("data", "model"))
MESH_3D = ((2, 2, 2), ("pod", "data", "model"))
# every family and kind on the (2, 2) mesh; on the (2, 2, 2) mesh each
# kind once and the families where its cell is cheapest (a 3-D mesh's
# DTensor dispatch costs 3–5× a 2-D one's): the hybrid's prefill runs
# SSM, attention and MoE layers
GRID = ([(a, d, k, MESH_2D) for a, d in FAMILIES
         for k in ("train", "prefill", "decode")]
        + [("minicpm-2b", None, "prefill", MESH_3D),
           ("granite-moe-3b-a800m", "scatter", "prefill", MESH_3D),
           ("jamba-1.5-large-398b", None, "prefill", MESH_3D),
           ("granite-moe-3b-a800m", "einsum", "train", MESH_3D),
           ("whisper-small", None, "decode", MESH_3D)])

REF_KEYS = {"arch", "shape", "mesh", "tag", "kind", "n_chips", "memory",
            "roofline", "n_params", "n_active_params"}
MEM_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "peak_bytes_est"}
REF_ROOFLINE_KEYS = {
    "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
    "flops_per_device", "bytes_per_device", "collective_bytes_per_device",
    "collective_bytes_by_kind", "collective_count_by_kind",
    "model_flops_total", "useful_flops_fraction", "roofline_mfu_bound"}


@pytest.mark.parametrize(
    "arch,dispatch,kind,mesh",
    GRID, ids=[f"{a}-{d or ''}-{k}-{'x'.join(map(str, m[0]))}"
               for a, d, k, m in GRID])
def test_run_cell_writes_reference_keys(arch, dispatch, kind, mesh,
                                        fake_mesh, tmp_path):
    cfg = _smoke(arch, dispatch)
    r = dryrun.run_cell(arch, "smoke", cfg=cfg, out_dir=str(tmp_path),
                        shape=InputShape(f"smoke_{kind}", 8, 4, kind),
                        mesh=fake_mesh(*mesh), tag=dispatch or "baseline")
    (path,) = tmp_path.iterdir()
    assert path.name == (f"{arch}__smoke_{kind}__"
                         f"{'x'.join(map(str, mesh[0]))}__"
                         f"{dispatch or 'baseline'}.json")
    on_disk = json.loads(path.read_text())
    assert REF_KEYS | {"build_s", "count_s"} == set(on_disk)
    assert set(on_disk["memory"]) == MEM_KEYS
    rf = on_disk["roofline"]
    assert REF_ROOFLINE_KEYS <= set(rf)
    assert "torch_flop_counter_flops_raw" in rf
    assert on_disk["n_chips"] == math.prod(mesh[0])
    for k in ("t_compute_s", "t_memory_s", "t_collective_s",
              "flops_per_device", "bytes_per_device",
              "collective_bytes_per_device", "useful_flops_fraction",
              "torch_flop_counter_flops_raw"):
        assert math.isfinite(rf[k]) and rf[k] > 0, k
    mem = on_disk["memory"]
    for k in MEM_KEYS:
        assert mem[k] > 0, k
    assert mem["peak_bytes_est"] == (mem["argument_bytes"]
                                     + mem["temp_bytes"]
                                     - mem["alias_bytes"])
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")


# ---------------------------------------------- rules keep the bits


def _replicated(tree, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.tree import tree_map

    return tree_map(lambda t: DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        if isinstance(t, torch.Tensor) else t, tree)


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-780m",
                                  "granite-moe-3b-a800m"])
def test_rules_on_one_device_keep_the_bits(arch, fake_mesh):
    """A smoke forward and train step as DTensors on a 1 × 1 mesh with
    ``ShardingRules`` give the plain run's bits: the annotations, the
    local_map forms (attention, the SSD scan, the MoE dispatch) and the
    one-hot cross-entropy compute the same numbers."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.models import forward_train, init_params
    from repro_torch.optim import make_schedule
    from repro_torch.train import make_train_step, train_state_for
    from repro_torch.tree import leaves

    from _lm_cases import train_batch

    mesh = fake_mesh((1, 1), ("data", "model"))
    cfg = get_smoke_config(arch)
    b = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    params = init_params(cfg, 0, device="cpu")
    plain, _ = forward_train(cfg, params, b)
    rules = ShardingRules(mesh=mesh)
    with implicit_replication():
        got, _ = forward_train(cfg, _replicated(params, mesh),
                               _replicated(b, mesh), rules=rules)
    assert torch.equal(got.to_local(), plain)

    sched = make_schedule("cosine", peak_lr=1e-3, total_steps=10)
    s_plain, m_plain = make_train_step(cfg, schedule=sched)(
        train_state_for(init_params(cfg, 0, device="cpu")), b)
    with implicit_replication():
        s_mesh, m_mesh = make_train_step(cfg, schedule=sched, rules=rules)(
            _replicated(train_state_for(init_params(cfg, 0, device="cpu")),
                        mesh), _replicated(b, mesh))
    for k in ("loss", "grad_norm"):
        assert torch.equal(m_mesh[k].to_local(), m_plain[k]), k
    for p, q in zip(leaves(s_mesh.params), leaves(s_plain.params)):
        assert torch.equal(p.to_local(), q)

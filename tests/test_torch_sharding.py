"""The port's sharding policy (``repro_torch.dist.sharding``) against the
reference's (``repro.dist.sharding``), by per-device bytes and by spec,
leaf by leaf, for all ten archs on (1, 1), (16, 16) and (2, 16, 16)
meshes; ``batch_pspec``'s cases; ``ShardingRules.act`` on a fake (2, 2)
``DeviceMesh``.

The reference stacks each layer group along a leading L axis; the port
keeps one dict a layer.  A port leaf ``attn/3/wq`` is one of the L
slices of the reference's ``attn/wq``: its bytes are summed over the L
layers and its spec is the reference's with the L entry dropped.  Where
the reference's ZeRO-1 rule shards that L axis itself, the port shards
the next free divisible dimension or none; each such leaf is a
departure, counted, printed and held to the list in ROADMAP C.17.
"""

import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, SHAPES, get_config
from repro.dist import sharding as ref_sh
from repro.launch.specs import cache_specs as ref_cache_specs
from repro.models.transformer import param_specs as ref_param_specs
from repro_torch.configs import get_config as port_config
from repro_torch.dist import sharding as port_sh
from repro_torch.dist.mesh import SolverMesh
from repro_torch.launch.specs import cache_specs as port_cache_specs
from repro_torch.models.transformer import param_specs as port_param_specs
from repro_torch.tree import LAYER_GROUPS, leaves, leaves_with_names

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _ref_mesh(shape, axes):
    """Abstract mesh over repeated CPU devices (as tests/test_sharding.py
    builds it) — enough for specs and shard shapes."""
    devs = np.asarray(jax.devices() * math.prod(shape))[:math.prod(shape)]
    return jax.sharding.Mesh(devs.reshape(shape), axes)


def _meshes(name):
    shape, axes = MESHES[name]
    return _ref_mesh(shape, axes), SolverMesh(axes, shape)


@functools.lru_cache(maxsize=None)
def _specs(arch):
    return ref_param_specs(get_config(arch)), port_param_specs(
        port_config(arch))


def _norm(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _stacked_name(name: str) -> str:
    """The reference's name of a port leaf: the layer index after a
    layer group (``attn/3/wq`` → ``attn/wq``, ``periods/0/block/5/wq``
    → ``periods/0/block/wq``) dropped."""
    parts = name.split("/")
    keep = [p for i, p in enumerate(parts)
            if not (p.isdigit() and i and (parts[i - 1] in LAYER_GROUPS
                                           or parts[i - 1] == "block"))]
    return "/".join(keep)


def _ref_leaves(specs, shardings):
    """{name: (global shape, itemsize, normalised spec, bytes/device)}."""
    out = {}
    for (name, leaf), sh in zip(leaves_with_names(specs),
                                leaves(shardings)):
        if not hasattr(leaf, "shape") or not leaf.shape:
            continue
        local = sh.shard_shape(leaf.shape)
        out[name] = (tuple(leaf.shape), leaf.dtype.itemsize,
                     _norm(sh.spec, len(leaf.shape)),
                     math.prod(local) * leaf.dtype.itemsize)
    return out


def _port_leaves(specs, shardings):
    """{stacked name: (layer count, itemsize, [specs], bytes/device
    summed over the layers)}."""
    out = {}
    for (name, leaf), sh in zip(leaves_with_names(specs),
                                leaves(shardings)):
        if not isinstance(leaf, torch.Tensor) or not leaf.dim():
            continue
        key = _stacked_name(name)
        n, size, specs_, b = out.get(key, (0, leaf.element_size(), [], 0))
        local = sh.shard_shape(tuple(leaf.shape))
        out[key] = (n + 1, size, specs_ + [_norm(sh.spec, leaf.dim())],
                    b + math.prod(local) * leaf.element_size())
    return out


def _compare(ref, port):
    """Leaf-by-leaf equality; returns the departures, each a (name,
    reference bytes, port bytes, reference spec, port spec)."""
    assert sorted(ref) == sorted(port)
    departures = []
    for name, (shape, size, r_spec, r_bytes) in ref.items():
        n, p_size, p_specs, p_bytes = port[name]
        assert p_size == size, name
        # a per-layer leaf drops the reference's leading L entry
        per_layer = len(p_specs[0]) == len(r_spec) - 1
        r_tail = r_spec[1:] if per_layer else r_spec
        if (all(s == r_tail for s in p_specs) and p_bytes == r_bytes
                and not (per_layer and r_spec[0] is not None)):
            continue
        # only the reference's stacked L axis may part them: its spec
        # shards dim 0 of a layer-group leaf the port holds per layer
        assert per_layer and r_spec[0] is not None, (
            name, r_spec, p_specs, r_bytes, p_bytes)
        departures.append((name, r_bytes, p_bytes, r_spec, p_specs[0]))
    return departures


# ROADMAP C.17: the per-layer leaves whose ZeRO-1 moment the reference
# shards along the stacked L axis (L divides by data = 16), the same on
# the (16, 16) and (2, 16, 16) meshes: arch → {leaf: (reference bytes,
# port bytes)} a device, one moment.  All but mamba2-780m's five part by
# spec only (the port shards the next free dimension: the same bytes);
# those five have no free dimension left (their one dim is the heads'
# or the inner width's, already on 'model'), so they stay as their
# parameter: 88,020 bytes more a device a moment.
_LN = {"attn/ln", "mlp/ln"}
C17 = {
    "granite-moe-3b-a800m": {"attn/ln": (6144, 6144),
                             "moe/ln": (6144, 6144),
                             "moe/wd": (125829120, 125829120),
                             "moe/wg": (125829120, 125829120),
                             "moe/wu": (125829120, 125829120)},
    "phi3.5-moe-42b-a6.6b": {"attn/ln": (16384, 16384),
                             "moe/ln": (16384, 16384),
                             "moe/wd": (104857600, 104857600),
                             "moe/wg": (104857600, 104857600),
                             "moe/wu": (104857600, 104857600)},
    "mamba2-780m": {"ssm/A_log": (36, 576), "ssm/D_skip": (36, 576),
                    "ssm/dt_bias": (36, 576), "ssm/conv_bx": (1152, 18432),
                    "ssm/conv_wx": (4608, 73728),
                    "ssm/conv_bbc": (1536, 1536),
                    "ssm/conv_wbc": (6144, 6144), "ssm/ln": (9216, 9216),
                    "ssm/ssm_norm": (18432, 18432)},
    "minitron-4b": {n: (12288, 12288) for n in _LN},
    "qwen2-vl-72b": {n: (81920, 81920) for n in _LN},
}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_bytes_and_specs(arch, mesh_name):
    """Parameters, FSDP on and off, MoE experts EP-resident and not:
    every leaf's per-device bytes and spec equal the reference's."""
    ref_mesh, port_mesh = _meshes(mesh_name)
    r_specs, p_specs = _specs(arch)
    cfg = get_config(arch)
    variants = [(True, True), (False, True)]
    if cfg.n_experts:
        variants += [(True, False)]
    for fsdp, ep in variants:
        rc = dataclasses.replace(cfg, moe_ep_resident=ep)
        pc = dataclasses.replace(port_config(arch), moe_ep_resident=ep)
        r = _ref_leaves(r_specs, ref_sh.param_shardings(
            rc, ref_mesh, r_specs, fsdp=fsdp))
        p = _port_leaves(p_specs, port_sh.param_shardings(
            pc, port_mesh, p_specs, fsdp=fsdp))
        assert _compare(r, p) == [], (fsdp, ep)
        assert sum(v[3] for v in r.values()) == sum(
            v[3] for v in p.values())


def _zero1(arch, mesh_name):
    ref_mesh, port_mesh = _meshes(mesh_name)
    r_specs, p_specs = _specs(arch)
    cfg, pc = get_config(arch), port_config(arch)
    r_p = ref_sh.param_shardings(cfg, ref_mesh, r_specs)
    p_p = port_sh.param_shardings(pc, port_mesh, p_specs)
    r = _ref_leaves(r_specs, ref_sh.opt_shardings(r_p, ref_mesh, r_specs))
    p = _port_leaves(p_specs, port_sh.opt_shardings(p_p, port_mesh,
                                                    p_specs))
    return r, p, _compare(r, p)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_bytes_and_specs(arch, mesh_name):
    """ZeRO-1 moments: equal leaf by leaf but where the reference shards
    the stacked L axis (trap 2), and each such leaf is in C.17."""
    r, p, departures = _zero1(arch, mesh_name)
    for name, rb, pb, rs, ps in departures:
        print(f"C.17 {arch} {mesh_name} {name}: reference {rs} "
              f"{rb} B/device, port {ps} {pb} B/device (one moment)")
    got = {name: (rb, pb) for name, rb, pb, _, _ in departures}
    assert got == (C17.get(arch, {}) if mesh_name != "1x1" else {})
    same = [n for n in r if n not in got]
    assert sum(r[n][3] for n in same) == sum(p[n][3] for n in same)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_bytes_and_specs(arch, mesh_name):
    """The decode cache at decode_32k: both packages stack it (L, B, …);
    every leaf's spec and per-device bytes are the reference's."""
    ref_mesh, port_mesh = _meshes(mesh_name)
    shape = SHAPES["decode_32k"]
    rc = ref_cache_specs(get_config(arch), shape)
    pc = port_cache_specs(port_config(arch), shape)
    r = _ref_leaves(rc, ref_sh.cache_shardings(
        get_config(arch), ref_mesh, rc, shape.global_batch))
    p = _port_leaves(pc, port_sh.cache_shardings(
        port_config(arch), port_mesh, pc, shape.global_batch))
    assert _compare(r, p) == []


def test_batch_pspec_divisibility():
    """``tests/test_sharding.py``'s four cases."""
    _, mesh = _meshes("2x16x16")
    assert port_sh.batch_pspec(mesh, 256) == (("pod", "data"),)
    assert port_sh.batch_pspec(mesh, 32) == (("pod", "data"),)
    assert port_sh.batch_pspec(mesh, 16) == ("pod",)
    assert port_sh.batch_pspec(mesh, 1) == (None,)


@pytest.fixture(scope="module")
def fake_mesh():
    """A (2, 2) DeviceMesh over a fake process group, torn down after the
    module so no later test file in the worker sees the group."""
    import torch.distributed as dist

    from repro_torch.dist.mesh import make_fake_mesh

    mesh = make_fake_mesh((2, 2), ("data", "model"))
    yield mesh
    dist.destroy_process_group()


def test_act_identity_without_mesh():
    x = torch.ones(4, 8, 16)
    assert port_sh.NO_RULES.act(x, "act_resid") is x
    rules = port_sh.ShardingRules(mesh=SolverMesh(("data", "model"),
                                                  (2, 2)))
    assert rules.act(x, "act_resid") is x  # a plain tensor
    assert rules.act(x, "no_such_name") is x


def test_act_redistributes_dtensor(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    rules = port_sh.ShardingRules(mesh=fake_mesh)
    x = distribute_tensor(torch.ones(4, 8, 16), fake_mesh,
                          [Replicate(), Replicate()])
    y = rules.act(x, "act_resid")  # (B, S, D): batch over data
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert y.to_local().shape == (2, 8, 16)
    z = rules.act(y, "act_logits")  # vocab over model as well
    assert tuple(z.placements) == (Shard(0), Shard(2))
    assert z.to_local().shape == (2, 8, 8)
    # an indivisible batch drops its axis: the spec resolves to nothing
    odd = distribute_tensor(torch.ones(3, 8, 16), fake_mesh,
                            [Replicate(), Replicate()])
    assert rules.act(odd, "act_resid") is odd
    # the spec → placements map: (pod, data) on one dim is Shard on both
    ns = port_sh.NamedSharding(SolverMesh(("pod", "data", "model"),
                                          (2, 2, 2)),
                               (("pod", "data"), None, "model"))
    assert ns.placements() == (Shard(0), Shard(0), Shard(2))
    assert ns.shard_shape((8, 3, 4)) == (2, 3, 2)

"""Sharding policy: logical activation rules, param / batch / cache /
optimizer shardings (the counterpart of ``repro/dist/sharding.py``).

Everything here is *divisibility-aware*: a proposed mesh axis is dropped
from a dimension whose size it does not divide, so one policy covers all
10 architectures and every mesh without per-arch special cases.

A spec is a tuple of entries, each ``None``, an axis name or a tuple of
axis names — the reference's ``PartitionSpec``.  ``NamedSharding(mesh,
spec)`` pairs it with a mesh (a ``torch.distributed`` ``DeviceMesh``, or
anything ``dist.mesh.mesh_axes`` reads); ``placements`` maps it onto
``torch.distributed.tensor`` placements — a dimension split over
(pod, data) is ``Shard(dim)`` on both mesh dimensions — and
``shard_shape`` gives one device's shard of a global shape.

Logical activation names (``ShardingRules.act(x, name)``):

  act_resid        (B, S, D)        residual stream — batch over DP
  act_mlp_in       (B, S, D)        pre-MLP hidden
  act_q / act_kv   (B, S, H, hd)    train/prefill heads over 'model'
  act_q_dec /      (B, 1, H, hd)    decode q/k/v — heads REPLICATED so
  act_kv_dec                        they compose with the S-sharded
                                    cache (split-KV)
  cache            (B, S_max, Hkv, hd)  decode KV cache: S over 'model'
  act_attn_out_dec (B, 1, H·hd)     pre-wo decode activations
  act_logits       (B, S, Vp)       vocab over 'model'
  act_moe_groups   (G, g, D)        token groups over DP
  act_moe_xe       (E, C, D)        dispatched tokens: experts on 'model'
  act_moe_xe4      (G, E, C, D)     grouped dispatch: G on DP, E on model
  act_ssm_inner    (B, S, d_inner)  SSD head-parallel inner width
  act_ssm_dt       (B, S, H)        per-head dt

On a live mesh (``dist.mesh.make_rank_mesh``) the same placements hold
real values: ``place`` puts a tree's tensors on it leaf by leaf, each
rank keeping its own shard of the full leaf it drew or loaded (no
collective), ``zeros_placed`` and ``replicate_like`` build the optimizer's
leaves beside DTensor parameters, ``owned_local`` is the part of a leaf a
rank counts once in a reduction over the whole mesh, ``gather_full`` (to
the mesh's device) and ``host_full`` (to the host, the checkpoints'
reads) are the inverse of ``place``, and ``on_mesh`` is the context the
LM steps run in there.

The port's parameter trees keep each layer group as a Python list of
per-layer dicts where the reference stacks a group's leaves along a
leading (L, …) axis.  Two rules read that axis, and the port resolves
them on the per-layer leaf:

  * the expert test — the reference's (L, E, D, F) expert weights have
    ndim ≥ 4; the port's per-layer (E, D, F) ones ndim ≥ 3;
  * ZeRO-1's first still-replicated divisible dimension — in the
    reference this is the L axis itself whenever L divides by the
    ``data`` size; the port has no such axis, so the moment shards the
    next free divisible dimension, or stays as its parameter when there
    is none.  The per-device bytes are the reference's wherever such a
    dimension exists (L/k · X = L · X/k).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

from repro_torch.dist.mesh import data_axes, mesh_axes
from repro_torch.tree import tree_map, tree_map_with_names

# sentinels resolved per-mesh at application time
BATCH = "__batch__"  # the data-parallel axis product (pod, data)
FSDP = "__fsdp__"  # 'data' when fsdp=True, dropped otherwise


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


# ===================================================== primitives ========


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart; a
    leaf of the port's trees, not a node)."""

    mesh: Any
    spec: tuple

    def shard_shape(self, shape) -> tuple:
        """One device's shard of a tensor of global ``shape``."""
        sizes = mesh_axes(self.mesh)
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        out = []
        for d, e in zip(shape, spec):
            k = 1
            for a in _entry_axes(e):
                k *= sizes[a]
            if d % k:
                raise ValueError(f"{tuple(shape)}: dimension {d} does not "
                                 f"split over {e} ({k})")
            out.append(d // k)
        return tuple(out)

    def placements(self) -> tuple:
        """One ``Shard(dim)`` or ``Replicate()`` per mesh dimension; an
        axis of size 1 splits nothing and is ``Replicate()`` (the same
        layout, which DTensor's view rules take more readily)."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for a, size in mesh_axes(self.mesh).items():
            dims = [d for d, e in enumerate(self.spec)
                    if a in _entry_axes(e)]
            out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
        return tuple(out)


def named(mesh, *spec) -> NamedSharding:
    """``NamedSharding(mesh, spec)`` — the one construction point."""
    return NamedSharding(mesh, tuple(spec))


def replicated(mesh) -> NamedSharding:
    return named(mesh)


def logits_sharding(mesh) -> NamedSharding:
    """(B, S, Vp) logits: vocab over 'model' (no logits all-gather)."""
    return named(mesh, None, None, "model")


def token_sharding(mesh) -> NamedSharding:
    """(B,) sampled tokens — replicated batch vector."""
    return named(mesh, None)


def _axes_dividing(dim_size: int, axes: tuple, mesh) -> tuple:
    """Longest prefix of ``axes`` whose mesh-size product divides
    ``dim_size`` (constraint dropping: indivisible dims silently skip)."""
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in axes if a in sizes)
    while axes:
        k = 1
        for a in axes:
            k *= sizes[a]
        if k and dim_size % k == 0:
            return axes
        axes = axes[:-1]
    return ()


def _resolve_entry(entry, dim_size: int, mesh, fsdp: bool = True):
    """One spec entry (axis name / tuple / sentinel / None) → final entry
    with indivisible axes dropped."""
    if entry is None:
        return None
    if entry == BATCH:
        axes = data_axes(mesh)
    elif entry == FSDP:
        axes = ("data",) if fsdp else ()
    else:
        axes = _entry_axes(entry)
    axes = _axes_dividing(dim_size, axes, mesh)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _spec_for(template, shape, mesh, fsdp: bool = True) -> tuple:
    """Right-align ``template`` to ``shape`` (leading dims replicate) and
    resolve every entry with divisibility dropping."""
    ndim = len(shape)
    if len(template) > ndim:
        template = template[len(template) - ndim:]
    pad = ndim - len(template)
    return tuple([None] * pad + [
        _resolve_entry(e, shape[pad + i], mesh, fsdp)
        for i, e in enumerate(template)])


# ===================================================== batch =============


def batch_pspec(mesh, global_batch: int) -> tuple:
    """Largest data-axis product that divides the global batch.  Axes are
    dropped outermost-last: (pod, data) → (pod,) → () so a batch that
    fits only the pod axis still shards across pods."""
    return (_resolve_entry(BATCH, global_batch, mesh),)


def batch_sharding(mesh, global_batch: int, ndim: int,
                   leading: int = 0) -> NamedSharding:
    """Batch-dim-only sharding for an input of ``ndim`` dims whose batch
    dimension sits after ``leading`` leading dims (e.g. M-RoPE positions
    are (3, B, S) → leading=1)."""
    spec = [None] * ndim
    spec[leading] = _resolve_entry(BATCH, global_batch, mesh)
    return named(mesh, *spec)


# ===================================================== activations =======


# templates are right-aligned against the activation's shape
ACT_RULES: Mapping[str, tuple] = {
    "act_resid": (BATCH, None, None),
    "act_mlp_in": (BATCH, None, None),
    "act_q": (BATCH, None, "model", None),
    "act_kv": (BATCH, None, "model", None),
    "act_q_dec": (BATCH, None, None, None),
    "act_kv_dec": (BATCH, None, None, None),
    "cache": (BATCH, "model", None, None),
    "act_attn_out_dec": (BATCH, None, None),
    "act_logits": (BATCH, None, "model"),
    "act_moe_groups": (BATCH, None, None),
    "act_moe_xe": ("model", None, None),
    "act_moe_xe4": (BATCH, "model", None, None),
    "act_ssm_inner": (BATCH, None, "model"),
    "act_ssm_dt": (BATCH, None, "model"),
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mesh-optional activation-sharding policy.

    ``rules.act(x, name)`` redistributes a ``DTensor`` ``x`` to the
    logical spec for ``name`` on its mesh (``with_sharding_constraint``'s
    counterpart: a pending partial sum reduces, a replicated dimension
    splits, a split one gathers).  With no mesh, on a plain tensor, or
    for an unknown name or a fully-dropped spec it is the identity and
    returns ``x`` itself, so model code annotates unconditionally.
    """

    mesh: Any = None
    rules: Optional[Mapping[str, tuple]] = None

    def spec(self, name: str, shape) -> Optional[tuple]:
        template = (self.rules or ACT_RULES).get(name)
        if template is None or self.mesh is None:
            return None
        return _spec_for(template, shape, self.mesh)

    def act(self, x, name: str):
        if self.mesh is None or not is_dtensor(x):
            return x
        spec = self.spec(name, x.shape)
        if spec is None or all(e is None for e in spec):
            return x
        return x.redistribute(x.device_mesh,
                              NamedSharding(self.mesh, spec).placements())


def is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor" and hasattr(x, "device_mesh")


def fsdp_gathered(w):
    """A weight as a matmul uses it: a DTensor's data-parallel split (its
    FSDP dim) gathered, its ``model`` split kept — the all-gather FSDP
    makes before each use.  DTensor left to choose would gather the
    ``model`` split too where that costs less to plan, and compute, say,
    the whole vocabulary's logits on every device.  Anything else is
    returned as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    dp = data_axes(w.device_mesh)
    names = w.device_mesh.mesh_dim_names
    pl = [Replicate() if names[i] in dp else p
          for i, p in enumerate(w.placements)]
    return w if pl == list(w.placements) else w.redistribute(
        w.device_mesh, pl)


def local_grad_placements(in_placements) -> tuple:
    """The gradient placements of ``local_map``'s inputs given their
    ``in_placements``: an input replicated over a mesh dimension that
    another input splits is used by each device on its own part of the
    work only (B and C over an SSD head split, a router over a group
    split), so its local gradient is that part's and the gradients are
    a pending sum (``Partial``) there; every other placement is its
    own gradient's.  Without this DTensor would take each device's
    partial gradient for the whole one."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    split = [any(isinstance(pl[i], Shard) for pl in in_placements)
             for i in range(len(in_placements[0]))]
    return tuple(tuple(Partial() if isinstance(p, Replicate) and split[i]
                       else p for i, p in enumerate(pl))
                 for pl in in_placements)


def pad_dim(x, dim: int, before: int, after: int):
    """``x`` zero-padded along ``dim`` by ``before`` and ``after``
    entries (``F.pad``).  A DTensor pads each device's own part under
    ``local_map`` (the dimension gathered first where it is split), so
    no torch's DTensor rule for ``constant_pad_nd`` is needed — some
    plan an impossible redistribution for it."""
    import torch.nn.functional as F

    dim %= x.dim()
    pad = [0, 0] * (x.dim() - 1 - dim) + [before, after]
    if not is_dtensor(x):
        return F.pad(x, pad)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
               for p in x.placements)
    return local_map(lambda t: (F.pad(t, pad),), (pl,), in_placements=(pl,),
                     device_mesh=mesh, redistribute_inputs=True)(x)[0]


def splittable(x, dim: int, parts: int):
    """``x`` ready to have dimension ``dim`` split into (``parts``, …) by
    a reshape: a DTensor whose ``dim`` is split over a mesh dimension
    that does not divide ``parts`` is gathered along that mesh
    dimension first (DTensor splits a dimension only on whole parts,
    where the reference's compiler would pad).  Anything else is
    returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim %= x.dim()
    mesh = x.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim
          and parts % mesh.size(i) else p
          for i, p in enumerate(x.placements)]
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


NO_RULES = ShardingRules(mesh=None)


def on_mesh(rules):
    """The context the LM steps run under when ``rules`` has a mesh:
    DTensor's ``implicit_replication``, so a plain tensor the model code
    makes (positions, RoPE frequencies, masks, a vocabulary's ids) takes
    part in DTensor ops as the replicated value it is on every rank, and
    ``dist.collectives.host_staged`` (two gloo ranks on one card).
    Without a mesh, no context."""
    import contextlib

    if rules is None or rules.mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist.collectives import host_staged

    stack = contextlib.ExitStack()
    stack.enter_context(implicit_replication())
    stack.enter_context(host_staged(rules.mesh))
    return stack


# ===================================================== real tensors ======


def local_part(full, mesh, placements):
    """This rank's part of ``full`` under ``placements`` (a view): each
    mesh dimension that splits a tensor dimension takes this rank's
    chunk of it, in mesh order — DTensor's layout of a shard."""
    import torch
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            full = torch.chunk(full, mesh.size(i), dim=p.dim)[coord[i]]
    return full


def _first_replica(t) -> bool:
    """Whether this rank is the first of every mesh dimension the
    DTensor ``t`` is not split over: of the ranks holding the same
    part, the one that counts it."""
    from torch.distributed.tensor import Shard

    return not any(c and not isinstance(p, Shard) for c, p in zip(
        t.device_mesh.get_coordinate(), t.placements))


def place(tree, shardings):
    """``tree``'s tensors placed on a live mesh: each leaf a DTensor
    under its ``NamedSharding`` in ``shardings`` (a tree of the same
    structure), built from this rank's shard alone.  Every rank holds
    the full leaf (drawn or loaded from the same seed or file) and keeps
    its own part of it, copied to the mesh's device into storage of its
    own: no collective runs, and a leaf the caller drops leaves only its
    shard behind.  A leaf whose sharding is ``None``, and any non-tensor
    leaf, passes through.  The counterpart of the reference's
    ``jax.device_put(array, sharding)``.  A meta leaf (the dry-run's
    specs, on any mesh, the fake one too) gives a meta shard: nothing is
    allocated."""
    import torch
    from torch.distributed.tensor import DTensor

    def one(t, sh):
        if sh is None or not isinstance(t, torch.Tensor):
            return t
        mesh, pl = sh.mesh, sh.placements()
        shard = sh.shard_shape(tuple(t.shape))  # raises on an uneven split
        if t.is_meta:
            local = torch.empty(shard, dtype=t.dtype, device="meta")
        else:
            local = local_part(t.detach(), mesh, pl).to(
                mesh.device_type, copy=True,
                memory_format=torch.contiguous_format)
        return DTensor.from_local(
            local, mesh, pl, run_check=False, shape=t.shape,
            stride=torch.empty(t.shape, device="meta").stride())

    return tree_map(one, tree, shardings)


def zeros_placed(like, dtype, sh=None):
    """Zeros of ``like``'s global shape in ``dtype``: where ``like`` is a
    DTensor, a DTensor of this rank's shard alone, under ``sh`` (a
    ``NamedSharding``, ZeRO-1's moment placement) or else ``like``'s own
    placements; otherwise a plain tensor on ``like``'s device."""
    import torch
    from torch.distributed.tensor import DTensor

    if not is_dtensor(like):
        return torch.zeros(like.shape, dtype=dtype, device=like.device)
    mesh = like.device_mesh
    if sh is None:
        local = torch.zeros(like.to_local().shape, dtype=dtype,
                            device=like.to_local().device)
        pl = like.placements
    else:
        local = torch.zeros(sh.shard_shape(tuple(like.shape)), dtype=dtype,
                            device=like.to_local().device)
        pl = sh.placements()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=like.shape, stride=like.stride())


def replicate_like(t, like):
    """``t`` (a small plain tensor, the same on every rank) beside
    ``like``: replicated on ``like``'s mesh where ``like`` is a DTensor,
    on ``like``'s device otherwise."""
    if not is_dtensor(like):
        return t.to(like.device)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(t.to(like.to_local().device), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)


def owned_local(t):
    """The part of ``t`` this rank counts once in a reduction over the
    whole mesh: a DTensor's local shard where this rank is the first
    of every mesh dimension ``t`` is not split over (a replica counted
    once), an empty tensor on the others; a plain tensor itself."""
    if not is_dtensor(t):
        return t
    local = t.to_local()
    return local if _first_replica(t) else local.new_empty((0,))


def replicated_value(t):
    """A DTensor with a pending sum or a split reduced to the full value
    on every rank (a replicated DTensor, whose ``float()`` and ``item()``
    read the whole value on any rank); anything else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    want = [Replicate()] * t.device_mesh.ndim
    return t if list(t.placements) == want else t.redistribute(
        t.device_mesh, want)


def host_full(t, dst=None):
    """``t``'s full value as a host tensor.  Each rank of a DTensor's
    mesh puts its shard into its slot of a zero buffer of the full shape
    (a replica by its first holder only), and an integer SUM over the
    mesh's ranks gives the whole value, bit for bit
    (``collectives.slot_sum``, a collective every rank enters, on
    ``collectives.crossing_device``): the device holds no more than the
    shard under gloo.  With ``dst`` (a global rank) only ``dst`` gets
    the value and every other rank an empty tensor: a checkpoint's
    leaves, which rank 0 alone writes."""
    if not is_dtensor(t):
        return t.detach().cpu()
    from repro_torch.dist import collectives

    mesh, pl = t.device_mesh, t.placements
    if any(p.is_partial() for p in pl):
        raise ValueError("host_full takes split or replicated DTensors, "
                         f"not a pending sum ({pl})")
    first = _first_replica(t)
    full = collectives.slot_sum(
        t.to_local().detach(), t.shape,
        lambda buf: local_part(buf, mesh, pl) if first else None,
        collectives.mesh_group(mesh), dst=dst,
        device=collectives.crossing_device(mesh))
    return full.cpu()


def gather_full(t):
    """A DTensor as the full plain tensor on its mesh's device (an
    all-gather every rank of the mesh must enter); anything else as it
    is."""
    if not is_dtensor(t):
        return t
    from repro_torch.dist.collectives import host_staged

    with host_staged(t.device_mesh):
        return t.full_tensor()


# ===================================================== params ============


# per-param-name templates over the leaf's TRAILING dims.  FSDP resolves
# to 'data' when fsdp=True.
_PARAM_RULES: Mapping[str, tuple] = {
    # embeddings / heads: (Vp, D)
    "embed": ("model", FSDP),
    "lm_head": ("model", FSDP),
    "enc_pos": (None, FSDP),
    # attention: column-parallel in, row-parallel out
    "wq": (FSDP, "model"),
    "wk": (FSDP, "model"),
    "wv": (FSDP, "model"),
    "wo": ("model", FSDP),
    # dense SwiGLU: (D, F) / (F, D)
    "wg": (FSDP, "model"),
    "wu": (FSDP, "model"),
    "wd": ("model", FSDP),
    "router": (FSDP, None),
    # Mamba2: z/x/dt column-sharded by SSD heads; B/C replicated
    "in_z": (FSDP, "model"),
    "in_x": (FSDP, "model"),
    "in_dt": (FSDP, "model"),
    "in_bc": (FSDP, None),
    "out_proj": ("model", FSDP),
    "conv_wx": (None, "model"),
    "conv_bx": ("model",),
    "A_log": ("model",),
    "D_skip": ("model",),
    "dt_bias": ("model",),
}

# expert-stacked MoE weights (E, D, F) / (E, F, D): EP-resident shards
# experts over 'model' only; otherwise tensor-parallel like dense MLP.
_MOE_EP_RULES: Mapping[str, tuple] = {
    "wg": ("model", None, None),
    "wu": ("model", None, None),
    "wd": ("model", None, None),
}
_MOE_TP_RULES: Mapping[str, tuple] = {
    "wg": (None, FSDP, "model"),
    "wu": (None, FSDP, "model"),
    "wd": (None, "model", FSDP),
}


def _leaf_name(path: str) -> str:
    """The last key on a leaf's path that is a name, not a list index
    (``attn/3/wq`` → ``wq``)."""
    for key in reversed(path.split("/")):
        if key and not key.isdigit():
            return key
    return ""


def _is_expert_stacked(name: str, leaf) -> bool:
    # a per-layer moe wg/wu/wd carries the expert dim: (E, D, F) vs the
    # dense MLP's (D, F) — the reference's (L, E, D, F) vs (L, D, F)
    return name in ("wg", "wu", "wd") and len(leaf.shape) >= 3


def param_shardings(cfg, mesh, specs, *, fsdp: bool = True):
    """``NamedSharding`` tree for a param (or meta stand-in) tree.

    FSDP shards the non-'model' matmul dim over 'data'; tensor parallel
    follows the Megatron column→row pattern over 'model'.  Indivisible
    dims drop their constraint, so the same policy applies on any mesh.
    """

    def one(path, leaf):
        name = _leaf_name(path)
        if _is_expert_stacked(name, leaf):
            table = (_MOE_EP_RULES if getattr(cfg, "moe_ep_resident", True)
                     else _MOE_TP_RULES)
            template = table[name]
        else:
            template = _PARAM_RULES.get(name, ())
        return NamedSharding(mesh, _spec_for(template, leaf.shape, mesh,
                                             fsdp))

    return tree_map_with_names(one, specs)


def opt_shardings(p_sh, mesh, specs, *, zero1_axis: str = "data"):
    """ZeRO-1 optimizer-state shardings: additionally shard each moment
    over ``zero1_axis`` on the first still-replicated divisible dim
    (keeps Adam state at 1/dp_size per device).  On the port's per-layer
    leaves that dimension is never the reference's stacked L axis (see
    the module's docstring)."""
    k = mesh_axes(mesh).get(zero1_axis, 1)

    def one(_path, leaf, sh):
        shape = tuple(leaf.shape)
        spec = list(sh.spec) + [None] * (len(shape) - len(sh.spec))
        used = {a for e in spec for a in _entry_axes(e)}
        if zero1_axis in used:  # FSDP already owns this param's slice
            return sh
        for dim in range(len(shape)):
            if spec[dim] is None and k > 1 and shape[dim] % k == 0:
                spec[dim] = zero1_axis
                break
        return NamedSharding(mesh, tuple(spec))

    return tree_map_with_names(one, specs, p_sh)


# ===================================================== caches ============


# right-aligned templates per cache field (leading layer dim replicates):
#   attn/cross K,V : (L, B, S, Hkv, hd) — B over DP, S over 'model'
#   ssm h          : (L, B, H, P, N)    — SSD heads over 'model'
#   ssm conv_x     : (L, B, k-1, d_in)  — inner width over 'model'
#   ssm conv_bc    : (L, B, k-1, 2N)    — replicated (shared B/C)
_CACHE_RULES: Mapping[str, tuple] = {
    "attn_k": (BATCH, "model", None, None),
    "attn_v": (BATCH, "model", None, None),
    "cross_k": (BATCH, "model", None, None),
    "cross_v": (BATCH, "model", None, None),
    "h": (BATCH, "model", None, None),
    "conv_x": (BATCH, None, "model"),
    "conv_bc": (BATCH, None, None),
}


def cache_shardings(cfg, mesh, cache_specs, global_batch: int):
    """``NamedSharding`` tree matching a ``Cache`` tree.  The batch dim
    shards like the model inputs (``batch_pspec``); every other proposed
    axis drops when indivisible (e.g. whisper's 1500-frame cross cache).
    The cache's ``length`` (a Python int in the port) is no tensor and
    gets the replicated sharding."""
    batch_entry = _resolve_entry(BATCH, global_batch, mesh)

    def one(path, leaf):
        template = _CACHE_RULES.get(_leaf_name(path))
        shape = getattr(leaf, "shape", ())
        if template is None or len(shape) < len(template):
            return replicated(mesh)
        # resolve the batch slot against the actual batch entry so the
        # cache composes with the input shardings even when the global
        # batch only fits a prefix of the data axes
        template = tuple(batch_entry if e == BATCH else e for e in template)
        return NamedSharding(mesh, _spec_for(template, shape, mesh))

    return tree_map_with_names(one, cache_specs)


"""Model assembly for the 10 assigned architectures on PyTorch
(counterpart of ``repro/models/transformer.py``).

Families
  dense / moe / vlm : decoder-only transformer over per-layer groups
  ssm               : Mamba2 stack (attention-free)
  hybrid            : Jamba — periods of ``attn_period`` sublayer slots
                      (mamba slots, then one attention slot), MoE MLPs on
                      the slots ``moe_every`` / ``moe_offset`` pick
  encdec            : whisper — encoder stack, then a decoder stack with
                      cross-attention

Parameters are plain functions' inputs: a dict with the reference's
names, whose layer groups (``attn``, ``mlp``, ``moe``, ``ssm``,
``periods``, ``enc_attn``, ``enc_mlp``, ``cross``) are Python lists of
per-layer dicts where the reference stacks each leaf along a leading
(L, …) axis for its ``lax.scan``; a hybrid model's ``periods`` is the
list of its slots, each {"block": [a dict a period], "mlp": [...]}.
Eager PyTorch needs no scan, so a layer is a list entry and the layer
loop a Python loop; ``repro_torch.convert.params_from_numpy`` carries the
reference's stacked pytree across.

Every forward comes in three lowerings: ``forward_train`` (teacher
forcing), ``prefill`` (the same, filling the decode cache) and
``decode_step`` (one token against the cache); ``lm_features`` pools the
final-norm hidden states of the decoder-only families.  ``rules`` is a
``repro_torch.dist.sharding.ShardingRules``: the models call
``rules.act(x, name)`` at the reference's annotation points, which
redistributes a ``DTensor`` activation on a mesh (the dry-run) and is
the identity on one card's plain tensors (``NO_RULES``, the default).
Given DTensor inputs, a decode step writes its one cache row through the
reference's where-mask (the cache's S axis is split over ``model``),
prefill writes each layer's whole padded rows, and the MoE MLP takes its
mesh form (``moe.moe_mlp``); on plain tensors nothing changes, bit for
bit.  ``forward_train(remat=True)``
recomputes the reference's work units in the backward pass — each layer,
each SSM layer, each hybrid period, each encoder and encdec decoder
layer — through ``torch.utils.checkpoint``, and the MoE MLP its groups
under ``cfg.moe_remat_groups``; remat changes no number, and without
gradients it is a plain call.  ``prefill`` and ``decode_step`` write the
cache's tensors in place — no copy of the max-length caches a step — and
return the cache with its new length.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.mesh import resolve_device
from repro_torch.dist.sharding import NO_RULES, ShardingRules  # noqa: F401
from repro_torch.dist.sharding import (
    fsdp_gathered,
    is_dtensor,
    pad_dim,
    place,
    splittable,
)
from repro_torch.models.attention import chunked_attention
from repro_torch.models.layers import (
    ACC,
    apply_rope,
    dense,
    embed_init,
    he_init,
    remat_call,
    rms_norm,
    swiglu,
)
from repro_torch.models.moe import moe_mlp
from repro_torch.models.ssm import (
    SsmCacheSlice,
    init_ssm_params,
    mamba2_decode,
    mamba2_forward,
    mamba2_prefill,
)

KV_CHUNK = 1024  # online-softmax KV chunk (divides all assigned seq lens)


def vocab_padded(cfg: ModelConfig) -> int:
    return ((cfg.vocab_size + 255) // 256) * 256


# ====================================================== param init =======


def _ones(cfg, dtype, gen):
    return torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)


def _init_attn(gen, cfg, dtype):
    D, hd = cfg.d_model, cfg.head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "ln": _ones(cfg, dtype, gen),
        "wq": he_init(gen, (D, Hq * hd), dtype),
        "wk": he_init(gen, (D, Hkv * hd), dtype),
        "wv": he_init(gen, (D, Hkv * hd), dtype),
        "wo": he_init(gen, (Hq * hd, D), dtype),
    }


def _init_mlp(gen, cfg, dtype):
    D, F = cfg.d_model, cfg.d_ff
    return {
        "ln": _ones(cfg, dtype, gen),
        "wg": he_init(gen, (D, F), dtype),
        "wu": he_init(gen, (D, F), dtype),
        "wd": he_init(gen, (F, D), dtype),
    }


def _init_moe(gen, cfg, dtype):
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "ln": _ones(cfg, dtype, gen),
        "router": he_init(gen, (D, E), dtype),
        "wg": he_init(gen, (E, D, F), dtype, fan_in=D),
        "wu": he_init(gen, (E, D, F), dtype, fan_in=D),
        "wd": he_init(gen, (E, F, D), dtype, fan_in=F),
    }


def _init_ssm_layer(gen, cfg, dtype):
    p = init_ssm_params(gen, cfg, dtype)
    p["ln"] = _ones(cfg, dtype, gen)
    return p


def hybrid_slot_kinds(cfg: ModelConfig):
    """[(block_kind, mlp_kind)] for the ``attn_period`` sublayer slots."""
    kinds = []
    for i in range(cfg.attn_period):
        block = "attn" if i == cfg.attn_period - 1 else "ssm"
        mlp = ("moe" if cfg.n_experts and (i % cfg.moe_every
                                           == cfg.moe_offset) else "mlp")
        kinds.append((block, mlp))
    return kinds


class _MetaGenerator(torch.Generator):
    """A CPU generator whose draws go to the meta device: shapes and
    dtypes, no storage (``param_specs``)."""

    @property
    def device(self):
        return torch.device("meta")


def _generator(generator, device) -> torch.Generator:
    """A seed, or a generator on the device the parameters go to."""
    dev = resolve_device(device if device is not None
                         else getattr(generator, "device", None))
    if dev.type == "meta":
        return _MetaGenerator()
    if isinstance(generator, torch.Generator):
        if generator.device.type != dev.type:
            raise ValueError(f"the generator is on {generator.device}, the "
                             f"parameters go to {dev}")
        return generator
    return torch.Generator(device=dev).manual_seed(int(generator))


def init_params(cfg: ModelConfig, generator, dtype=torch.float32,
                device=None, shardings=None) -> Dict[str, Any]:
    """Random parameters for ``cfg`` from ``generator`` (a
    ``torch.Generator``, whose device they go to, or an int seed) on
    ``device`` (the card unless the caller asks for the CPU).  With
    ``shardings`` (``dist.sharding.param_shardings``' tree) each rank
    places every leaf on the live mesh as soon as it is drawn
    (``dist.sharding.place``): the draws are one device's, so the values
    are the one-process parameters', and a rank's peak is its shards and
    one layer's full leaves."""
    gen = _generator(generator, device)
    Vp, D = vocab_padded(cfg), cfg.d_model

    def put(tree, *path):
        if shardings is None:
            return tree
        sh = shardings
        for k in path:
            sh = sh[k]
        return place(tree, sh)

    params: Dict[str, Any] = {
        "embed": put(embed_init(gen, (Vp, D), dtype), "embed"),
        "final_norm": put(_ones(cfg, dtype, gen), "final_norm"),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = put(embed_init(gen, (Vp, D), dtype), "lm_head")
    L = cfg.n_layers

    def layers(init_fn, n, *path):
        return [put(init_fn(gen, cfg, dtype), *path, i) for i in range(n)]

    if cfg.family in ("dense", "vlm"):
        params["attn"] = layers(_init_attn, L, "attn")
        params["mlp"] = layers(_init_mlp, L, "mlp")
    elif cfg.family == "moe":
        params["attn"] = layers(_init_attn, L, "attn")
        params["moe"] = layers(_init_moe, L, "moe")
    elif cfg.family == "ssm":
        params["ssm"] = layers(_init_ssm_layer, L, "ssm")
    elif cfg.family == "hybrid":
        n_periods = L // cfg.attn_period
        params["periods"] = [
            {"block": layers(_init_attn if block == "attn"
                             else _init_ssm_layer, n_periods, "periods", j,
                             "block"),
             "mlp": layers(_init_moe if mlp == "moe" else _init_mlp,
                           n_periods, "periods", j, "mlp")}
            for j, (block, mlp) in enumerate(hybrid_slot_kinds(cfg))]
    elif cfg.family == "encdec":
        params["enc_attn"] = layers(_init_attn, cfg.n_enc_layers, "enc_attn")
        params["enc_mlp"] = layers(_init_mlp, cfg.n_enc_layers, "enc_mlp")
        params["enc_norm"] = put(_ones(cfg, dtype, gen), "enc_norm")
        params["enc_pos"] = put(embed_init(gen, (cfg.enc_len, D), dtype),
                                "enc_pos")
        params["attn"] = layers(_init_attn, L, "attn")
        params["cross"] = layers(_init_attn, L, "cross")
        params["mlp"] = layers(_init_mlp, L, "mlp")
    else:
        raise ValueError(cfg.family)
    return params


def param_specs(cfg: ModelConfig, dtype=torch.bfloat16) -> Dict[str, Any]:
    """The parameter tree as meta tensors — shapes and dtypes, no
    allocation (the dry-run's stand-ins)."""
    return init_params(cfg, 0, dtype, device="meta")


# ====================================================== blocks ===========


def _qkv(p, h, cfg, S):
    B = h.shape[0]
    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    return (splittable(dense(h, p["wq"]), -1, Hq).reshape(B, S, Hq, hd),
            splittable(dense(h, p["wk"]), -1, Hkv).reshape(B, S, Hkv, hd),
            splittable(dense(h, p["wv"]), -1, Hkv).reshape(B, S, Hkv, hd))


def _write_rows(c, t, start: int):
    """``c[:, start:start + S] = t`` in place, c (B, S_max, …).  A
    DTensor cache (S split over ``model``) takes the reference's one-hot
    where-mask, which stays shard-local: one token's row broadcast over
    S_max."""
    S = t.shape[1]
    if not is_dtensor(c):
        c[:, start:start + S] = t.to(c.dtype)
        return
    if S != 1:
        raise ValueError(f"a mesh decode writes one cache row, not {S}")
    pos = torch.arange(c.shape[1], device=c.device)
    slot = (pos == start)[None, :, None, None]
    c.copy_(torch.where(slot, t.to(c.dtype), c))


def _attn_block(p, x, positions, cfg, rules=NO_RULES, *, kv_chunk=KV_CHUNK,
                cache=None, cache_len=None):
    """Pre-norm attention with its residual.  ``cache``: one layer's
    (k, v), each (B, S_max, Hkv, hd), written in place at
    [cache_len, cache_len + S).  Returns (x, (k, v))."""
    B, S, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg, S)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    # decode's q/k/v stay heads-replicated so they compose with the
    # S-split cache (split-KV)
    sfx = "" if cache is None else "_dec"
    q, k, v = (rules.act(q, "act_q" + sfx), rules.act(k, "act_kv" + sfx),
               rules.act(v, "act_kv" + sfx))
    if cache is None:
        # up to 4k tokens in one pass; longer sequences chunked
        chunk = S if S <= 4096 else min(kv_chunk, S)
        out = chunked_attention(q, k, v, causal=True, kv_chunk=chunk)
        new_cache = (k, v)
    else:
        ck, cv = cache
        _write_rows(ck, k, cache_len)
        _write_rows(cv, v, cache_len)
        ck, cv = rules.act(ck, "cache"), rules.act(cv, "cache")
        out = chunked_attention(q, ck, cv, causal=False, q_offset=cache_len,
                                kv_len=cache_len + S,
                                kv_chunk=min(kv_chunk, ck.shape[1]))
        new_cache = (ck, cv)
    out = out.reshape(B, S, -1)
    if cache is not None:
        # keep wo's row split from reaching back into the S-split cache
        out = rules.act(out, "act_attn_out_dec")
    out = dense(out, p["wo"])
    return x + out, new_cache


def _cross_attn_block(p, x, cfg, *, enc_out=None, cross_cache=None):
    """Cross-attention (whisper's decoder): ``enc_out`` (prefill: builds
    the cross cache) or ``cross_cache`` (decode)."""
    B, S, _ = x.shape
    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = splittable(dense(h, p["wq"]), -1, Hq).reshape(B, S, Hq, hd)
    if cross_cache is None:
        k = splittable(dense(enc_out, p["wk"]), -1, Hkv).reshape(
            B, -1, Hkv, hd)
        v = splittable(dense(enc_out, p["wv"]), -1, Hkv).reshape(
            B, -1, Hkv, hd)
    else:
        k, v = cross_cache
    out = chunked_attention(q, k, v, causal=False,
                            kv_chunk=min(KV_CHUNK, k.shape[1]))
    out = dense(out.reshape(B, S, Hq * hd), p["wo"])
    return x + out, (k, v)


def _mlp_block(p, x, cfg, rules=NO_RULES):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    h = rules.act(h, "act_mlp_in")
    return x + swiglu(h, p["wg"], p["wu"], p["wd"])


def _moe_block(p, x, cfg, rules=NO_RULES, no_drop: bool = False):
    B, S, D = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps).reshape(B * S, D)
    group = min(2048, B * S)
    # serving (no_drop) capacity is C = g: the einsum combine is then
    # O(g²·E), taken only where the experts dwarf it
    dispatch = cfg.moe_dispatch
    if no_drop and 3 * cfg.d_ff < 2 * group:
        dispatch = "scatter"
    out, aux = moe_mlp(h, p["router"], p["wg"], p["wu"], p["wd"],
                       top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       group_size=group, no_drop=no_drop, dispatch=dispatch,
                       remat_groups=cfg.moe_remat_groups, rules=rules)
    return x + out.reshape(B, S, D), aux


def _ssm_block(p, x, cfg, rules=NO_RULES, *, cache=None, mode="train"):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if mode == "train":
        return x + mamba2_forward(p, h, cfg, rules), None
    if mode == "prefill":
        out, slice_ = mamba2_prefill(p, h, cfg, rules)
        return x + out, slice_
    out, slice_ = mamba2_decode(p, h, cache, cfg, rules)
    return x + out, slice_


# ====================================================== embeddings =======


def _embed_in(cfg, params, batch, rules=NO_RULES):
    dev = params["embed"].device
    if cfg.embeds_in and "embeds" in batch:
        x = torch.as_tensor(batch["embeds"], device=dev)
    else:
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        embed = params["embed"]
        x = (_embed_split(embed, tokens) if is_dtensor(embed)
             else embed[tokens])
    return rules.act(x, "act_resid")


def _embed_split(embed, tokens):
    """The embedding lookup on a mesh, where the table lies: each device
    reads the rows of its own vocabulary range (and its own columns of
    an FSDP split) for every id, the ids replicated (B·S ints), under
    ``local_map``; a row outside the range reads zeros, so the output is
    a pending sum over the vocabulary split and a column split over the
    FSDP one.  No device gathers the table, and each device's gradient
    is its own rows' (an indexed read's backward on a split id tensor
    has no DTensor rule on some torch versions, ROADMAP C.21)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = embed.device_mesh
    rep = (Replicate(),) * mesh.ndim
    ids = (tokens.redistribute(mesh, rep) if is_dtensor(tokens)
           else tokens)
    V = embed.shape[0]
    vocab = [i for i, p in enumerate(embed.placements)
             if isinstance(p, Shard) and p.dim == 0]
    out = tuple(Partial() if isinstance(p, Shard) and p.dim == 0 else
                Shard(ids.dim()) if isinstance(p, Shard) else Replicate()
                for p in embed.placements)

    def lookup(table, ids):
        lo = 0
        rows = V
        for i in vocab:  # this device's range of the vocabulary splits
            rows //= mesh.size(i)
            lo += mesh.get_local_rank(i) * rows
        mine = (ids >= lo) & (ids < lo + rows)
        got = table[torch.where(mine, ids - lo, 0)]
        return (torch.where(mine[..., None], got, torch.zeros_like(got)),)

    return local_map(lookup, (out,), in_placements=(embed.placements, rep),
                     device_mesh=mesh)(embed, ids)[0]


def _logits_out(cfg, params, x, rules=NO_RULES):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x, fsdp_gathered(head).t().to(x.dtype)).to(ACC)
    return rules.act(logits, "act_logits")


def _positions(batch, B, S, device):
    if "positions" in batch:
        return torch.as_tensor(batch["positions"], device=device)
    return torch.arange(S, device=device)[None].expand(B, S)


def _periods(params):
    return len(params["periods"][0]["block"])


# ====================================================== forward_train ====


def _backbone(cfg: ModelConfig, params, batch, moe_no_drop: bool = False,
              remat: bool = False, rules=NO_RULES):
    """The decoder stack up to (not including) the final norm: (hidden
    (B, S, D), aux loss) — the trunk ``forward_train`` and
    ``lm_features`` share.  ``remat`` recomputes each layer (a hybrid
    model's each period) in the backward pass.  Raises for encdec, whose
    decoder needs the encoder's context."""
    if cfg.family == "encdec":
        raise ValueError(
            "encdec has no decoder-only backbone; use forward_train")
    x = _embed_in(cfg, params, batch, rules)
    B, S = x.shape[:2]
    positions = _positions(batch, B, S, x.device)
    aux = torch.zeros((), dtype=ACC, device=x.device)
    if cfg.family in ("dense", "vlm", "moe"):
        is_moe = cfg.family == "moe"

        def layer(x, lp_attn, lp_mlp):
            x, _ = _attn_block(lp_attn, x, positions, cfg, rules)
            if is_moe:
                x, a = _moe_block(lp_mlp, x, cfg, rules, no_drop=moe_no_drop)
            else:
                x, a = _mlp_block(lp_mlp, x, cfg, rules), None
            return rules.act(x, "act_resid"), a

        for lp_attn, lp_mlp in zip(params["attn"],
                                   params["moe" if is_moe else "mlp"]):
            x, a = remat_call(layer, x, lp_attn, lp_mlp, remat=remat)
            if is_moe:
                aux = aux + a
    elif cfg.family == "ssm":

        def layer(x, lp):
            x = _ssm_block(lp, x, cfg, rules, mode="train")[0]
            return rules.act(x, "act_resid")

        for lp in params["ssm"]:
            x = remat_call(layer, x, lp, remat=remat)
    elif cfg.family == "hybrid":
        kinds = hybrid_slot_kinds(cfg)

        def period(x, slots):
            a_sum = torch.zeros((), dtype=ACC, device=x.device)
            for (bp, mp), (block, mlp) in zip(slots, kinds):
                if block == "attn":
                    x, _ = _attn_block(bp, x, positions, cfg, rules)
                else:
                    x, _ = _ssm_block(bp, x, cfg, rules, mode="train")
                if mlp == "moe":
                    x, a = _moe_block(mp, x, cfg, rules,
                                      no_drop=moe_no_drop)
                    a_sum = a_sum + a
                else:
                    x = _mlp_block(mp, x, cfg, rules)
                x = rules.act(x, "act_resid")
            return x, a_sum

        for pi in range(_periods(params)):
            slots = [(slot["block"][pi], slot["mlp"][pi])
                     for slot in params["periods"]]
            x, a = remat_call(period, x, slots, remat=remat)
            aux = aux + a
    else:
        raise ValueError(cfg.family)
    return x, aux


def forward_train(cfg: ModelConfig, params, batch, remat: bool = True,
                  moe_no_drop: bool = False, rules=NO_RULES):
    """Teacher-forced logits: (logits (B, S, Vp) float32, aux loss).
    ``remat`` recomputes each work unit's activations in the backward
    pass (the reference's default, on); ``moe_no_drop`` disables MoE
    token dropping (parity checks); ``rules`` places the activations on
    a mesh (the dry-run)."""
    if cfg.family == "encdec":
        return _encdec_forward(cfg, params, batch, remat, rules)
    x, aux = _backbone(cfg, params, batch, moe_no_drop=moe_no_drop,
                       remat=remat, rules=rules)
    return _logits_out(cfg, params, x, rules), aux


def lm_features(cfg: ModelConfig, params, tokens, rules=NO_RULES):
    """Frozen-backbone sequence features: the final-norm hidden states
    mean-pooled over the sequence, (B, D) for (B, S) tokens — the map the
    linear probe trains PASSCoDe heads on.  Raises for encdec."""
    x, _ = _backbone(cfg, params, {"tokens": tokens}, rules=rules)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return torch.mean(x, dim=1)


def _encoder(cfg, params, enc_embeds, remat: bool = False, rules=NO_RULES):
    x = torch.as_tensor(enc_embeds, device=params["enc_pos"].device)
    x = x + params["enc_pos"][None, :x.shape[1]]
    B, S = x.shape[:2]
    hd, Hq = cfg.head_dim, cfg.n_heads

    def layer(x, lp_attn, lp_mlp):
        h = rms_norm(x, lp_attn["ln"], cfg.norm_eps)
        q, k, v = _qkv(lp_attn, h, cfg, S)
        out = chunked_attention(q, k, v, causal=False,
                                kv_chunk=min(KV_CHUNK, S))
        x = x + dense(out.reshape(B, S, Hq * hd), lp_attn["wo"])
        return _mlp_block(lp_mlp, x, cfg, rules)

    for lp_attn, lp_mlp in zip(params["enc_attn"], params["enc_mlp"]):
        x = remat_call(layer, x, lp_attn, lp_mlp, remat=remat)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _encdec_forward(cfg, params, batch, remat: bool = False,
                    rules=NO_RULES):
    enc_out = _encoder(cfg, params, batch["enc_embeds"], remat, rules)
    x = _embed_in(cfg, params, batch)
    B, S = x.shape[:2]
    positions = _positions(batch, B, S, x.device)

    def layer(x, lp_attn, lp_cross, lp_mlp):
        x, _ = _attn_block(lp_attn, x, positions, cfg, rules)
        x, _ = _cross_attn_block(lp_cross, x, cfg, enc_out=enc_out)
        x = _mlp_block(lp_mlp, x, cfg, rules)
        return rules.act(x, "act_resid")

    for lp_attn, lp_cross, lp_mlp in zip(params["attn"], params["cross"],
                                         params["mlp"]):
        x = remat_call(layer, x, lp_attn, lp_cross, lp_mlp, remat=remat)
    return (_logits_out(cfg, params, x, rules),
            torch.zeros((), dtype=ACC, device=x.device))


# ====================================================== caches ===========


class Cache(NamedTuple):
    """The decode cache; a field is None where the family has no such
    layers.  ``length`` is the count of tokens already cached."""

    attn_k: Optional[torch.Tensor]  # (L_attn, B, S_max, Hkv, hd)
    attn_v: Optional[torch.Tensor]
    ssm: Optional[SsmCacheSlice]  # (L_ssm, ...) fields
    cross_k: Optional[torch.Tensor]  # (L, B, S_enc, Hkv, hd) — encdec
    cross_v: Optional[torch.Tensor]
    length: int


def cache_max_len(seq_len: int) -> int:
    """seq_len cached tokens and headroom, rounded up to the KV chunk."""
    return ((seq_len + KV_CHUNK) // KV_CHUNK) * KV_CHUNK


def _n_attn_ssm_layers(cfg):
    if cfg.family == "ssm":
        return 0, cfg.n_layers
    if cfg.family == "hybrid":
        n_periods = cfg.n_layers // cfg.attn_period
        return n_periods, cfg.n_layers - n_periods
    return cfg.n_layers, 0


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Cache:
    """An empty cache on ``device`` (the card unless the caller asks for
    the CPU); the SSD state is float32 whatever ``dtype``."""
    dev = resolve_device(device)
    n_attn, n_ssm = _n_attn_ssm_layers(cfg)
    hd, Hkv = cfg.head_dim, cfg.n_kv_heads

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    attn_k = attn_v = ssm = cross_k = cross_v = None
    if n_attn:
        attn_k = zeros((n_attn, batch_size, max_len, Hkv, hd))
        attn_v = zeros((n_attn, batch_size, max_len, Hkv, hd))
    if n_ssm:
        k1 = cfg.conv_kernel - 1
        ssm = SsmCacheSlice(
            h=zeros((n_ssm, batch_size, cfg.ssm_heads, cfg.ssm_head_dim,
                     cfg.ssm_state), ACC),
            conv_x=zeros((n_ssm, batch_size, k1, cfg.d_inner)),
            conv_bc=zeros((n_ssm, batch_size, k1, 2 * cfg.ssm_state)))
    if cfg.is_encdec:
        cross_k = zeros((cfg.n_layers, batch_size, cfg.enc_len, Hkv, hd))
        cross_v = zeros((cfg.n_layers, batch_size, cfg.enc_len, Hkv, hd))
    return Cache(attn_k, attn_v, ssm, cross_k, cross_v, 0)


def _put_kv(cache, l, k, v):
    """Layer l's prompt (k, v) into the cache, the rest of it zeroed (on
    a DTensor cache: the padded rows, the reference's ``pad_kv``, in one
    copy)."""
    S = k.shape[1]
    for c, t in ((cache.attn_k, k), (cache.attn_v, v)):
        if is_dtensor(c):
            c[l].copy_(pad_dim(t.to(c.dtype), 1, 0, c.shape[2] - S))
            continue
        c[l, :, :S] = t.to(c.dtype)
        c[l, :, S:] = 0


def _put_ssm(cache, l, sl):
    for c, t in zip(cache.ssm, sl):
        c[l].copy_(t.to(c.dtype))


def _ssm_slice(cache, l):
    return SsmCacheSlice(*(c[l] for c in cache.ssm))


def _ssm_layer(cfg, slot: int, period: int) -> int:
    """A hybrid model's cache row of the ssm slot ``slot`` of period
    ``period``: slot-major, as the reference concatenates its slots."""
    return slot * (cfg.n_layers // cfg.attn_period) + period


# ====================================================== prefill ==========


def prefill(cfg: ModelConfig, params, batch, cache: Cache, rules=NO_RULES):
    """Run the whole prompt and fill the cache.  Returns (the last
    position's logits (B, 1, Vp), the cache)."""
    x = _embed_in(cfg, params, batch, rules)
    B, S = x.shape[:2]
    positions = _positions(batch, B, S, x.device)
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        is_moe = cfg.family == "moe"
        enc_out = (_encoder(cfg, params, batch["enc_embeds"], rules=rules)
                   if cfg.is_encdec else None)
        mlps = params["moe" if is_moe else "mlp"]
        for l, (lp_attn, lp_mlp) in enumerate(zip(params["attn"], mlps)):
            x, (k, v) = _attn_block(lp_attn, x, positions, cfg, rules)
            _put_kv(cache, l, k, v)
            if cfg.is_encdec:
                x, (ck, cv) = _cross_attn_block(params["cross"][l], x, cfg,
                                                enc_out=enc_out)
                cache.cross_k[l].copy_(ck.to(cache.cross_k.dtype))
                cache.cross_v[l].copy_(cv.to(cache.cross_v.dtype))
            if is_moe:
                x, _ = _moe_block(lp_mlp, x, cfg, rules, no_drop=True)
            else:
                x = _mlp_block(lp_mlp, x, cfg, rules)
            x = rules.act(x, "act_resid")
    elif cfg.family == "ssm":
        for l, lp in enumerate(params["ssm"]):
            x, sl = _ssm_block(lp, x, cfg, rules, mode="prefill")
            _put_ssm(cache, l, sl)
            x = rules.act(x, "act_resid")
    elif cfg.family == "hybrid":
        kinds = hybrid_slot_kinds(cfg)
        for pi in range(_periods(params)):
            for i, (slot, (block, mlp)) in enumerate(zip(params["periods"],
                                                         kinds)):
                bp, mp = slot["block"][pi], slot["mlp"][pi]
                if block == "attn":
                    x, (k, v) = _attn_block(bp, x, positions, cfg, rules)
                    _put_kv(cache, pi, k, v)
                else:
                    x, sl = _ssm_block(bp, x, cfg, rules, mode="prefill")
                    _put_ssm(cache, _ssm_layer(cfg, i, pi), sl)
                if mlp == "moe":
                    x, _ = _moe_block(mp, x, cfg, rules, no_drop=True)
                else:
                    x = _mlp_block(mp, x, cfg, rules)
                x = rules.act(x, "act_resid")
    else:
        raise ValueError(cfg.family)
    logits = _logits_out(cfg, params, x[:, -1:, :], rules)
    return logits, cache._replace(length=S)


# ====================================================== decode ===========


def decode_step(cfg: ModelConfig, params, batch, cache: Cache,
                rules=NO_RULES):
    """One new token.  batch: {"tokens": (B, 1)} or {"embeds": (B, 1, D)};
    positions default to the cache's length.  Returns (logits (B, 1, Vp),
    the cache)."""
    x = _embed_in(cfg, params, batch, rules)
    B = x.shape[0]
    L = int(cache.length)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.full((B, 1), L, dtype=torch.int64,
                               device=x.device)
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        is_moe = cfg.family == "moe"
        mlps = params["moe" if is_moe else "mlp"]
        for l, (lp_attn, lp_mlp) in enumerate(zip(params["attn"], mlps)):
            x, _ = _attn_block(lp_attn, x, positions, cfg, rules,
                               cache=(cache.attn_k[l], cache.attn_v[l]),
                               cache_len=L)
            if cfg.is_encdec:
                x, _ = _cross_attn_block(
                    params["cross"][l], x, cfg,
                    cross_cache=(cache.cross_k[l], cache.cross_v[l]))
            if is_moe:
                x, _ = _moe_block(lp_mlp, x, cfg, rules, no_drop=True)
            else:
                x = _mlp_block(lp_mlp, x, cfg, rules)
    elif cfg.family == "ssm":
        for l, lp in enumerate(params["ssm"]):
            x, sl = _ssm_block(lp, x, cfg, rules, cache=_ssm_slice(cache, l),
                               mode="decode")
            _put_ssm(cache, l, sl)
    elif cfg.family == "hybrid":
        kinds = hybrid_slot_kinds(cfg)
        for pi in range(_periods(params)):
            for i, (slot, (block, mlp)) in enumerate(zip(params["periods"],
                                                         kinds)):
                bp, mp = slot["block"][pi], slot["mlp"][pi]
                if block == "attn":
                    x, _ = _attn_block(
                        bp, x, positions, cfg, rules,
                        cache=(cache.attn_k[pi], cache.attn_v[pi]),
                        cache_len=L)
                else:
                    row = _ssm_layer(cfg, i, pi)
                    x, sl = _ssm_block(bp, x, cfg, rules,
                                       cache=_ssm_slice(cache, row),
                                       mode="decode")
                    _put_ssm(cache, row, sl)
                if mlp == "moe":
                    x, _ = _moe_block(mp, x, cfg, rules, no_drop=True)
                else:
                    x = _mlp_block(mp, x, cfg, rules)
    else:
        raise ValueError(cfg.family)
    return (_logits_out(cfg, params, x, rules),
            cache._replace(length=L + 1))

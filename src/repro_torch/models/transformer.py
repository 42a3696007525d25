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
final-norm hidden states of the decoder-only families.  The port runs on
one card: no sharding rules (``rules``).  ``forward_train(remat=True)``
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


def _layers(init_fn, gen, n, cfg, dtype):
    return [init_fn(gen, cfg, dtype) for _ in range(n)]


def hybrid_slot_kinds(cfg: ModelConfig):
    """[(block_kind, mlp_kind)] for the ``attn_period`` sublayer slots."""
    kinds = []
    for i in range(cfg.attn_period):
        block = "attn" if i == cfg.attn_period - 1 else "ssm"
        mlp = ("moe" if cfg.n_experts and (i % cfg.moe_every
                                           == cfg.moe_offset) else "mlp")
        kinds.append((block, mlp))
    return kinds


def _generator(generator, device) -> torch.Generator:
    """A seed, or a generator on the device the parameters go to."""
    dev = resolve_device(device if device is not None
                         else getattr(generator, "device", None))
    if isinstance(generator, torch.Generator):
        if generator.device.type != dev.type:
            raise ValueError(f"the generator is on {generator.device}, the "
                             f"parameters go to {dev}")
        return generator
    return torch.Generator(device=dev).manual_seed(int(generator))


def init_params(cfg: ModelConfig, generator, dtype=torch.float32,
                device=None) -> Dict[str, Any]:
    """Random parameters for ``cfg`` from ``generator`` (a
    ``torch.Generator``, whose device they go to, or an int seed) on
    ``device`` (the card unless the caller asks for the CPU)."""
    gen = _generator(generator, device)
    Vp, D = vocab_padded(cfg), cfg.d_model
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (Vp, D), dtype),
        "final_norm": _ones(cfg, dtype, gen),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, (Vp, D), dtype)
    L = cfg.n_layers
    if cfg.family in ("dense", "vlm"):
        params["attn"] = _layers(_init_attn, gen, L, cfg, dtype)
        params["mlp"] = _layers(_init_mlp, gen, L, cfg, dtype)
    elif cfg.family == "moe":
        params["attn"] = _layers(_init_attn, gen, L, cfg, dtype)
        params["moe"] = _layers(_init_moe, gen, L, cfg, dtype)
    elif cfg.family == "ssm":
        params["ssm"] = _layers(_init_ssm_layer, gen, L, cfg, dtype)
    elif cfg.family == "hybrid":
        n_periods = L // cfg.attn_period
        params["periods"] = [
            {"block": _layers(_init_attn if block == "attn"
                              else _init_ssm_layer, gen, n_periods, cfg,
                              dtype),
             "mlp": _layers(_init_moe if mlp == "moe" else _init_mlp, gen,
                            n_periods, cfg, dtype)}
            for block, mlp in hybrid_slot_kinds(cfg)]
    elif cfg.family == "encdec":
        params["enc_attn"] = _layers(_init_attn, gen, cfg.n_enc_layers, cfg,
                                     dtype)
        params["enc_mlp"] = _layers(_init_mlp, gen, cfg.n_enc_layers, cfg,
                                    dtype)
        params["enc_norm"] = _ones(cfg, dtype, gen)
        params["enc_pos"] = embed_init(gen, (cfg.enc_len, D), dtype)
        params["attn"] = _layers(_init_attn, gen, L, cfg, dtype)
        params["cross"] = _layers(_init_attn, gen, L, cfg, dtype)
        params["mlp"] = _layers(_init_mlp, gen, L, cfg, dtype)
    else:
        raise ValueError(cfg.family)
    return params


# ====================================================== blocks ===========


def _qkv(p, h, cfg, S):
    B = h.shape[0]
    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    return (dense(h, p["wq"]).reshape(B, S, Hq, hd),
            dense(h, p["wk"]).reshape(B, S, Hkv, hd),
            dense(h, p["wv"]).reshape(B, S, Hkv, hd))


def _attn_block(p, x, positions, cfg, *, kv_chunk=KV_CHUNK, cache=None,
                cache_len=None):
    """Pre-norm attention with its residual.  ``cache``: one layer's
    (k, v), each (B, S_max, Hkv, hd), written in place at
    [cache_len, cache_len + S).  Returns (x, (k, v))."""
    B, S, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg, S)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    if cache is None:
        # up to 4k tokens in one pass; longer sequences chunked
        chunk = S if S <= 4096 else min(kv_chunk, S)
        out = chunked_attention(q, k, v, causal=True, kv_chunk=chunk)
        new_cache = (k, v)
    else:
        ck, cv = cache
        ck[:, cache_len:cache_len + S] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + S] = v.to(cv.dtype)
        out = chunked_attention(q, ck, cv, causal=False, q_offset=cache_len,
                                kv_len=cache_len + S,
                                kv_chunk=min(kv_chunk, ck.shape[1]))
        new_cache = (ck, cv)
    out = dense(out.reshape(B, S, -1), p["wo"])
    return x + out, new_cache


def _cross_attn_block(p, x, cfg, *, enc_out=None, cross_cache=None):
    """Cross-attention (whisper's decoder): ``enc_out`` (prefill: builds
    the cross cache) or ``cross_cache`` (decode)."""
    B, S, _ = x.shape
    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = dense(h, p["wq"]).reshape(B, S, Hq, hd)
    if cross_cache is None:
        k = dense(enc_out, p["wk"]).reshape(B, -1, Hkv, hd)
        v = dense(enc_out, p["wv"]).reshape(B, -1, Hkv, hd)
    else:
        k, v = cross_cache
    out = chunked_attention(q, k, v, causal=False,
                            kv_chunk=min(KV_CHUNK, k.shape[1]))
    out = dense(out.reshape(B, S, Hq * hd), p["wo"])
    return x + out, (k, v)


def _mlp_block(p, x, cfg):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + swiglu(h, p["wg"], p["wu"], p["wd"])


def _moe_block(p, x, cfg, no_drop: bool = False):
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
                       remat_groups=cfg.moe_remat_groups)
    return x + out.reshape(B, S, D), aux


def _ssm_block(p, x, cfg, *, cache=None, mode="train"):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if mode == "train":
        return x + mamba2_forward(p, h, cfg), None
    if mode == "prefill":
        out, slice_ = mamba2_prefill(p, h, cfg)
        return x + out, slice_
    out, slice_ = mamba2_decode(p, h, cache, cfg)
    return x + out, slice_


# ====================================================== embeddings =======


def _embed_in(cfg, params, batch):
    dev = params["embed"].device
    if cfg.embeds_in and "embeds" in batch:
        return torch.as_tensor(batch["embeds"], device=dev)
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    return params["embed"][tokens]


def _logits_out(cfg, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x, head.t().to(x.dtype)).to(ACC)


def _positions(batch, B, S, device):
    if "positions" in batch:
        return torch.as_tensor(batch["positions"], device=device)
    return torch.arange(S, device=device)[None].expand(B, S)


def _periods(params):
    return len(params["periods"][0]["block"])


# ====================================================== forward_train ====


def _backbone(cfg: ModelConfig, params, batch, moe_no_drop: bool = False,
              remat: bool = False):
    """The decoder stack up to (not including) the final norm: (hidden
    (B, S, D), aux loss) — the trunk ``forward_train`` and
    ``lm_features`` share.  ``remat`` recomputes each layer (a hybrid
    model's each period) in the backward pass.  Raises for encdec, whose
    decoder needs the encoder's context."""
    if cfg.family == "encdec":
        raise ValueError(
            "encdec has no decoder-only backbone; use forward_train")
    x = _embed_in(cfg, params, batch)
    B, S = x.shape[:2]
    positions = _positions(batch, B, S, x.device)
    aux = torch.zeros((), dtype=ACC, device=x.device)
    if cfg.family in ("dense", "vlm", "moe"):
        is_moe = cfg.family == "moe"

        def layer(x, lp_attn, lp_mlp):
            x, _ = _attn_block(lp_attn, x, positions, cfg)
            if is_moe:
                return _moe_block(lp_mlp, x, cfg, no_drop=moe_no_drop)
            return _mlp_block(lp_mlp, x, cfg), None

        for lp_attn, lp_mlp in zip(params["attn"],
                                   params["moe" if is_moe else "mlp"]):
            x, a = remat_call(layer, x, lp_attn, lp_mlp, remat=remat)
            if is_moe:
                aux = aux + a
    elif cfg.family == "ssm":

        def layer(x, lp):
            return _ssm_block(lp, x, cfg, mode="train")[0]

        for lp in params["ssm"]:
            x = remat_call(layer, x, lp, remat=remat)
    elif cfg.family == "hybrid":
        kinds = hybrid_slot_kinds(cfg)

        def period(x, slots):
            a_sum = torch.zeros((), dtype=ACC, device=x.device)
            for (bp, mp), (block, mlp) in zip(slots, kinds):
                if block == "attn":
                    x, _ = _attn_block(bp, x, positions, cfg)
                else:
                    x, _ = _ssm_block(bp, x, cfg, mode="train")
                if mlp == "moe":
                    x, a = _moe_block(mp, x, cfg, no_drop=moe_no_drop)
                    a_sum = a_sum + a
                else:
                    x = _mlp_block(mp, x, cfg)
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
                  moe_no_drop: bool = False):
    """Teacher-forced logits: (logits (B, S, Vp) float32, aux loss).
    ``remat`` recomputes each work unit's activations in the backward
    pass (the reference's default, on); ``moe_no_drop`` disables MoE
    token dropping (parity checks)."""
    if cfg.family == "encdec":
        return _encdec_forward(cfg, params, batch, remat)
    x, aux = _backbone(cfg, params, batch, moe_no_drop=moe_no_drop,
                       remat=remat)
    return _logits_out(cfg, params, x), aux


def lm_features(cfg: ModelConfig, params, tokens):
    """Frozen-backbone sequence features: the final-norm hidden states
    mean-pooled over the sequence, (B, D) for (B, S) tokens — the map the
    linear probe trains PASSCoDe heads on.  Raises for encdec."""
    x, _ = _backbone(cfg, params, {"tokens": tokens})
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return torch.mean(x, dim=1)


def _encoder(cfg, params, enc_embeds, remat: bool = False):
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
        return _mlp_block(lp_mlp, x, cfg)

    for lp_attn, lp_mlp in zip(params["enc_attn"], params["enc_mlp"]):
        x = remat_call(layer, x, lp_attn, lp_mlp, remat=remat)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _encdec_forward(cfg, params, batch, remat: bool = False):
    enc_out = _encoder(cfg, params, batch["enc_embeds"], remat)
    x = _embed_in(cfg, params, batch)
    B, S = x.shape[:2]
    positions = _positions(batch, B, S, x.device)

    def layer(x, lp_attn, lp_cross, lp_mlp):
        x, _ = _attn_block(lp_attn, x, positions, cfg)
        x, _ = _cross_attn_block(lp_cross, x, cfg, enc_out=enc_out)
        return _mlp_block(lp_mlp, x, cfg)

    for lp_attn, lp_cross, lp_mlp in zip(params["attn"], params["cross"],
                                         params["mlp"]):
        x = remat_call(layer, x, lp_attn, lp_cross, lp_mlp, remat=remat)
    return (_logits_out(cfg, params, x),
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
    """Layer l's prompt (k, v) into the cache, the rest of it zeroed."""
    S = k.shape[1]
    for c, t in ((cache.attn_k, k), (cache.attn_v, v)):
        c[l, :, :S] = t.to(c.dtype)
        c[l, :, S:] = 0


def _put_ssm(cache, l, sl):
    for c, t in zip(cache.ssm, sl):
        c[l] = t.to(c.dtype)


def _ssm_slice(cache, l):
    return SsmCacheSlice(*(c[l] for c in cache.ssm))


def _ssm_layer(cfg, slot: int, period: int) -> int:
    """A hybrid model's cache row of the ssm slot ``slot`` of period
    ``period``: slot-major, as the reference concatenates its slots."""
    return slot * (cfg.n_layers // cfg.attn_period) + period


# ====================================================== prefill ==========


def prefill(cfg: ModelConfig, params, batch, cache: Cache):
    """Run the whole prompt and fill the cache.  Returns (the last
    position's logits (B, 1, Vp), the cache)."""
    x = _embed_in(cfg, params, batch)
    B, S = x.shape[:2]
    positions = _positions(batch, B, S, x.device)
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        is_moe = cfg.family == "moe"
        enc_out = (_encoder(cfg, params, batch["enc_embeds"])
                   if cfg.is_encdec else None)
        mlps = params["moe" if is_moe else "mlp"]
        for l, (lp_attn, lp_mlp) in enumerate(zip(params["attn"], mlps)):
            x, (k, v) = _attn_block(lp_attn, x, positions, cfg)
            _put_kv(cache, l, k, v)
            if cfg.is_encdec:
                x, (ck, cv) = _cross_attn_block(params["cross"][l], x, cfg,
                                                enc_out=enc_out)
                cache.cross_k[l] = ck.to(cache.cross_k.dtype)
                cache.cross_v[l] = cv.to(cache.cross_v.dtype)
            if is_moe:
                x, _ = _moe_block(lp_mlp, x, cfg, no_drop=True)
            else:
                x = _mlp_block(lp_mlp, x, cfg)
    elif cfg.family == "ssm":
        for l, lp in enumerate(params["ssm"]):
            x, sl = _ssm_block(lp, x, cfg, mode="prefill")
            _put_ssm(cache, l, sl)
    elif cfg.family == "hybrid":
        kinds = hybrid_slot_kinds(cfg)
        for pi in range(_periods(params)):
            for i, (slot, (block, mlp)) in enumerate(zip(params["periods"],
                                                         kinds)):
                bp, mp = slot["block"][pi], slot["mlp"][pi]
                if block == "attn":
                    x, (k, v) = _attn_block(bp, x, positions, cfg)
                    _put_kv(cache, pi, k, v)
                else:
                    x, sl = _ssm_block(bp, x, cfg, mode="prefill")
                    _put_ssm(cache, _ssm_layer(cfg, i, pi), sl)
                if mlp == "moe":
                    x, _ = _moe_block(mp, x, cfg, no_drop=True)
                else:
                    x = _mlp_block(mp, x, cfg)
    else:
        raise ValueError(cfg.family)
    logits = _logits_out(cfg, params, x[:, -1:, :])
    return logits, cache._replace(length=S)


# ====================================================== decode ===========


def decode_step(cfg: ModelConfig, params, batch, cache: Cache):
    """One new token.  batch: {"tokens": (B, 1)} or {"embeds": (B, 1, D)};
    positions default to the cache's length.  Returns (logits (B, 1, Vp),
    the cache)."""
    x = _embed_in(cfg, params, batch)
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
            x, _ = _attn_block(lp_attn, x, positions, cfg,
                               cache=(cache.attn_k[l], cache.attn_v[l]),
                               cache_len=L)
            if cfg.is_encdec:
                x, _ = _cross_attn_block(
                    params["cross"][l], x, cfg,
                    cross_cache=(cache.cross_k[l], cache.cross_v[l]))
            if is_moe:
                x, _ = _moe_block(lp_mlp, x, cfg, no_drop=True)
            else:
                x = _mlp_block(lp_mlp, x, cfg)
    elif cfg.family == "ssm":
        for l, lp in enumerate(params["ssm"]):
            x, sl = _ssm_block(lp, x, cfg, cache=_ssm_slice(cache, l),
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
                        bp, x, positions, cfg,
                        cache=(cache.attn_k[pi], cache.attn_v[pi]),
                        cache_len=L)
                else:
                    row = _ssm_layer(cfg, i, pi)
                    x, sl = _ssm_block(bp, x, cfg,
                                       cache=_ssm_slice(cache, row),
                                       mode="decode")
                    _put_ssm(cache, row, sl)
                if mlp == "moe":
                    x, _ = _moe_block(mp, x, cfg, no_drop=True)
                else:
                    x = _mlp_block(mp, x, cfg)
    else:
        raise ValueError(cfg.family)
    return _logits_out(cfg, params, x), cache._replace(length=L + 1)

"""Mamba2 / SSD (state-space duality) block in torch ops (counterpart of
``repro/models/ssm.py``).

The chunked SSD algorithm: the sequence is split into chunks of Q
tokens; within a chunk the quadratic "attention-like" form runs as
einsums, and a loop over chunks carries the (H, P, N) state — the exact
recurrence

    h_t = exp(dt_t·a_h) · h_{t-1} + dt_t · B_t ⊗ x_t
    y_t = C_t · h_t + D_h · x_t

Single group (B, C shared across heads), a scalar A per head, a causal
depthwise conv (k = 4) over x and (B, C).  z, x, (B, C) and dt keep the
reference's separate input matrices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (
    NO_RULES,
    is_dtensor,
    local_grad_placements,
    pad_dim,
    splittable,
)
from repro_torch.models.layers import ACC, dense, he_init, rms_norm


class SsmCacheSlice(NamedTuple):
    """Decode-time state of one ssm layer (or of a stack of them, with a
    leading layer dimension)."""

    h: torch.Tensor  # (B, H, P, N) running SSD state, float32
    conv_x: torch.Tensor  # (B, k-1, d_inner) trailing pre-conv x window
    conv_bc: torch.Tensor  # (B, k-1, 2N) trailing pre-conv (B, C) window


def _causal_conv(seq, conv_w, conv_b):
    """Depthwise causal conv1d.  seq: (B, S, C); conv_w: (k, C)."""
    k = conv_w.shape[0]
    B, S, C = seq.shape
    xp = pad_dim(seq, 1, k - 1, 0)
    out = torch.zeros((B, S, C), dtype=ACC, device=seq.device)
    for t in range(k):
        out = out + xp[:, t:t + S].to(ACC) * conv_w[t].to(ACC)
    return F.silu(out + conv_b.to(ACC)).to(seq.dtype)


def _conv_step(window, new, conv_w, conv_b):
    """One-token causal conv.  window: (B, k-1, C) past inputs; new:
    (B, C).  Returns (activated (B, C), the new window)."""
    full = torch.cat([window.to(new.dtype), new[:, None, :]], dim=1)
    out = torch.einsum("bkc,kc->bc", full.to(ACC), conv_w.to(ACC))
    return F.silu(out + conv_b.to(ACC)).to(new.dtype), full[:, 1:]


def ssd_scan(x, dt, a, Bm, Cm, chunk: int):
    """``_ssd_scan``; on DTensors (a mesh, the dry-run) per device under
    ``local_map``, on its own batch rows and heads (the state is
    independent a head; B and C are shared by all of them, so their
    gradients are a sum over the head split: ``local_grad_placements``)."""
    if not is_dtensor(x):
        return _ssd_scan(x, dt, a, Bm, Cm, chunk)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    lay = {"x": [], "dt": [], "a": [], "bc": [], "h": []}
    for p in x.placements:
        batch = isinstance(p, Shard) and p.dim == 0
        heads = isinstance(p, Shard) and p.dim == 2
        r = Replicate()
        lay["x"].append(Shard(0) if batch else Shard(2) if heads else r)
        lay["dt"].append(Shard(0) if batch else Shard(2) if heads else r)
        lay["a"].append(Shard(0) if heads else r)
        lay["bc"].append(Shard(0) if batch else r)
        lay["h"].append(Shard(0) if batch else Shard(1) if heads else r)
    lay = {k: tuple(v) for k, v in lay.items()}
    ins = (lay["x"], lay["dt"], lay["a"], lay["bc"], lay["bc"])
    return local_map(
        lambda *t: _ssd_scan(*t, chunk), (lay["x"], lay["h"]),
        in_placements=ins, in_grad_placements=local_grad_placements(ins),
        device_mesh=x.device_mesh, redistribute_inputs=True)(
            x, dt, a, Bm, Cm)


def _ssd_scan(x, dt, a, Bm, Cm, chunk: int):
    """Chunked SSD.  x: (B, S, H, P); dt: (B, S, H); a: (H,) (negative);
    Bm, Cm: (B, S, N).  Returns y (B, S, H, P) and the final state
    (B, H, P, N).  A ragged tail is padded with dt = 0 tokens: exp(0) = 1
    and a zero B·x leave the state as it is."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    h = torch.zeros((B, H, P, N), dtype=ACC, device=x.device)
    ys = []
    for c0 in range(0, S, Q):
        xc = x[:, c0:c0 + Q].to(ACC)
        dtc = dt[:, c0:c0 + Q].to(ACC)
        Bc, Cc = Bm[:, c0:c0 + Q].to(ACC), Cm[:, c0:c0 + Q].to(ACC)
        cum = torch.cumsum(dtc * a, dim=1)  # (B, Q, H), within the chunk
        # the intra-chunk quadratic form
        CB = torch.einsum("bin,bjn->bij", Cc, Bc)
        Lmat = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])
        scores = CB[..., None] * torch.where(tri[None, :, :, None], Lmat,
                                             0.0)
        scores = scores * dtc[:, None, :, :]  # weight by dt_j
        y_intra = torch.einsum("bijh,bjhp->bihp", scores, xc)
        # the incoming state's contribution
        y_inter = torch.einsum("bin,bhpn->bihp", Cc, h) * torch.exp(
            cum)[..., None]
        # the new state
        wgt = torch.exp(cum[:, -1:, :] - cum) * dtc  # (B, Q, H)
        states = torch.einsum("bqh,bqn,bqhp->bhpn", wgt, Bc, xc)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + states
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.cat(ys, dim=1)[:, :S_orig]
    return y, h


def _project(p, u, rules=NO_RULES):
    """u: (B, S, D) → z, the conv inputs x and (B, C), dt (before the
    activation); z, x and dt split by SSD heads on a mesh."""
    z = rules.act(dense(u, p["in_z"]), "act_ssm_inner")
    x = rules.act(dense(u, p["in_x"]), "act_ssm_inner")
    bc = dense(u, p["in_bc"])
    dt = rules.act(dense(u, p["in_dt"]), "act_ssm_dt")
    return z, x, bc, dt


def _finish(p, y, x, z, cfg, shape):
    """The shared tail: D skip, gated norm, out projection."""
    B, S = shape
    y = y + p["D_skip"].to(ACC)[None, None, :, None] * x
    y = y.reshape(B, S, cfg.d_inner).to(z.dtype)
    y = rms_norm(y * F.silu(z.to(ACC)).to(z.dtype), p["ssm_norm"],
                 cfg.norm_eps)
    return dense(y, p["out_proj"])


def _ssd_inputs(p, u, cfg, rules=NO_RULES):
    B, S, _ = u.shape
    N, H, P = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, x_in, bc_in, dt = _project(p, u, rules)
    x = _causal_conv(x_in, p["conv_wx"], p["conv_bx"])
    bc = _causal_conv(bc_in, p["conv_wbc"], p["conv_bbc"])
    dt_act = F.softplus(dt.to(ACC) + p["dt_bias"].to(ACC))
    a = -torch.exp(p["A_log"].to(ACC))
    xh = splittable(x, -1, H).reshape(B, S, H, P).to(ACC)
    return z, x_in, bc_in, xh, dt_act, a, bc[..., :N], bc[..., N:]


def mamba2_forward(p, u, cfg, rules=NO_RULES):
    """The full-sequence Mamba2 block.  u: (B, S, D) → (B, S, D)."""
    B, S, _ = u.shape
    z, _, _, xh, dt_act, a, Bm, Cm = _ssd_inputs(p, u, cfg, rules)
    y, _ = ssd_scan(xh, dt_act, a, Bm, Cm, cfg.ssm_chunk)
    return _finish(p, y, xh, z, cfg, (B, S))


def mamba2_prefill(p, u, cfg, rules=NO_RULES):
    """``mamba2_forward`` that also returns the layer's decode cache."""
    B, S, _ = u.shape
    k = cfg.conv_kernel
    z, x_in, bc_in, xh, dt_act, a, Bm, Cm = _ssd_inputs(p, u, cfg, rules)
    y, h_final = ssd_scan(xh, dt_act, a, Bm, Cm, cfg.ssm_chunk)
    out = _finish(p, y, xh, z, cfg, (B, S))

    def tail(seq):  # the trailing pre-activation window, left-padded
        need = k - 1
        if seq.shape[1] < need:
            seq = pad_dim(seq, 1, need - seq.shape[1], 0)
        return seq[:, seq.shape[1] - need:, :]

    return out, SsmCacheSlice(h=h_final, conv_x=tail(x_in),
                              conv_bc=tail(bc_in))


def mamba2_decode(p, u, cache: SsmCacheSlice, cfg, rules=NO_RULES):
    """One token.  u: (B, 1, D) → (B, 1, D) and the new cache slice."""
    N, H, P = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    B = u.shape[0]
    z, x_new, bc_new, dt = _project(p, u[:, 0, :])
    x, conv_x = _conv_step(cache.conv_x, x_new, p["conv_wx"], p["conv_bx"])
    bc, conv_bc = _conv_step(cache.conv_bc, bc_new, p["conv_wbc"],
                             p["conv_bbc"])
    Bm, Cm = bc[..., :N], bc[..., N:]
    dt_act = F.softplus(dt.to(ACC) + p["dt_bias"].to(ACC))  # (B, H)
    a = -torch.exp(p["A_log"].to(ACC))
    dA = torch.exp(dt_act * a)
    xh = splittable(x, -1, H).reshape(B, H, P).to(ACC)
    h = cache.h.to(ACC) * dA[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt_act, Bm.to(ACC), xh)
    y = torch.einsum("bn,bhpn->bhp", Cm.to(ACC), h)
    y = y + p["D_skip"].to(ACC)[None, :, None] * xh
    y = y.reshape(B, cfg.d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z.to(ACC)).to(u.dtype), p["ssm_norm"],
                 cfg.norm_eps)
    out = dense(y, p["out_proj"])[:, None, :]
    return out, SsmCacheSlice(h=h, conv_x=conv_x, conv_bc=conv_bc)


def init_ssm_params(generator, cfg, dtype):
    """One layer's Mamba2 parameters."""
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    D, k, dev = cfg.d_model, cfg.conv_kernel, generator.device

    def conv(shape):
        t = torch.randn(shape, generator=generator, dtype=ACC, device=dev)
        return t.mul_(0.1).to(dtype)

    return {
        "in_z": he_init(generator, (D, di), dtype),
        "in_x": he_init(generator, (D, di), dtype),
        "in_bc": he_init(generator, (D, 2 * N), dtype),
        "in_dt": he_init(generator, (D, H), dtype),
        "conv_wx": conv((k, di)),
        "conv_bx": torch.zeros((di,), dtype=dtype, device=dev),
        "conv_wbc": conv((k, 2 * N)),
        "conv_bbc": torch.zeros((2 * N,), dtype=dtype, device=dev),
        "A_log": torch.zeros((H,), dtype=ACC, device=dev),  # a = -1
        "D_skip": torch.ones((H,), dtype=ACC, device=dev),
        "dt_bias": torch.full((H,), -2.0, dtype=ACC, device=dev),
        "ssm_norm": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": he_init(generator, (di, D), dtype),
    }

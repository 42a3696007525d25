"""GQA attention in torch ops (counterpart of ``repro/models/attention.py``).

The query heads attend in groups of n_rep = Hq / Hkv over their shared
KV head without expanding the KV.  ``chunked_attention`` keeps the
reference's two forms: a single pass where Sq = 1 (decode) or the KV is
one chunk, and otherwise the online softmax over KV chunks of
``kv_chunk`` with a running (max, sum, acc), whose peak temporary is
O(B·H·Sq·chunk).  ``q_offset`` is q[0]'s absolute position and
``kv_len`` the valid prefix of a padded cache (both ints or 0-d
tensors).  Where the reference keeps the softmax probabilities in the
operands' dtype for the PV product, so does the port.

On DTensors (a mesh, the dry-run) the attention runs per device under
``local_map`` on its own batch rows and heads — q's and the KV's heads
split alike, which keeps each query head with its KV head — so DTensor
plans no redistribution inside it.  A KV split along its sequence (the
decode cache) takes DTensor's ops instead: each device scores its own
cache rows.
"""

from __future__ import annotations

import math

import torch

from repro_torch.dist.sharding import is_dtensor, splittable

ACC = torch.float32
NEG_INF = -1e30


def _mask(Sq, keys, q_offset, kv_len, causal, device):
    """(Sq, len(keys)) bool: key positions ``keys`` a query may see."""
    q_pos = q_offset + torch.arange(Sq, device=device)
    mask = torch.ones((Sq, keys.shape[0]), dtype=torch.bool, device=device)
    if causal:
        mask &= keys[None, :] <= q_pos[:, None]
    if kv_len is not None:
        mask &= (keys < kv_len)[None, :]
    return mask


def _local_layout(q, k, v):
    """The (batch, heads) split ``local_map`` runs attention under, or
    None where the KV is split along its sequence."""
    from torch.distributed.tensor import Replicate, Shard

    if any(isinstance(p, Shard) and p.dim == 1
           for t in (k, v) for p in t.placements):
        return None
    mesh, Hq, Hkv = q.device_mesh, q.shape[2], k.shape[2]
    out = []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if isinstance(p, Shard) and (p.dim == 0 or (
                p.dim == 2 and Hq % n == 0 and Hkv % n == 0)):
            out.append(Shard(p.dim))
        else:
            out.append(Replicate())
    return tuple(out)


def chunked_attention(q, k, v, *, causal: bool, q_offset=0, kv_len=None,
                      kv_chunk: int = 1024):
    """q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd) → (B, Sq, Hq, hd)."""
    if is_dtensor(q) and is_dtensor(k) and is_dtensor(v):
        layout = _local_layout(q, k, v)
        if layout is not None:
            from torch.distributed.tensor.experimental import local_map

            def attend(q, k, v):
                return (_attention(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len, kv_chunk=kv_chunk),)

            return local_map(attend, (layout,), in_placements=(layout,) * 3,
                             device_mesh=q.device_mesh,
                             redistribute_inputs=True)(q, k, v)[0]
    return _attention(q, k, v, causal=causal, q_offset=q_offset,
                      kv_len=kv_len, kv_chunk=kv_chunk)


def _attention(q, k, v, *, causal, q_offset, kv_len, kv_chunk):
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    n_rep = Hq // Hkv
    k, v = k.to(q.dtype), v.to(q.dtype)
    scale = 1.0 / math.sqrt(hd)
    kv_chunk = min(kv_chunk, Sk)
    if Sk % kv_chunk:  # pad the KV to a chunk multiple; mask via kv_len
        pad = kv_chunk - Sk % kv_chunk
        if kv_len is None:
            kv_len = Sk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        Sk = Sk + pad
    n_chunks = Sk // kv_chunk
    qg = splittable(q, 2, Hkv).reshape(B, Sq, Hkv, n_rep, hd)

    if Sq == 1 or n_chunks == 1:
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(ACC), k.to(ACC)) * scale
        mask = _mask(Sq, torch.arange(Sk, device=q.device), q_offset,
                     kv_len, causal, q.device)
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bgrqk,bkgd->bqgrd", p.to(q.dtype).to(ACC),
                           v.to(ACC))
        return out.reshape(B, Sq, Hq, hd).to(q.dtype)

    m = torch.full((B, Hkv, n_rep, Sq), NEG_INF, dtype=ACC, device=q.device)
    l_sum = torch.zeros((B, Hkv, n_rep, Sq), dtype=ACC, device=q.device)
    acc = torch.zeros((B, Sq, Hkv, n_rep, hd), dtype=ACC, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        kc, vc = k[:, sl].to(ACC), v[:, sl].to(ACC)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(ACC), kc) * scale
        mask = _mask(Sq, torch.arange(sl.start, sl.stop, device=q.device),
                     q_offset, kv_len, causal, q.device)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_sum = l_sum * corr + p.sum(dim=-1)
        pv = torch.einsum("bgrqk,bkgd->bqgrd", p.to(q.dtype).to(ACC), vc)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l_sum, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def full_attention(q, k, v, *, causal: bool, q_offset=0, kv_len=None):
    """The unchunked form (tests and the smoke configs)."""
    return chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len, kv_chunk=k.shape[1])

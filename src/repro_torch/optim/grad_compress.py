"""Gradient compression with error feedback (the counterpart of
``repro/optim/grad_compress.py``).

Two codecs:
  * ``topk`` — per-tensor magnitude top-k with an error-feedback
    residual (Stich et al., 2018): only a fraction k of each gradient is
    sent, the rest carried into the next step;
  * ``int8`` — per-tensor symmetric int8 quantisation with error
    feedback.

On one card nothing crosses a link: the codec is applied to the whole
gradient inside the train step, as the reference applies it inside its
jitted step, so that a multi-card deployment puts it on the reduction
boundary without changing the numbers.  On a live mesh the gradients
are DTensors and the codec's two reductions over a group — top-k's
threshold and int8's max — are taken over the whole mesh, exactly.  A
"tensor" is one of the reference's: the L per-layer leaves of a layer
group share one top-k threshold and one int8 scale, as its stacked
(L, …) leaf does (``tree.stacked_groups``, from the layout the
checkpoints are written in).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.dist.collectives import mesh_gather, mesh_max
from repro_torch.dist.sharding import is_dtensor, owned_local, zeros_placed
from repro_torch.tree import leaves, stacked_groups, tree_map, unflatten_like

F32 = torch.float32


class CompressState(NamedTuple):
    residual: Any  # the error-feedback carry, float32, the grads' tree


def compress_init(params, shardings=None) -> CompressState:
    """A zero residual beside ``params``: on a live mesh a DTensor a leaf
    under ``shardings`` (or each parameter's placements)."""
    sh = shardings if shardings is not None else tree_map(
        lambda _: None, params)
    return CompressState(tree_map(lambda p, s: zeros_placed(p, F32, s),
                                  params, sh))


def _topk(group, frac: float):
    """Keep the entries with |g| at least the k-th largest |g| over the
    group: ties at the threshold keep more than k, as the reference's
    do.  On a live mesh (DTensor leaves) each rank takes the k largest
    of the entries it holds (a replica counted once), those candidates
    are gathered, and the k-th largest of them is the threshold: the
    whole group's k-th largest, the one-process value exactly."""
    if is_dtensor(group[0]):
        k = max(1, int(sum(g.numel() for g in group) * frac))
        mine = torch.cat([torch.abs(owned_local(g).reshape(-1))
                          for g in group])
        top = torch.topk(mine, min(k, mine.shape[0]), sorted=True).values
        pad = torch.full((k,), -1.0, dtype=top.dtype, device=top.device)
        pad[:top.shape[0]] = top
        cand = mesh_gather(pad, group[0].device_mesh).reshape(-1)
        thresh = torch.topk(cand, k, sorted=True).values[-1]
        return [torch.where(torch.abs(g) >= thresh, g, torch.zeros_like(g))
                for g in group]
    mags = [torch.abs(g.reshape(-1)) for g in group]
    flat = mags[0] if len(mags) == 1 else torch.cat(mags)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat, k, sorted=True).values[-1]
    del flat
    return [torch.where(m.reshape(g.shape) >= thresh, g,
                        torch.zeros_like(g)) for g, m in zip(group, mags)]


def _int8(group):
    """Symmetric int8 over the group's one scale, round-half-to-even
    (``torch.round``, as ``jnp.round``), clipped to ±127.  On a live
    mesh the scale's max is each rank's over its shards, then a MAX over
    the mesh (exact)."""
    if is_dtensor(group[0]):
        local = [owned_local(g) for g in group]
        top = torch.stack([torch.max(torch.abs(t)) if t.numel() else
                           torch.zeros((), dtype=t.dtype, device=t.device)
                           for t in local]).max()
        top = mesh_max(top, group[0].device_mesh)
    else:
        top = torch.stack([torch.max(torch.abs(g)) for g in group]).max()
    scale = torch.clamp(top, min=1e-12) / 127.0
    return [torch.clamp(torch.round(g / scale), -127, 127).to(
        torch.int8).to(F32) * scale for g in group]


@torch.no_grad()
def compressed_grads(grads, state: CompressState, *, codec: str = "topk",
                     topk_frac: float = 0.05):
    """Apply ``codec`` with error feedback.  Returns (grads', state'); the
    residual's tensors are updated in place (``state`` is consumed)."""
    if codec not in ("topk", "int8"):
        raise ValueError(codec)
    g_leaves, r_leaves = leaves(grads), leaves(state.residual)
    sent_leaves = [None] * len(g_leaves)
    for idx in stacked_groups(grads):
        acc = [g_leaves[i].to(F32) + r_leaves[i] for i in idx]
        sent = _topk(acc, topk_frac) if codec == "topk" else _int8(acc)
        for i, a, s in zip(idx, acc, sent):
            r_leaves[i].copy_(a - s)
            sent_leaves[i] = s.to(g_leaves[i].dtype)
    return unflatten_like(grads, sent_leaves), state

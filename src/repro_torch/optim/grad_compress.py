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
boundary without changing the numbers.  A "tensor" is one of the
reference's: the L per-layer leaves of a layer group share one top-k
threshold and one int8 scale, as its stacked (L, …) leaf does
(``tree.stacked_groups``, from the layout the checkpoints are written
in).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, stacked_groups, tree_map, unflatten_like

F32 = torch.float32


class CompressState(NamedTuple):
    residual: Any  # the error-feedback carry, float32, the grads' tree


def compress_init(params) -> CompressState:
    return CompressState(tree_map(
        lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params))


def _topk(group, frac: float):
    """Keep the entries with |g| at least the k-th largest |g| over the
    group: ties at the threshold keep more than k, as the reference's
    do."""
    mags = [torch.abs(g.reshape(-1)) for g in group]
    flat = mags[0] if len(mags) == 1 else torch.cat(mags)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat, k, sorted=True).values[-1]
    del flat
    return [torch.where(m.reshape(g.shape) >= thresh, g,
                        torch.zeros_like(g)) for g, m in zip(group, mags)]


def _int8(group):
    """Symmetric int8 over the group's one scale, round-half-to-even
    (``torch.round``, as ``jnp.round``), clipped to ±127."""
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

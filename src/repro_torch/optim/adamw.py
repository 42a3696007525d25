"""AdamW on the port's parameter trees (the counterpart of
``repro/optim/adamw.py``).

The moments may be kept in another dtype than the parameters (``m_dtype``
bf16 and ``v_dtype`` float32 for the largest archs); the update is
computed in float32 and cast back to each leaf's dtype.  ``master=True``
keeps a float32 master copy of the parameters, which the update steps
from.

The update walks the tree leaf by leaf under ``torch.no_grad()`` and
writes each parameter, moment and master leaf in place: a temporary is
one leaf's size, never the model's, which is what lets the full-width
granite-moe-3b-a800m train on one card with both moments in float32.

On a live mesh every leaf is a DTensor: the gradients come with their
parameters' placements (the train step reduces them so), the moments
keep ZeRO-1's, and each in-place write lands in this rank's shard of
its own leaf (DTensor moves the update between the two placements);
``_global_norm`` reduces once over the mesh.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.dist.sharding import (
    is_dtensor,
    owned_local,
    replicate_like,
    zeros_placed,
)
from repro_torch.tree import leaves, tree_map

F32 = torch.float32


class AdamWState(NamedTuple):
    m: Any
    v: Any
    master: Optional[Any]
    count: torch.Tensor  # 0-d int32


def adamw_init(params, *, m_dtype=F32, v_dtype=F32,
               master: bool = False, shardings=None) -> AdamWState:
    """Zero moments beside ``params``, on their devices.  Where the
    parameters are DTensors on a live mesh, every leaf of the state is
    one too, built from this rank's shard alone: the moments and the
    master copy under ``shardings`` (a tree of ``NamedSharding`` like
    the parameters', ZeRO-1's ``dist.sharding.opt_shardings``) or else
    each parameter's placements, ``count`` replicated."""
    first = leaves(params)[0]
    sh = shardings if shardings is not None else tree_map(
        lambda _: None, params)

    def zeros(dt):
        return tree_map(lambda p, s: zeros_placed(p, dt, s), params, sh)

    def master_of(p, s):
        p = p.detach().to(F32, copy=True)
        return p if s is None else p.redistribute(p.device_mesh,
                                                  s.placements())

    mst = tree_map(master_of, params, sh) if master else None
    return AdamWState(zeros(m_dtype), zeros(v_dtype), mst, replicate_like(
        torch.zeros((), dtype=torch.int32), first))


@torch.no_grad()
def _global_norm(grads) -> torch.Tensor:
    """‖g‖ over every leaf, in float32: a 0-d tensor on the leaves'
    device.  On a live mesh (DTensor leaves, none a pending sum) each
    rank sums the squares of the entries it holds (a replica counted
    once), and one reduction over the mesh gives the sum: a replicated
    scalar, the same value on every rank."""
    gsq = mesh = None
    for g in leaves(grads):
        if is_dtensor(g):
            mesh = g.device_mesh
            g = owned_local(g)
        s = torch.sum(torch.square(g.to(F32)))
        gsq = s if gsq is None else gsq + s
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Partial, Replicate

        gsq = DTensor.from_local(gsq, mesh, [Partial()] * mesh.ndim,
                                 run_check=False).redistribute(
            mesh, [Replicate()] * mesh.ndim)
    return torch.sqrt(gsq)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """One AdamW step with global-norm clipping.  Returns (params, state,
    gnorm).

    ``params`` and ``state`` are consumed: their tensors are updated in
    place and returned in the same trees.  ``lr`` is a float or a 0-d
    tensor on the parameters' device."""
    count = state.count + 1
    gnorm = _global_norm(grads)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    cnt = count.to(F32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32, device=cnt.device),
                          cnt)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32, device=cnt.device),
                          cnt)
    masters = (leaves(state.master) if state.master is not None
               else [None] * len(leaves(params)))
    for p, g, m, v, mp in zip(leaves(params), leaves(grads),
                              leaves(state.m), leaves(state.v), masters):
        g = g.to(F32) * scale
        m_new = b1 * m.to(F32) + (1 - b1) * g
        v_new = b2 * v.to(F32) + (1 - b2) * torch.square(g)
        base = (mp if mp is not None else p).to(F32)
        step = m_new / bc1 / (torch.sqrt(v_new / bc2) + eps)
        base_new = base - lr * (step + weight_decay * base)
        del g, step
        m.copy_(m_new)
        v.copy_(v_new)
        del m_new, v_new
        if mp is not None:
            mp.copy_(base_new)
        p.copy_(base_new)
    return params, AdamWState(state.m, state.v, state.master, count), gnorm

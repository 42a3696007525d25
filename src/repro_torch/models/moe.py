"""Mixture-of-Experts MLP in torch ops (counterpart of
``repro/models/moe.py``): grouped capacity dispatch, two dispatch codecs.

Tokens are processed in groups of g; each group dispatches to E experts
with capacity C = min(int(max(1, g·k/E · capacity_factor)), g) a group
(C = g with ``no_drop``).  A (token, choice) pair keeps its slot when
its position in its expert — the choice-major running count over the
group's k·g pairs — is below C, else it is dropped (GShard semantics).
The router's top-k takes equal probabilities in index order, as
``jax.lax.top_k`` does (a stable descending sort).

``dispatch="scatter"`` scatters the kept pairs into their (expert, slot)
rows and gathers them back, one group at a time, the aux loss the mean
of the groups'; ``dispatch="einsum"`` is the GShard one-hot products
over all groups at once, the aux loss taken over all of them.
``remat_groups`` recomputes each scatter group, or the einsum's one
call, in the backward pass, as the reference's ``jax.checkpoint`` does.
The scatter's write into a fresh (E, C + 1, D) buffer differentiates
under autograd; on the card its backward accumulates with atomics, so
gradients there agree closely from run to run but not to the bit.

On a mesh (``x`` a ``DTensor``, the dry-run) the index writes and the
routing's sort have no DTensor rule, so the MLP takes its mesh form:
the groups stay one (G, g, D) tensor split over the data axes
(``act_moe_groups``), and the routing, the scatter and the gather run
per device on its own groups under ``local_map``.  The scatter codec's
experts run there too, per group, on the device's own experts (expert
dim split over ``model``, ``act_moe_xe4``); the einsum codec's products
stay DTensor einsums.  The mesh form computes the plain form's function
— the same per-group ops in the same order, so on a 1 × 1 mesh the same
bits for the scatter codec — but its remat recomputes the whole MLP,
not each group.  The reference scans its scatter groups and anchors
each group's (E, C, D) with ``act_moe_xe``; the stacked form anchors
(G, E, C, D) with ``act_moe_xe4``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (
    NO_RULES,
    is_dtensor,
    local_grad_placements,
    splittable,
)
from repro_torch.models.layers import ACC, dense, remat_call


def auto_group_size(d_ff: int, T: int, requested: int = 2048) -> int:
    """Cap the group so the einsum dispatch stays within about a quarter
    of the experts' FLOPs (g ≤ 0.75·d_ff), within [256, requested]."""
    cap = max(256, min(requested, int(0.75 * d_ff) // 128 * 128 or 256))
    g = min(cap, T)
    while T % g:
        g //= 2
    return max(g, 1)


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last dimension, ties in
    index order."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _one_hot(ids, n: int):
    """``jax.nn.one_hot``: float32 rows, all zero for an id outside
    [0, n) (a dropped pair's slot ≥ C)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(ACC)


def _positions(expert_ids, E: int):
    """Each (token, choice) pair's one-hot expert (…, g, k, E) and its
    position in that expert: the running count over the pairs in
    choice-major order (all first choices, then all second, …)."""
    onehot = _one_hot(expert_ids, E)  # (..., g, k, E)
    flat = onehot.transpose(-3, -2).flatten(-3, -2)  # (..., k·g, E)
    pos = torch.cumsum(flat, dim=-2) - flat
    pos = pos.unflatten(-2, (expert_ids.shape[-1], -1)).transpose(-3, -2)
    return onehot, torch.sum(pos * onehot, dim=-1)  # (..., g, k)


def _route(xg_i, router_w, top_k: int, C: int, E: int):
    """One group's routing: (gate values (g, k), expert ids (g, k),
    positions in the experts (g, k), keep (g, k), probabilities (g, E),
    one-hot experts (g, k, E))."""
    logits = dense(xg_i, router_w).to(ACC)  # (g, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    onehot, pos_in_expert = _positions(expert_ids, E)
    keep = pos_in_expert < C
    gate_vals = gate_vals * keep
    return (gate_vals, expert_ids, pos_in_expert.to(torch.int64), keep,
            probs, onehot)


def _experts(xe, w_gate, w_up, w_down, out_dtype):
    """xe: (…, E, C, D) → (…, E, C, D) through each expert's SwiGLU."""
    h = F.silu(torch.einsum("...ecd,edf->...ecf", xe.to(ACC),
                            w_gate.to(ACC))) * torch.einsum(
        "...ecd,edf->...ecf", xe.to(ACC), w_up.to(ACC))
    return torch.einsum("...ecf,efd->...ecd", h.to(out_dtype).to(ACC),
                        w_down.to(ACC))


def _aux(onehot, keep, probs, E: int, dims):
    """The Switch load-balance loss: E·Σ_e f_e·P_e, f_e the kept share
    routed to e and P_e the mean probability, over ``dims``."""
    f_e = torch.mean(torch.sum(onehot * keep[..., None], dim=-2), dim=dims)
    return E * torch.sum(f_e * torch.mean(probs, dim=dims))


def _scatter_in(xg_i, router_w, top_k, C, E):
    """One group's routing and scatter: (xe (E, C + 1, D), the pairs'
    experts and slots (g·k,), gate values (g, k), the group's aux)."""
    D = xg_i.shape[1]
    gate_vals, expert_ids, pos, keep, probs, onehot = _route(
        xg_i, router_w, top_k, C, E)
    # the (token, choice) pairs flattened; dropped pairs park in slot C
    flat_e = expert_ids.reshape(-1)
    flat_c = torch.where(keep, pos, C).reshape(-1)
    xe = torch.zeros((E, C + 1, D), dtype=xg_i.dtype, device=xg_i.device)
    xe[flat_e, flat_c] = xg_i.repeat_interleave(top_k, dim=0)
    return xe, flat_e, flat_c, gate_vals, _aux(onehot, keep, probs, E, 0)


def _scatter_out(ye, flat_e, flat_c, gate_vals, out_dtype):
    """One group's gather of its pairs' expert rows, gate-weighted."""
    g, top_k = gate_vals.shape
    E, _, D = ye.shape
    ye = torch.cat([ye, torch.zeros((E, 1, D), dtype=ye.dtype,
                                    device=ye.device)], dim=1)
    back = ye[flat_e, flat_c].reshape(g, top_k, D)
    out = torch.sum(back.to(ACC) * gate_vals[..., None], dim=1)
    return out.to(out_dtype)


def _group_scatter(xg_i, router_w, w_gate, w_up, w_down, top_k, C, E,
                   rules=NO_RULES):
    xe, flat_e, flat_c, gate_vals, aux = _scatter_in(xg_i, router_w, top_k,
                                                     C, E)
    xe = rules.act(xe, "act_moe_xe")
    ye = _experts(xe[:, :C], w_gate, w_up, w_down, xg_i.dtype)  # float32
    ye = rules.act(ye, "act_moe_xe")
    return _scatter_out(ye, flat_e, flat_c, gate_vals, xg_i.dtype), aux


def _einsum_route(xg, router_w, top_k, C, E):
    """Every group's routing at once, (G, g, D): the combine weights
    (G, g, E, C), each token's kept experts (G, g, E) and its router
    probabilities (G, g, E)."""
    logits = torch.einsum("Ggd,de->Gge", xg.to(ACC), router_w.to(ACC))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, top_k)  # (G, g, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    onehot, pos = _positions(expert_ids, E)  # (G, g, k, E), (G, g, k)
    keep = pos < C
    gate_vals = gate_vals * keep
    slot_onehot = _one_hot(pos.to(torch.int64), C)  # (G, g, k, C)
    combine = torch.einsum("Ggke,Ggkc,Ggk->Ggec", onehot, slot_onehot,
                           gate_vals)  # (G, g, E, C)
    return combine, torch.sum(onehot * keep[..., None], dim=-2), probs


def _einsum_experts(xg, combine, w_gate, w_up, w_down, rules):
    dispatch_t = (combine > 0).to(xg.dtype)
    xe = torch.einsum("Ggec,Ggd->Gecd", dispatch_t.to(ACC),
                      xg.to(ACC)).to(xg.dtype)
    xe = rules.act(xe, "act_moe_xe4")  # (G, E, C, D): G DP, E model
    ye = _experts(xe, w_gate, w_up, w_down, xg.dtype).to(xg.dtype)
    ye = rules.act(ye, "act_moe_xe4")
    return torch.einsum("Ggec,Gecd->Ggd", combine, ye.to(ACC)).to(xg.dtype)


def _groups_einsum(xg, router_w, w_gate, w_up, w_down, top_k, C, E,
                   rules=NO_RULES):
    """Every group at once, (G, g, D), by one-hot products."""
    xg = rules.act(xg, "act_moe_groups")  # (G, g, D): G over DP
    if is_dtensor(xg):
        grp = _groups_layout(xg)
        combine, kept, probs = _local(
            lambda x, r: _einsum_route(x, r, top_k, C, E),
            ((xg, grp), (router_w, _replicated(xg))), (grp,) * 3)
    else:
        combine, kept, probs = _einsum_route(xg, router_w, top_k, C, E)
    out = _einsum_experts(xg, combine, w_gate, w_up, w_down, rules)
    aux = E * torch.sum(torch.mean(kept, dim=(0, 1))
                        * torch.mean(probs, dim=(0, 1)))
    return out, aux


def _replicated(t) -> tuple:
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * t.device_mesh.ndim


def _groups_layout(t) -> tuple:
    """``t``'s split of its leading group dim G, every other mesh dim
    replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in t.placements)


def _local(fn, args, out_placements):
    """``fn`` on each device's own shards (``local_map``): ``args`` are
    (DTensor, placements) pairs, redistributed to those placements;
    ``out_placements`` one placements tuple an output of ``fn`` (which
    returns a tuple).  A replicated input's gradient is the sum of the
    devices' own parts (``local_grad_placements``)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = args[0][0].device_mesh
    ins = tuple(p for _, p in args)
    out = local_map(fn, tuple(out_placements), in_placements=ins,
                    in_grad_placements=local_grad_placements(ins),
                    device_mesh=mesh, redistribute_inputs=True)(
        *(a for a, _ in args))
    return out[0] if len(out_placements) == 1 else out


def _groups_scatter_mesh(xg, router_w, w_gate, w_up, w_down, top_k, C, E,
                         rules):
    """The scatter codec on a mesh: each device routes, scatters, runs
    its experts on and gathers its own groups, group by group."""
    from torch.distributed.tensor import Replicate, Shard

    xg = rules.act(xg, "act_moe_groups")  # (G, g, D): G over DP
    dtype = xg.dtype
    grp = _groups_layout(xg)

    def scatter_in(xg_l, router_l):
        parts = [_scatter_in(x, router_l, top_k, C, E) for x in xg_l]
        return tuple(torch.stack(t) for t in zip(*parts))

    xe, flat_e, flat_c, gate_vals, aux = _local(
        scatter_in, ((xg, grp), (router_w, _replicated(xg))), (grp,) * 5)
    xe = rules.act(xe, "act_moe_xe4")  # (G, E, C + 1, D): E over model
    # each device's own experts: the groups as split, E as act split it
    ep = tuple(p if isinstance(p, Shard) and p.dim == 1 else q
               for p, q in zip(xe.placements, grp))
    w_ep = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 1
                 else Replicate() for p in ep)

    def experts(xe_l, wg, wu, wd):
        return (torch.stack([_experts(x[:, :C], wg, wu, wd, dtype)
                             for x in xe_l]),)

    ye = _local(experts, ((xe, ep), (w_gate, w_ep), (w_up, w_ep),
                          (w_down, w_ep)), (ep,))
    ye = rules.act(ye, "act_moe_xe4")

    def scatter_out(ye_l, fe, fc, gv):
        return (torch.stack([_scatter_out(*t, dtype)
                             for t in zip(ye_l, fe, fc, gv)]),)

    out = _local(scatter_out, ((ye, grp), (flat_e, grp), (flat_c, grp),
                               (gate_vals, grp)), (grp,))
    return out, aux.mean()


def moe_mlp(x, router_w, w_gate, w_up, w_down, *, top_k: int,
            capacity_factor: float = 1.25, group_size: int = 2048,
            no_drop: bool = False, dispatch: str = "scatter",
            remat_groups: bool = True, rules=NO_RULES):
    """x: (T, D) tokens.  router_w: (D, E).  w_gate, w_up: (E, D, F);
    w_down: (E, F, D).  Returns (out (T, D), the aux loss).  A DTensor
    ``x`` takes the mesh form (the module's docstring)."""
    T, D = x.shape
    E = router_w.shape[1]
    Fd = w_gate.shape[-1]
    if dispatch not in ("scatter", "einsum"):
        raise ValueError(f"dispatch must be 'scatter' or 'einsum', got "
                         f"{dispatch!r}")
    g = (auto_group_size(Fd, T, group_size) if dispatch == "einsum"
         else min(group_size, T))
    while T % g:
        g //= 2
    G = T // g
    C = g if no_drop else min(int(max(1, (g * top_k / E) * capacity_factor)),
                              g)
    xg = splittable(x, 0, G).reshape(G, g, D)
    if dispatch == "einsum":
        out, aux = remat_call(_groups_einsum, xg, router_w, w_gate, w_up,
                              w_down, top_k, C, E, rules,
                              remat=remat_groups)
        return out.reshape(T, D), aux
    if is_dtensor(xg):
        out, aux = remat_call(_groups_scatter_mesh, xg, router_w, w_gate,
                              w_up, w_down, top_k, C, E, rules,
                              remat=remat_groups)
        return out.reshape(T, D), aux
    outs, auxs = zip(*(remat_call(_group_scatter, xg[i], router_w, w_gate,
                                  w_up, w_down, top_k, C, E, rules,
                                  remat=remat_groups) for i in range(G)))
    return torch.cat(outs).reshape(T, D), torch.stack(auxs).mean()

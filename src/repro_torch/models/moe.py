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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def _group_scatter(xg_i, router_w, w_gate, w_up, w_down, top_k, C, E):
    g, D = xg_i.shape
    gate_vals, expert_ids, pos, keep, probs, onehot = _route(
        xg_i, router_w, top_k, C, E)
    # the (token, choice) pairs flattened; dropped pairs park in slot C
    flat_e = expert_ids.reshape(-1)
    flat_c = torch.where(keep, pos, C).reshape(-1)
    xe = torch.zeros((E, C + 1, D), dtype=xg_i.dtype, device=xg_i.device)
    xe[flat_e, flat_c] = xg_i.repeat_interleave(top_k, dim=0)
    ye = _experts(xe[:, :C], w_gate, w_up, w_down, xg_i.dtype)  # float32
    ye = torch.cat([ye, torch.zeros((E, 1, D), dtype=ye.dtype,
                                    device=ye.device)], dim=1)
    back = ye[flat_e, flat_c].reshape(g, top_k, D)
    out = torch.sum(back.to(ACC) * gate_vals[..., None], dim=1)
    return out.to(xg_i.dtype), _aux(onehot, keep, probs, E, 0)


def _groups_einsum(xg, router_w, w_gate, w_up, w_down, top_k, C, E):
    """Every group at once, (G, g, D), by one-hot products."""
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
    dispatch_t = (combine > 0).to(xg.dtype)
    xe = torch.einsum("Ggec,Ggd->Gecd", dispatch_t.to(ACC),
                      xg.to(ACC)).to(xg.dtype)
    ye = _experts(xe, w_gate, w_up, w_down, xg.dtype).to(xg.dtype)
    out = torch.einsum("Ggec,Gecd->Ggd", combine, ye.to(ACC)).to(xg.dtype)
    return out, _aux(onehot, keep, probs, E, (0, 1))


def moe_mlp(x, router_w, w_gate, w_up, w_down, *, top_k: int,
            capacity_factor: float = 1.25, group_size: int = 2048,
            no_drop: bool = False, dispatch: str = "scatter",
            remat_groups: bool = True):
    """x: (T, D) tokens.  router_w: (D, E).  w_gate, w_up: (E, D, F);
    w_down: (E, F, D).  Returns (out (T, D), the aux loss)."""
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
    xg = x.reshape(G, g, D)
    if dispatch == "einsum":
        out, aux = remat_call(_groups_einsum, xg, router_w, w_gate, w_up,
                              w_down, top_k, C, E, remat=remat_groups)
        return out.reshape(T, D), aux
    outs, auxs = zip(*(remat_call(_group_scatter, xg[i], router_w, w_gate,
                                  w_up, w_down, top_k, C, E,
                                  remat=remat_groups) for i in range(G)))
    return torch.cat(outs).reshape(T, D), torch.stack(auxs).mean()

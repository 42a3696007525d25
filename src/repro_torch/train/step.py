"""The LM train step: loss, gradients, microbatch accumulation,
compression, AdamW (the counterpart of ``repro/train/step.py``).

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``.
The reference jits it with the state donated; here the step updates the
state's tensors in place, so the state passed in is consumed: the state
returned holds the same tensors, updated, with a new ``step``.
Gradients come from ``torch.autograd.grad`` of the loss with respect to
detached aliases of the parameters, so the parameters never carry
``requires_grad`` between steps.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import forward_train, init_params
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.grad_compress import (
    CompressState,
    compress_init,
    compressed_grads,
)
from repro_torch.tree import leaves, tree_map, unflatten_like

F32 = torch.float32


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: torch.Tensor  # 0-d int32
    compress: Optional[CompressState] = None


def init_train_state(cfg: ModelConfig, generator, *, dtype=F32,
                     m_dtype=F32, v_dtype=F32, master: bool = False,
                     compress: bool = False, device=None) -> TrainState:
    """Random parameters from ``generator`` (a ``torch.Generator`` or an
    int seed; ``models.init_params``) and a fresh optimizer on
    ``device`` (the card unless the caller asks for the CPU)."""
    params = init_params(cfg, generator, dtype, device=device)
    return train_state_for(params, m_dtype=m_dtype, v_dtype=v_dtype,
                           master=master, compress=compress)


def train_state_for(params, *, m_dtype=F32, v_dtype=F32,
                    master: bool = False,
                    compress: bool = False) -> TrainState:
    """Step 0's ``TrainState`` around given parameters."""
    opt = adamw_init(params, m_dtype=m_dtype, v_dtype=v_dtype,
                     master=master)
    return TrainState(params=params, opt=opt,
                      step=torch.zeros((), dtype=torch.int32,
                                       device=opt.count.device),
                      compress=compress_init(params) if compress else None)


def cross_entropy(logits, labels, vocab_size: int):
    """Mean next-token cross-entropy: logits (B, S, Vp) predict labels
    (B, S) one position on (t + 1 from t).  A target outside
    [0, vocab_size) — a padded vocabulary column — is masked out."""
    logits = logits[:, :-1].to(F32)
    targets = labels[:, 1:].to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    Vp = logits.shape[-1]
    in_range = (targets >= 0) & (targets < Vp)
    picked = torch.gather(logits, -1, torch.where(
        in_range, targets, 0)[..., None])[..., 0]
    mask = ((targets >= 0) & (targets < vocab_size)).to(F32)
    losses = (lse - picked) * mask
    return torch.sum(losses) / torch.clamp(torch.sum(mask), min=1)


def _split_batch(batch, microbatches: int):
    """The batch as ``microbatches`` consecutive slices of its rows:
    dim 0, but dim 1 of (3, B, S) M-RoPE positions."""
    out = [dict() for _ in range(microbatches)]
    for k, v in batch.items():
        v = torch.as_tensor(v)
        mrope = k == "positions" and v.dim() == 3 and v.shape[0] == 3
        parts = torch.chunk(v, microbatches, dim=1 if mrope else 0)
        if len(parts) != microbatches or any(
                p.shape != parts[0].shape for p in parts):
            raise ValueError(f"{k}: {tuple(v.shape)} does not split into "
                             f"{microbatches} microbatches")
        for mb, part in zip(out, parts):
            mb[k] = part
    return out


def make_train_step(cfg: ModelConfig, *, schedule, microbatches: int = 1,
                    remat: bool = True, aux_weight: float = 0.01,
                    compress_codec: str | None = None,
                    weight_decay: float = 0.1, grad_clip: float = 1.0):
    """Build ``step(state, batch) -> (state, metrics)``.

    The loss is ``cross_entropy + aux_weight · aux`` (the MoE balance
    loss); ``microbatches`` > 1 accumulates float32 gradients over that
    many slices of the batch and divides by their count; ``remat``
    recomputes each work unit's activations in the backward pass
    (``forward_train``); ``compress_codec`` ("topk" or "int8") applies
    error-feedback compression before AdamW.  ``metrics`` holds 0-d
    tensors on the parameters' device: ``loss`` (the cross-entropy),
    ``aux``, ``lr`` and ``grad_norm``.  The reference's ``rules`` and
    ``acc_shardings`` place activations and the accumulator on a device
    mesh; on one card there is nothing to place, so they are not taken.
    The state passed in is consumed (its tensors are updated in place).
    """

    def grads_of(params, mb):
        aliases = tree_map(lambda p: p.detach().requires_grad_(), params)
        flat = leaves(aliases)
        logits, aux = forward_train(cfg, aliases, mb, remat=remat)
        ce = cross_entropy(logits, mb["labels"], cfg.vocab_size)
        grads = torch.autograd.grad(ce + aux_weight * aux, flat,
                                    allow_unused=True,
                                    materialize_grads=True)
        return list(grads), ce.detach(), aux.detach()

    def step(state: TrainState, batch):
        if microbatches == 1:
            grads, ce, aux = grads_of(state.params, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=F32, device=p.device)
                     for p in leaves(state.params)]
            ce = aux = None
            for mb in _split_batch(batch, microbatches):
                g, c, a = grads_of(state.params, mb)
                with torch.no_grad():
                    for acc, gi in zip(grads, g):
                        acc.add_(gi.to(F32))
                del g
                ce = c if ce is None else ce + c
                aux = a if aux is None else aux + a
            with torch.no_grad():
                for acc in grads:
                    acc.div_(microbatches)
            ce, aux = ce / microbatches, aux / microbatches
        grads = unflatten_like(state.params, grads)

        compress = state.compress
        if compress_codec is not None and compress is not None:
            grads, compress = compressed_grads(grads, compress,
                                               codec=compress_codec)

        lr = schedule(state.step)
        params, opt, gnorm = adamw_update(
            state.params, grads, state.opt, lr=lr,
            weight_decay=weight_decay, grad_clip=grad_clip)
        del grads
        new_state = TrainState(params, opt, state.step + 1, compress)
        return new_state, {"loss": ce, "aux": aux, "lr": lr,
                           "grad_norm": gnorm}

    return step

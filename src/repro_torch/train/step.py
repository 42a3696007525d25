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
from repro_torch.dist.sharding import (
    NO_RULES,
    is_dtensor,
    on_mesh,
    opt_shardings,
    param_shardings,
    replicated,
    replicated_value,
    zeros_placed,
)
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
                     compress: bool = False, device=None, shardings=None,
                     opt_shardings=None) -> TrainState:
    """Random parameters from ``generator`` (a ``torch.Generator`` or an
    int seed; ``models.init_params``) and a fresh optimizer on
    ``device`` (the card unless the caller asks for the CPU).  With
    ``shardings`` (``dist.sharding.param_shardings``) the state is built
    placed on their live mesh, each parameter as it is drawn and the
    optimizer's leaves under ``opt_shardings`` (ZeRO-1's; by default
    the parameters'): the one-process state's values, no rank holding
    more than its shards and one layer's full leaves."""
    params = init_params(cfg, generator, dtype, device=device,
                         shardings=shardings)
    return train_state_for(params, m_dtype=m_dtype, v_dtype=v_dtype,
                           master=master, compress=compress,
                           opt_shardings=opt_shardings)


def train_state_specs(cfg: ModelConfig, *, dtype=torch.bfloat16,
                      m_dtype=F32, v_dtype=F32, master: bool = False,
                      compress: bool = False) -> TrainState:
    """The ``TrainState`` as meta tensors — shapes and dtypes, no
    allocation (the dry-run's stand-ins)."""
    return init_train_state(cfg, 0, dtype=dtype, m_dtype=m_dtype,
                            v_dtype=v_dtype, master=master,
                            compress=compress, device="meta")


def train_state_for(params, *, m_dtype=F32, v_dtype=F32,
                    master: bool = False, compress: bool = False,
                    opt_shardings=None) -> TrainState:
    """Step 0's ``TrainState`` around given parameters; DTensor
    parameters give a state of DTensors (``optim.adamw_init``), the
    moments, master copy and residual under ``opt_shardings`` where
    given."""
    opt = adamw_init(params, m_dtype=m_dtype, v_dtype=v_dtype,
                     master=master, shardings=opt_shardings)
    return TrainState(params=params, opt=opt,
                      step=torch.zeros_like(opt.count),
                      compress=(compress_init(params, opt_shardings)
                                if compress else None))


def train_state_shardings(cfg: ModelConfig, mesh, state, *,
                          fsdp: bool = True, zero1: bool = True):
    """A ``TrainState`` of ``NamedSharding`` for ``state`` (a state, its
    meta stand-ins or a template) on ``mesh``: the parameters by
    ``param_shardings``, the moments, master copy and compression
    residual by ZeRO-1's ``opt_shardings`` (the parameters' with
    ``zero1=False``), ``count`` and ``step`` replicated — the tree
    ``restore_checkpoint``, ``run_training`` and
    ``convert.train_state_from_numpy`` take as ``shardings``."""
    p_sh = param_shardings(cfg, mesh, state.params, fsdp=fsdp)
    o_sh = opt_shardings(p_sh, mesh, state.params) if zero1 else p_sh
    rep = replicated(mesh)
    return TrainState(
        p_sh, AdamWState(o_sh, o_sh,
                         None if state.opt.master is None else o_sh, rep),
        rep, None if state.compress is None else CompressState(o_sh))


def cross_entropy(logits, labels, vocab_size: int):
    """Mean next-token cross-entropy: logits (B, S, Vp) predict labels
    (B, S) one position on (t + 1 from t).  A target outside
    [0, vocab_size) — a padded vocabulary column — is masked out."""
    if is_dtensor(logits) and any(getattr(p, "dim", None) == 2
                                   for p in logits.placements):
        return _cross_entropy_split(logits, labels, vocab_size)
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


def _cross_entropy_split(logits, labels, vocab_size: int):
    """``cross_entropy`` of DTensor logits whose vocabulary is split over
    ``model``, computed where it lies: the target picked by the
    reference's one-hot product against each device's own vocabulary
    ids; the log-sum-exp by partial maxima and sums; the shift by a
    target of -1 (masked) after the last position, so the logits are not
    sliced (DTensor gathers a sliced split tensor's vocabulary)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    logits = logits.to(F32)
    Vp = logits.shape[-1]
    targets = torch.cat([labels[:, 1:].to(torch.int64), torch.full_like(
        labels[:, :1], -1, dtype=torch.int64)], dim=1)
    vocab = [Shard(0) if isinstance(p, Shard) and p.dim == 2
             else Replicate() for p in logits.placements]
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = (m + torch.log(torch.sum(torch.exp(logits - m), dim=-1,
                                   keepdim=True)))[..., 0]
    ids = distribute_tensor(torch.arange(Vp, device=logits.device),
                            logits.device_mesh, vocab)
    picked = torch.sum(logits * (targets[..., None] == ids).to(F32), dim=-1)
    mask = ((targets >= 0) & (targets < vocab_size)).to(F32)
    losses = (lse - picked) * mask
    return torch.sum(losses) / torch.clamp(torch.sum(mask), min=1)


def _split_batch(batch, microbatches: int):
    """The batch as ``microbatches`` consecutive slices of its rows:
    dim 0, but dim 1 of (3, B, S) M-RoPE positions.  A DTensor's slices
    (gathered to be cut) go back to its layout, rows split as before."""
    out = [dict() for _ in range(microbatches)]
    for k, v in batch.items():
        v = torch.as_tensor(v)
        mrope = k == "positions" and v.dim() == 3 and v.shape[0] == 3
        parts = torch.chunk(v, microbatches, dim=1 if mrope else 0)
        if len(parts) != microbatches or any(
                p.shape != parts[0].shape for p in parts):
            raise ValueError(f"{k}: {tuple(v.shape)} does not split into "
                             f"{microbatches} microbatches")
        if is_dtensor(v):
            parts = [p.redistribute(v.device_mesh, v.placements)
                     for p in parts]
        for mb, part in zip(out, parts):
            mb[k] = part
    return out


def loss_and_grads(cfg: ModelConfig, params, batch, *, rules=NO_RULES,
                   remat: bool = True, aux_weight: float = 0.01):
    """The train step's gradients of ``cross_entropy + aux_weight ·
    aux`` with respect to ``params`` (a list in ``leaves`` order), from
    ``torch.autograd.grad`` on detached aliases, and the loss's two
    terms (detached).  On a mesh each gradient comes out with its
    parameter's placements: a pending sum over the data or model split
    is reduced, scattered where the parameter is split — the gradient
    reduction of data and tensor parallelism."""
    with on_mesh(rules):
        aliases = tree_map(lambda p: p.detach().requires_grad_(), params)
        flat = leaves(aliases)
        logits, aux = forward_train(cfg, aliases, batch, remat=remat,
                                    rules=rules)
        ce = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        grads = torch.autograd.grad(ce + aux_weight * aux, flat,
                                    allow_unused=True,
                                    materialize_grads=True)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if is_dtensor(g) and g.placements != p.placements else g
                 for g, p in zip(grads, flat)]
    return grads, ce.detach(), aux.detach()


def make_train_step(cfg: ModelConfig, *, schedule, rules=NO_RULES,
                    microbatches: int = 1, remat: bool = True,
                    aux_weight: float = 0.01,
                    compress_codec: str | None = None,
                    weight_decay: float = 0.1, grad_clip: float = 1.0,
                    acc_shardings=None):
    """Build ``step(state, batch) -> (state, metrics)``.

    The loss is ``cross_entropy + aux_weight · aux`` (the MoE balance
    loss); ``microbatches`` > 1 accumulates float32 gradients over that
    many slices of the batch and divides by their count; ``remat``
    recomputes each work unit's activations in the backward pass
    (``forward_train``); ``compress_codec`` ("topk" or "int8") applies
    error-feedback compression before AdamW.  ``metrics`` holds 0-d
    tensors on the parameters' device: ``loss`` (the cross-entropy),
    ``aux``, ``lr`` and ``grad_norm``.  ``rules`` places the
    activations on a mesh and ``acc_shardings`` (a tree of
    ``dist.sharding.NamedSharding`` like the parameters', the ZeRO-1
    moments' in the dry-run) the float32 microbatch accumulator, when
    the state holds DTensors; on one card's plain tensors they change
    nothing.  The state passed in is consumed (its tensors are updated
    in place).
    """

    def grads_of(params, mb):
        return loss_and_grads(cfg, params, mb, rules=rules, remat=remat,
                              aux_weight=aux_weight)

    def step(state: TrainState, batch):
        with on_mesh(rules):
            return _step(state, batch)

    def _step(state: TrainState, batch):
        if microbatches == 1:
            grads, ce, aux = grads_of(state.params, batch)
        else:
            acc_sh = (leaves(acc_shardings) if acc_shardings is not None
                      else [None] * len(leaves(state.params)))
            grads = [zeros_placed(p, F32, sh)
                     for p, sh in zip(leaves(state.params), acc_sh)]
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

        # the metrics replicated on a mesh: a rank's float() of a pending
        # sum would read its own part
        ce, aux = replicated_value(ce), replicated_value(aux)
        lr = schedule(state.step)
        params, opt, gnorm = adamw_update(
            state.params, grads, state.opt, lr=lr,
            weight_decay=weight_decay, grad_clip=grad_clip)
        del grads
        new_state = TrainState(params, opt, state.step + 1, compress)
        return new_state, {"loss": ce, "aux": aux, "lr": lr,
                           "grad_norm": gnorm}

    return step

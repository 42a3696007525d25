"""Carry the JAX reference's data and state into the port.

The tests build every input once with numpy (or ``repro.data.
make_dataset``), convert the arrays with these functions, and hand the
same values to both packages.  Each function copies onto ``device`` (the
card unless the caller asks for the CPU).  A multi-task solve's state is
a (K, …) stack: ``labels_from_numpy`` carries the (K, n) label matrix,
``state_from_numpy`` (K, n) α and (K, d) w as they are, and the 2-D
converters take and give a leading K.  The pod solver's pieces carry
across too: ``pod_sharded_from_numpy`` a ``PodShardedEll``, and
``key_from_numpy``/``fifo_from_numpy`` the segmented replay's key chain
and merge FIFO of ``cocoa_pod_solve``.  ``solver_state_from_numpy``
carries a whole ``SolverState`` of the segmented solver across, as the
reference's ``load_solver_state`` returns it, so a port solve resumes
mid-solve from a checkpoint the reference wrote; ``solver_state_to_
numpy`` is its inverse, the layout the port's checkpoints are written
in.
``snapshot_from_numpy`` carries a serving snapshot of the reference's
(``repro.serve.ModelSnapshot``) across, so both engines score the same
model.  ``params_from_numpy`` carries an LM's parameter pytree across
(its stacked (L, …) layer groups become the port's per-layer dicts) and
``cache_from_numpy`` a decode cache, so both packages run one model
from one cache; ``params_to_numpy`` and ``cache_to_numpy`` are their
inverses.  ``train_state_from_numpy`` carries the reference's LM
``TrainState`` across (parameters, both moments, the master copy, the
compression residual, the counts) and ``train_state_to_numpy`` gives the
port's in the reference's stacked layout, which the port's LM
checkpoints are written in.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sharded import device_put_state
from repro_torch.data.sparse import (
    EllMatrix,
    FeatureShardedEll,
    PodShardedEll,
)
from repro_torch.dist.mesh import resolve_device
from repro_torch.dist.sharding import host_full, place
from repro_torch.tree import map_layer_groups, tree_map


def ell_from_numpy(indices, values, d: int, *, device=None) -> EllMatrix:
    """An ``EllMatrix`` from (n, k) column ids (padding == d) and values
    (padding == 0)."""
    dev = resolve_device(device)
    idx = np.array(indices, dtype=np.int32)
    val = np.array(values, dtype=np.float32)
    if idx.shape != val.shape or idx.ndim != 2:
        raise ValueError(f"indices {idx.shape} and values {val.shape} must "
                         "be one (n, k) shape")
    return EllMatrix(torch.from_numpy(idx).to(dev),
                     torch.from_numpy(val).to(dev), int(d))


def dense_from_numpy(X, *, device=None) -> torch.Tensor:
    """A dense float32 (n, d) tensor."""
    dev = resolve_device(device)
    return torch.from_numpy(np.array(X, dtype=np.float32)).to(dev)


def state_from_numpy(alpha, w, *, device=None):
    """(α, w) float32 tensors for a warm start — (n,) and (d,), or a
    multi-task solve's (K, n) and (K, d) stacks."""
    dev = resolve_device(device)
    return (dense_from_numpy(alpha, device=dev),
            dense_from_numpy(w, device=dev))


def labels_from_numpy(Y, *, device=None) -> torch.Tensor:
    """The multi-task solve's (K, n) ±1 float32 label matrix (the
    reference's ``ovr_labels``)."""
    Y = dense_from_numpy(Y, device=device)
    if Y.dim() != 2:
        raise ValueError(f"labels must be a (K, n) matrix, got "
                         f"{tuple(Y.shape)}")
    return Y


def feature_sharded_from_numpy(indices, values, d: int, d_loc: int, *,
                               device=None) -> FeatureShardedEll:
    """A ``FeatureShardedEll`` from the reference's (n, m, k_loc)
    shard-local column ids (padding == d_loc) and values."""
    dev = resolve_device(device)
    idx = np.array(indices, dtype=np.int32)
    val = np.array(values, dtype=np.float32)
    if idx.shape != val.shape or idx.ndim != 3:
        raise ValueError(f"indices {idx.shape} and values {val.shape} must "
                         "be one (n, m, k_loc) shape")
    return FeatureShardedEll(torch.from_numpy(idx).to(dev),
                             torch.from_numpy(val).to(dev), int(d),
                             int(d_loc))


def w2d_from_numpy(w, m: int, d_loc: int, *, device=None) -> torch.Tensor:
    """The port's (m, d_loc + 1) primal slices from the reference's 2-D
    layout: m concatenated slices of d₁_loc ≥ d_loc + 1 words each (with
    the lane padding of its fused path), the dummy slot at d_loc.  A
    (K, m·d₁_loc) stack of a multi-task solve gives (K, m, d_loc + 1)."""
    dev = resolve_device(device)
    w = np.asarray(w, dtype=np.float32)
    flat = w.reshape(*w.shape[:-1], int(m), -1)
    if flat.shape[-1] < d_loc + 1:
        raise ValueError(f"a slice of {flat.shape[-1]} words cannot hold "
                         f"d_loc + 1 = {d_loc + 1}")
    return torch.from_numpy(np.ascontiguousarray(
        flat[..., :d_loc + 1])).to(dev)


def w2d_to_numpy(w, d1_loc: int) -> np.ndarray:
    """The reference's flat 2-D layout (m·d1_loc words, zero lane
    padding) from the port's (m, d_loc + 1) slices; (K, m·d1_loc) from a
    multi-task solve's (K, m, d_loc + 1)."""
    w = w.detach().cpu().numpy()
    *lead, m, d1 = w.shape
    if d1_loc < d1:
        raise ValueError(f"d1_loc={d1_loc} < the port's slice of {d1}")
    out = np.zeros((*lead, m, d1_loc), np.float32)
    out[..., :d1] = w
    return out.reshape(*lead, -1)


def pod_sharded_from_numpy(indices, values, row_mask, d: int, n: int, *,
                           device=None) -> PodShardedEll:
    """A ``PodShardedEll`` from the reference's (P, rows_per_pod, k)
    column ids and values and its (P, rows_per_pod) row mask."""
    dev = resolve_device(device)
    idx = np.array(indices, dtype=np.int32)
    val = np.array(values, dtype=np.float32)
    mask = np.array(row_mask, dtype=bool)
    if idx.shape != val.shape or idx.ndim != 3 or mask.shape != idx.shape[:2]:
        raise ValueError(f"indices {idx.shape}, values {val.shape} and "
                         f"row_mask {mask.shape} must be (P, rows, k) and "
                         "(P, rows)")
    return PodShardedEll(torch.from_numpy(idx).to(dev),
                         torch.from_numpy(val).to(dev),
                         torch.from_numpy(mask).to(dev), int(d), int(n))


def key_from_numpy(key, *, device=None) -> torch.Tensor:
    """A key of ``repro_torch.prng`` from a ``jax.random`` raw key (two
    uint32 words): a (2,) int64 tensor; a stack of keys (..., 2), such
    as a multi-task state's (K, 2), gives the same stack."""
    dev = resolve_device(device)
    k = np.asarray(key, dtype=np.uint32)
    if k.ndim < 1 or k.shape[-1] != 2:
        raise ValueError(f"a raw key is two uint32 words, got shape "
                         f"{k.shape}")
    return torch.from_numpy(k.astype(np.int64)).to(dev)


def fifo_from_numpy(fifo, *, device=None) -> tuple:
    """``cocoa_pod_solve``'s in-flight merges (a sequence of (d,) arrays)
    as a tuple of float32 tensors, oldest first."""
    return tuple(dense_from_numpy(g, device=device) for g in fifo)


# the state leaves of the primal's layout: w (K, *w), the delayed round's
# Δw, a shard's own last-round Δw (K, p, *w) and the pod FIFO
# (K, delay, *w); on disk each primal is its flat (w_len,) words
_PRIMAL_KEYS = ("w", "dw", "dwo", "pbuf")
_BOOL_KEYS = ("act", "rp")
_INT_KEYS = ("slot", "epoch", "nrun", "delay", "rpok", "health")


def solver_state_to_numpy(state: dict, setup) -> dict:
    """A ``SolverState`` of the port (every leaf with its leading task
    dimension K but ``epoch``) in the reference's layout, as numpy: a
    binary solve's (``setup.n_tasks`` 0) leaves lose the K = 1 axis, the
    key is two uint32 words, each primal is flat — the 2-D (m, d_loc + 1)
    slices concatenated, m·(d_loc + 1) words — with the pod FIFO's axis
    next to it.  ``dwo`` keeps the port's shard axis (K, p, w_len) at
    p > 1, where the reference's one-device view cannot hold every
    shard's, and drops it at p = 1, the reference's (K, w_len)."""
    out = {}
    for k, v in state.items():
        a = v.detach().cpu().numpy()
        if k == "key":
            a = a.astype(np.uint32)
        elif k in _PRIMAL_KEYS:
            lead = a.shape[:-len(setup.w_shape)]
            a = a.reshape(*lead, -1)
            if k == "dwo" and setup.p == 1:
                a = a[:, 0]
        if not setup.n_tasks and k != "epoch":
            a = a[0]
        out[k] = a
    return out


def solver_state_from_numpy(state: dict, setup) -> dict:
    """The port's ``SolverState`` for ``setup`` (a ``SolverSetup``) from
    the reference's layout, as ``load_solver_state`` returns it (either
    package's): the binary leaves gain the K = 1 axis, the raw key goes
    through ``key_from_numpy``, each flat primal becomes ``setup``'s
    layout (the 2-D slices through ``w2d_from_numpy``, which drops the
    reference's lane padding) with the pod FIFO on the port's axis 1, and
    a ``dwo`` without a shard axis (the reference's, one device's view)
    serves every shard.  The leaves are placed for ``setup``
    (``core.sharded.device_put_state``: on its device, the host-driven
    ``epoch`` and ``slot`` on the host).  Only the leaves given are
    converted: the caller checks the layout (α's rows, the primal's
    length) before it asks for more than the layout-free leaves."""
    K = max(int(setup.n_tasks), 1)
    out = {}
    for k, v in state.items():
        a = np.asarray(v)
        if not setup.n_tasks and k != "epoch":
            a = a[None]
        if k == "key":
            out[k] = key_from_numpy(a, device="cpu")
        elif k in _PRIMAL_KEYS:
            if k == "dwo" and a.ndim == 2:
                a = np.broadcast_to(a[:, None], (K, setup.p, a.shape[-1]))
            if setup.two_d:
                out[k] = w2d_from_numpy(a, setup.m, setup.d_loc,
                                        device="cpu")
            elif a.shape[-1] != setup.w_shape[0]:
                raise ValueError(f"a primal of {a.shape[-1]} words for a "
                                 f"layout of {setup.w_shape[0]}")
            else:
                out[k] = torch.from_numpy(np.array(a, np.float32))
        else:
            out[k] = torch.from_numpy(np.array(a)).to(
                torch.bool if k in _BOOL_KEYS else
                torch.int32 if k in _INT_KEYS else torch.float32)
    return device_put_state(setup, out)


def snapshot_from_numpy(snap, *, device=None):
    """The port's ``ModelSnapshot`` from a reference one (numpy ``w_pad``,
    already padded, and ``alpha``; the version, d and meta kept), on
    ``device``."""
    from repro_torch.serve.snapshot import ModelSnapshot

    dev = resolve_device(device)
    alpha = (None if snap.alpha is None
             else dense_from_numpy(snap.alpha, device=dev))
    return ModelSnapshot(dense_from_numpy(snap.w_pad, device=dev),
                         int(snap.version), int(snap.d), alpha,
                         None if snap.meta is None else dict(snap.meta))


def _layer_views(group: dict) -> list:
    """A stacked {name: (L, …)} group as L per-layer dicts of numpy
    views (each stacked leaf read to the host once)."""
    arrays = {k: np.asarray(v) for k, v in group.items()}
    n = len(next(iter(arrays.values())))
    return [{k: a[i] for k, a in arrays.items()} for i in range(n)]


def params_from_numpy(cfg, params, *, device=None, shardings=None) -> dict:
    """The reference's LM parameter pytree (numpy or jax arrays) in the
    port's layout (``repro_torch.models.transformer``): each stacked
    layer group a list of per-layer dicts, a hybrid model's ``periods``
    a list of slots {"block": [...], "mlp": [...]}, every other leaf a
    tensor.  ``cfg`` is the model's config: the embedding must have its
    padded vocabulary and width.  With ``shardings`` (a tree of
    ``NamedSharding`` in the port's layout, ``param_shardings``') each
    leaf is placed on their live mesh as it is converted
    (``dist.sharding.place``): no device holds a full copy of the tree."""
    from repro_torch.models.transformer import vocab_padded
    want = (vocab_padded(cfg), cfg.d_model)
    if tuple(np.shape(params["embed"])) != want:
        raise ValueError(f"the embedding is {tuple(np.shape(params['embed']))}"
                         f", {cfg.name} has {want}")
    return _unstack_params(params, None if shardings is not None
                           else resolve_device(device), shardings)


def _unstack_params(params, dev, shardings=None) -> dict:
    layout = map_layer_groups(params, _layer_views, np.asarray)
    if shardings is None:
        return tree_map(lambda a: torch.tensor(a, device=dev), layout)
    return tree_map(lambda a, sh: place(torch.tensor(a), sh), layout,
                    shardings)


def _host(t, dst=None) -> np.ndarray:
    """A tensor on the host as numpy; bf16, which numpy lacks, widened
    to float32 (exact).  A DTensor is gathered whole on the host (a
    collective every rank of its mesh enters, ``host_full``; with
    ``dst``, on rank ``dst`` alone, the others getting an empty
    array)."""
    t = host_full(t, dst)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_to_numpy(params, *, dst=None) -> dict:
    """The port's parameters as the reference's stacked numpy pytree (a
    bf16 leaf widened to float32).  On a live mesh every rank enters
    each leaf's gather; ``dst`` keeps the arrays on that rank alone."""
    def host(t):
        return _host(t, dst)

    def stack(layers):
        return {k: np.stack([host(lp[k]) for lp in layers])
                for k in layers[0]}

    return map_layer_groups(params, stack, host)


def map_train_state(state, tree, scalar, shardings=None):
    """A port ``TrainState`` with ``state``'s fields (either package's
    ``TrainState``, or ``train_state_to_numpy``'s): each params-shaped
    tree (parameters, both moments, the master copy, the compression
    residual) through ``tree``, ``count`` and ``step`` through
    ``scalar``; a ``None`` field stays ``None``.  With ``shardings`` (a
    ``TrainState`` of ``NamedSharding``, ``train.train_state_shardings``)
    each call also takes the field's shardings."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.grad_compress import CompressState
    from repro_torch.train.step import TrainState

    def t(x, field):
        return tree(x) if shardings is None else tree(x, field(shardings))

    def c(x, field):
        return scalar(x) if shardings is None else scalar(x, field(shardings))

    opt = state.opt
    return TrainState(
        params=t(state.params, lambda s: s.params),
        opt=AdamWState(t(opt.m, lambda s: s.opt.m),
                       t(opt.v, lambda s: s.opt.v),
                       None if opt.master is None else t(
                           opt.master, lambda s: s.opt.master),
                       c(opt.count, lambda s: s.opt.count)),
        step=c(state.step, lambda s: s.step),
        compress=(None if state.compress is None
                  else CompressState(t(state.compress.residual,
                                       lambda s: s.compress.residual))))


def train_state_to_numpy(state, *, dst=None):
    """The port's LM ``TrainState`` in the reference's layout, as numpy:
    each params-shaped tree stacked as ``params_to_numpy`` stacks it,
    ``count`` and ``step`` 0-d int32.  A bf16 leaf is widened to
    float32.  ``dst`` as in ``params_to_numpy``."""
    return map_train_state(state, lambda t: params_to_numpy(t, dst=dst),
                           lambda t: _host(t, dst))


def train_state_from_numpy(cfg, state, *, device=None, shardings=None):
    """The port's ``TrainState`` from the reference's (its ``TrainState``
    or ``train_state_to_numpy``'s, numpy or jax arrays) on ``device`` (the
    card unless the caller asks for the CPU): every params-shaped tree
    through ``params_from_numpy``, ``count`` and ``step`` 0-d int32
    tensors; the arrays keep their dtypes.  With ``shardings`` (a
    ``TrainState`` of ``NamedSharding``, ``train.train_state_shardings``)
    every leaf is placed on their live mesh as it is converted."""
    if shardings is not None:
        return map_train_state(
            state, lambda t, sh: params_from_numpy(cfg, t, shardings=sh),
            lambda a, sh: place(torch.tensor(np.asarray(a, np.int32)), sh),
            shardings)
    dev = resolve_device(device)
    return map_train_state(
        state, lambda t: params_from_numpy(cfg, t, device=dev),
        lambda a: torch.tensor(np.asarray(a, np.int32), device=dev))


def cache_from_numpy(cache, *, device=None):
    """A decode cache of the reference's (its ``Cache``, or any object with
    its fields, as numpy or jax arrays) as the port's ``Cache``."""
    from repro_torch.models.ssm import SsmCacheSlice
    from repro_torch.models.transformer import Cache
    dev = resolve_device(device)

    def t(a):
        return None if a is None else torch.tensor(np.asarray(a), device=dev)

    ssm = (None if cache.ssm is None
           else SsmCacheSlice(*(t(f) for f in cache.ssm)))
    return Cache(t(cache.attn_k), t(cache.attn_v), ssm, t(cache.cross_k),
                 t(cache.cross_v), int(np.asarray(cache.length)))


def cache_to_numpy(cache) -> dict:
    """The port's ``Cache`` as a dict of numpy arrays with the reference's
    field names (``ssm`` a dict of ``h``, ``conv_x``, ``conv_bc``)."""

    def a(t):
        return None if t is None else t.detach().cpu().numpy()

    out = {f: a(getattr(cache, f))
           for f in ("attn_k", "attn_v", "cross_k", "cross_v")}
    out["ssm"] = (None if cache.ssm is None
                  else {f: a(getattr(cache.ssm, f)) for f in cache.ssm._fields})
    out["length"] = np.int32(cache.length)
    return out

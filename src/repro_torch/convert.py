"""Carry the JAX reference's data and state into the port.

The tests build every input once with numpy (or ``repro.data.
make_dataset``), convert the arrays with these functions, and hand the
same values to both packages.  Each function copies onto ``device`` (the
card unless the caller asks for the CPU).  A multi-task solve's state is
a (K, …) stack: ``labels_from_numpy`` carries the (K, n) label matrix,
``state_from_numpy`` (K, n) α and (K, d) w as they are, and the 2-D
converters take and give a leading K.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.sparse import EllMatrix, FeatureShardedEll
from repro_torch.dist.mesh import resolve_device


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

"""Carry the JAX reference's data and state into the port.

The tests build every input once with numpy (or ``repro.data.
make_dataset``), convert the arrays with these functions, and hand the
same values to both packages.  Each function copies onto ``device`` (the
card unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.sparse import EllMatrix
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
    """(α, w) float32 tensors for a warm start."""
    dev = resolve_device(device)
    return (dense_from_numpy(alpha, device=dev),
            dense_from_numpy(w, device=dev))

"""One-vs-rest label containers for multi-task solves — the counterpart
of ``repro/data/labels.py``.

The multi-task solver (``sharded_passcode_solve(X, loss, y=Y)``) trains
K one-vs-rest binary problems that share one X.  Shared-X tasks cannot
pre-fold labels into the rows the way the binary path does
(x_i ← y_i·x_i), so labels travel as an explicit (K, n) ±1 matrix that
the engines fold on read:

  ``ovr_labels(y_int, n_classes)`` → (K, n) float32, row k the binary
  ±1 problem "class k vs rest";
  ``ovr_decode(Y)`` → (n,) int32 class ids, the exact inverse whenever
  each column marks exactly one class positive (argmax over rows);
  ``MultitaskLabels`` bundles the matrix with its class count.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.dist.mesh import resolve_device


class MultitaskLabels(NamedTuple):
    """A (K, n) ±1 one-vs-rest label matrix and its class count:
    ``y[k, i] = +1`` iff row i belongs to class k."""

    y: torch.Tensor  # (K, n) float32 ±1
    n_classes: int

    @property
    def n_rows(self) -> int:
        return int(self.y.shape[1])


def ovr_labels(y_int, n_classes: int | None = None, *,
               device=None) -> torch.Tensor:
    """Integer class ids → (K, n) one-vs-rest ±1 float32 matrix on
    ``device`` (the card unless the caller asks for the CPU).

    Row k is the binary problem "class k (+1) vs rest (−1)".  When
    ``n_classes`` is None it is ``max(y_int) + 1``.  Raises on ids
    outside [0, K): a silent clip would train a wrong class."""
    if torch.is_tensor(y_int):
        y_int = y_int.detach().cpu().numpy()
    y = np.asarray(y_int)
    if y.ndim != 1:
        raise ValueError(f"y_int must be 1-D class ids, got shape {y.shape}")
    if y.size == 0:
        raise ValueError("y_int is empty")
    if not np.issubdtype(y.dtype, np.integer):
        yf = np.asarray(y, np.float64)
        if not np.all(yf == np.round(yf)):
            raise ValueError("y_int must hold integer class ids")
        y = yf.astype(np.int64)
    k = int(y.max()) + 1 if n_classes is None else int(n_classes)
    if k < 1:
        raise ValueError(f"n_classes must be >= 1, got {k}")
    if y.min() < 0 or y.max() >= k:
        raise ValueError(
            f"class ids must lie in [0, {k}), got range "
            f"[{int(y.min())}, {int(y.max())}]")
    onehot = y[None, :] == np.arange(k)[:, None]  # (K, n) bool
    return torch.from_numpy(np.where(onehot, 1.0, -1.0).astype(
        np.float32)).to(resolve_device(device))


def ovr_decode(Y) -> torch.Tensor:
    """(K, n) one-vs-rest matrix → (n,) int32 class ids (argmax over K,
    the first on a tie), on Y's device."""
    Y = torch.as_tensor(Y)
    if Y.dim() != 2:
        raise ValueError(f"expected a (K, n) matrix, got shape "
                         f"{tuple(Y.shape)}")
    return torch.argmax(Y, dim=0).to(torch.int32)


def multitask_labels(y_int, n_classes: int | None = None, *,
                     device=None) -> MultitaskLabels:
    """Ids → ``MultitaskLabels``."""
    Y = ovr_labels(y_int, n_classes, device=device)
    return MultitaskLabels(y=Y, n_classes=int(Y.shape[0]))

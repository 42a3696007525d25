"""Fixed-shape sparse matrices: the ELL layout of ``repro/data/sparse.py``
on torch tensors.

Every row is padded to ``k_max`` nonzeros.  Padding entries use
``index == n_features`` (one past the end) with ``value == 0.0``;
consumers keep a ``d+1``-length primal so padded scatter-adds land in a
dummy slot and padded gathers multiply by zero.  This is the layout the
CUDA ELL kernel (``repro_torch.kernels.dcd_ell``) reads.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.dist.mesh import resolve_device


class EllMatrix(NamedTuple):
    """ELL-format sparse matrix with label-folded rows (x_i = y_i * raw_i).

    Attributes:
        indices: (n_rows, k_max) int32 column ids; padding == n_features.
        values:  (n_rows, k_max) float32; padding == 0.
        n_features: true feature dimension d.
    """

    indices: torch.Tensor
    values: torch.Tensor
    n_features: int

    @property
    def n_rows(self) -> int:
        return self.indices.shape[0]

    @property
    def k_max(self) -> int:
        return self.indices.shape[1]

    @property
    def device(self) -> torch.device:
        return self.values.device

    def row_sq_norms(self) -> torch.Tensor:
        """‖x_i‖² for every row — precomputed once per solve (paper §3.1)."""
        return torch.sum(self.values * self.values, dim=1)

    def to_dense(self) -> torch.Tensor:
        d = self.n_features
        dense = torch.zeros((self.n_rows, d + 1), dtype=self.values.dtype,
                            device=self.device)
        dense.scatter_add_(1, self.indices.long(), self.values)
        return dense[:, :d]

    def to(self, device) -> "EllMatrix":
        return EllMatrix(self.indices.to(device), self.values.to(device),
                         self.n_features)


def dense_to_ell(dense, k_max: int | None = None, *,
                 device=None) -> EllMatrix:
    """Convert a dense (n, d) array to ELL (host-side, numpy), placed on
    ``device``.

    ``k_max`` defaults to the max per-row nonzero count (≥ 1); forcing it
    larger is allowed (extra slots pad), smaller raises — truncating a
    row would silently corrupt X.
    """
    dev = resolve_device(device)
    if torch.is_tensor(dense):
        dense = dense.detach().cpu().numpy()
    dense = np.asarray(dense)
    n, d = dense.shape
    nnz_per_row = (dense != 0).sum(axis=1)
    need = max(int(nnz_per_row.max()) if n else 0, 1)
    if k_max is None:
        k_max = need
    elif k_max < need:
        raise ValueError(f"k_max={k_max} < max per-row nnz {need}")
    indices = np.full((n, k_max), d, dtype=np.int32)
    values = np.zeros((n, k_max), dtype=np.float32)
    for i in range(n):
        (cols,) = np.nonzero(dense[i])
        indices[i, : len(cols)] = cols
        values[i, : len(cols)] = dense[i, cols]
    return EllMatrix(torch.from_numpy(indices).to(dev),
                     torch.from_numpy(values).to(dev), d)


def ell_row_dot(mat: EllMatrix, w_pad: torch.Tensor, i) -> torch.Tensor:
    """w·x_i against a (d+1,) padded primal vector. O(k_max)."""
    return torch.sum(w_pad[mat.indices[i].long()] * mat.values[i])


def ell_row_axpy(mat: EllMatrix, w_pad: torch.Tensor, i,
                 scale) -> torch.Tensor:
    """w + scale * x_i (padded scatter-add; padding lands in slot d).
    Returns a new vector; duplicate ids accumulate."""
    return w_pad.index_add(0, mat.indices[i].long(), scale * mat.values[i])


def ell_matvec(mat: EllMatrix, w: torch.Tensor) -> torch.Tensor:
    """X @ w for a (d,) vector. Returns (n_rows,)."""
    return torch.sum(pad_primal(w)[mat.indices.long()] * mat.values, dim=1)


def ell_rmatvec(mat: EllMatrix, alpha: torch.Tensor) -> torch.Tensor:
    """Xᵀ @ alpha. Returns (d,) — this is w(α) = Σ_i α_i x_i (eq. 3)."""
    d = mat.n_features
    w_pad = torch.zeros((d + 1,), dtype=mat.values.dtype, device=mat.device)
    w_pad.index_add_(0, mat.indices.reshape(-1).long(),
                     (alpha[:, None] * mat.values).reshape(-1))
    return w_pad[:d]


def pad_primal(w: torch.Tensor) -> torch.Tensor:
    """Append the dummy padding slot."""
    return torch.cat([w, w.new_zeros((1,))])


def unpad_primal(w_pad: torch.Tensor) -> torch.Tensor:
    return w_pad[:-1]

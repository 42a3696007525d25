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


# ---------------------------------------------- row-partitioned ELL ----


def pod_row_layout(n: int, n_pods: int, per_pod_rows: int | None = None):
    """Contiguous row partition across pods (the pod solver's layout,
    the reference's ``pod_row_layout``).  Pod k owns global rows
    [k·n_pod_loc, (k+1)·n_pod_loc), n_pod_loc = ⌈n / n_pods⌉, each pod's
    slice padded to ``per_pod_rows`` slots (the solver passes p·n_loc,
    so it subdivides evenly over the pod's data shards).  Returns host
    numpy ``(rowmap, mask)``: ``rowmap`` (n_pods, per_pod_rows) int32
    global row ids with the sentinel n on padding slots (a gather through
    it, with a padding row appended at index n, builds the layout in one
    pass), ``mask = rowmap < n``.  A larger ``per_pod_rows`` pads more;
    a smaller one raises (it would drop rows)."""
    n = int(n)
    n_pods = int(n_pods)
    if n_pods < 1:
        raise ValueError(f"n_pods must be >= 1, got {n_pods}")
    n_pod_loc = max(-(-n // n_pods), 1)
    if per_pod_rows is None:
        per_pod_rows = n_pod_loc
    elif per_pod_rows < n_pod_loc:
        raise ValueError(
            f"per_pod_rows={per_pod_rows} < rows per pod {n_pod_loc}")
    base = (np.arange(n_pods, dtype=np.int64)[:, None] * n_pod_loc
            + np.arange(per_pod_rows, dtype=np.int64)[None, :])
    mask = (np.arange(per_pod_rows)[None, :]
            < np.clip(n - np.arange(n_pods)[:, None] * n_pod_loc,
                      0, n_pod_loc))
    rowmap = np.where(mask, base, n).astype(np.int32)
    return rowmap, mask


class PodShardedEll(NamedTuple):
    """An ELL matrix row-partitioned into ``n_pods`` pod shards
    (``pod_row_layout``): padding slots hold all-padding rows (index
    ``n_features``, value 0) and are False in ``row_mask``.

    Attributes:
        indices: (n_pods, rows_per_pod, k_max) int32 column ids.
        values:  (n_pods, rows_per_pod, k_max) float32.
        row_mask: (n_pods, rows_per_pod) bool, True on real rows.
        n_features: the true feature dimension d.
        n_rows: the true row count n.
    """

    indices: torch.Tensor
    values: torch.Tensor
    row_mask: torch.Tensor
    n_features: int
    n_rows: int

    @property
    def n_pods(self) -> int:
        return self.indices.shape[0]

    @property
    def rows_per_pod(self) -> int:
        return self.indices.shape[1]

    @property
    def k_max(self) -> int:
        return self.indices.shape[2]

    def row_sq_norms(self) -> torch.Tensor:
        """(n_pods, rows_per_pod) ‖x_i‖², padding rows at 1 (q = 1, so a
        padding row's δ stays finite, the solver's convention)."""
        sq = torch.sum(self.values * self.values, dim=2)
        return torch.where(self.row_mask, sq, torch.ones_like(sq))

    def to_ell(self) -> EllMatrix:
        """The original ``EllMatrix``: the real rows in (pod, slot) order
        are the original row order."""
        m = self.row_mask.reshape(-1)
        return EllMatrix(self.indices.reshape(-1, self.k_max)[m],
                         self.values.reshape(-1, self.k_max)[m],
                         self.n_features)


def ell_row_partition(mat: EllMatrix, n_pods: int,
                      per_pod_rows: int | None = None) -> PodShardedEll:
    """Partition an ``EllMatrix`` by contiguous row ranges into
    ``n_pods`` pod shards, one gather through ``pod_row_layout``'s
    rowmap, on the matrix's device (never densifies).  The inverse is
    ``PodShardedEll.to_ell``."""
    rowmap, mask = pod_row_layout(mat.n_rows, n_pods, per_pod_rows)
    d, k, dev = mat.n_features, mat.k_max, mat.device
    idx = torch.cat([mat.indices.to(torch.int32),
                     torch.full((1, k), d, dtype=torch.int32, device=dev)])
    val = torch.cat([mat.values.to(torch.float32),
                     torch.zeros((1, k), dtype=torch.float32, device=dev)])
    rows = torch.from_numpy(rowmap).to(dev).long()
    return PodShardedEll(idx[rows], val[rows], torch.from_numpy(mask).to(dev),
                         d, mat.n_rows)


# ------------------------------------------- column-partitioned ELL ----


def active_row_remap(mask: torch.Tensor):
    """Fixed-capacity compaction of active rows: ``(ids, count)``, ids a
    length-n int32 permutation listing the rows where ``mask`` is True
    first, in their original order (stable), then the others; count how
    many are True.  An all-True mask gives the identity.  A (K, n) mask
    is K masks, compacted row by row: (K, n) ids and (K,) counts."""
    mask = mask.to(torch.bool)
    ids = torch.argsort((~mask).to(torch.int8), stable=True).to(torch.int32)
    return ids, torch.sum(mask.to(torch.int32), dim=-1)


class FeatureShardedEll(NamedTuple):
    """ELL matrix column-partitioned into ``n_shards`` feature shards —
    the input layout of the 2-D (feature-sharded) solver, as
    ``repro.data.sparse.FeatureShardedEll``.

    Shard ``j`` owns the contiguous global column range [j·d_loc,
    (j+1)·d_loc); every row stores its nonzeros in that range as a
    *local* ELL slice, so shard j gathers and scatters with local ids
    into its own (d_loc+1,) primal slice.

    Attributes:
        indices: (n_rows, n_shards, k_loc) int32 shard-local column ids
            (global id − j·d_loc); padding == d_loc, the shard's dummy
            slot.
        values:  (n_rows, n_shards, k_loc) float32; padding == 0.
        n_features: true global feature dimension d.
        d_loc: features per shard = ceil(d / n_shards).
    """

    indices: torch.Tensor
    values: torch.Tensor
    n_features: int
    d_loc: int

    @property
    def n_rows(self) -> int:
        return self.indices.shape[0]

    @property
    def n_shards(self) -> int:
        return self.indices.shape[1]

    @property
    def k_loc(self) -> int:
        return self.indices.shape[2]

    def row_sq_norms(self, chunk_elems: int = 1 << 26) -> torch.Tensor:
        """‖x_i‖² over all shards, in row chunks of about
        ``chunk_elems`` entries (no full-size temporary)."""
        rows = _chunk_rows(self.n_shards * self.k_loc, chunk_elems)
        return torch.cat([torch.sum(v * v, dim=(1, 2))
                          for v in self.values.split(rows)])

    def to_ell(self) -> EllMatrix:
        """Merge back to one ELL matrix with global column ids (k_max =
        n_shards·k_loc; the padding id restored to ``n_features``)."""
        n, m, k = self.indices.shape
        off = (torch.arange(m, dtype=torch.int32, device=self.indices.device)
               * self.d_loc)[None, :, None]
        glob = torch.where(self.indices >= self.d_loc,
                           torch.full_like(self.indices, self.n_features),
                           self.indices + off)
        return EllMatrix(glob.reshape(n, m * k),
                         self.values.reshape(n, m * k), self.n_features)


def flat_shard_ids(cols, d1: int) -> torch.Tensor:
    """Shard-local column ids (…, m, k) as int64 ids into the m primal
    slices of d1 words each, flattened to (m·d1,): shard j's ids offset
    by j·d1."""
    m = cols.shape[-2]
    off = torch.arange(m, dtype=torch.int64, device=cols.device) * d1
    return cols.long() + off[:, None]


def _chunk_rows(row_elems: int, chunk_elems: int) -> int:
    return max(1, int(chunk_elems) // max(int(row_elems), 1))


def _shard_counts(idx, d: int, m: int, d_loc: int):
    """Each entry's shard (padding → m) and the per-(row, shard) entry
    counts (r, m+1) of one row chunk."""
    shard = torch.where(idx < d, torch.div(idx, d_loc, rounding_mode="floor"),
                        m).long()
    cnt = torch.zeros((idx.shape[0], m + 1), dtype=torch.int64,
                      device=idx.device)
    cnt.scatter_add_(1, shard, torch.ones_like(shard))
    return shard, cnt


def ell_column_split(mat: EllMatrix, n_shards: int,
                     k_loc: int | None = None, *,
                     chunk_elems: int = 1 << 26) -> FeatureShardedEll:
    """Partition an ``EllMatrix`` by contiguous feature ranges into
    ``n_shards`` per-row local ELL slices, bit-equal to the reference's
    ``repro.data.sparse.ell_column_split``: a row's entries keep their
    order within a shard (a stable sort by shard).  Runs on the matrix's
    device in row chunks of about ``chunk_elems`` entries, so it never
    holds more than the input, one chunk's temporaries and the output.

    ``k_loc`` defaults to the max per-(row, shard) nonzero count (≥ 1);
    forcing it larger is allowed (extra slots pad), smaller raises.
    """
    idx_all, val_all = mat.indices, mat.values
    n, k = idx_all.shape
    d, m = mat.n_features, int(n_shards)
    if m < 1:
        raise ValueError(f"n_shards must be ≥ 1, got {n_shards}")
    d_loc = -(-d // m)  # ceil; shard j owns [j*d_loc, (j+1)*d_loc)
    rows = _chunk_rows(k, chunk_elems)
    need = 1
    for r0 in range(0, n, rows):
        _, cnt = _shard_counts(idx_all[r0:r0 + rows], d, m, d_loc)
        need = max(need, int(cnt[:, :m].max()))
    if k_loc is None:
        k_loc = need
    elif k_loc < need:
        raise ValueError(f"k_loc={k_loc} < max per-shard nnz {need}")
    k_loc = max(int(k_loc), 1)
    dev = idx_all.device
    out_idx = torch.full((n, m, k_loc), d_loc, dtype=torch.int32, device=dev)
    out_val = torch.zeros((n, m, k_loc), dtype=torch.float32, device=dev)
    flat_idx, flat_val = out_idx.view(-1), out_val.view(-1)
    for r0 in range(0, n, rows):
        idx, val = idx_all[r0:r0 + rows], val_all[r0:r0 + rows]
        shard, cnt = _shard_counts(idx, d, m, d_loc)
        # stable: a row's entries keep their order within a shard
        order = torch.argsort(shard, dim=1, stable=True)
        shard_s = torch.gather(shard, 1, order)
        start = torch.cumsum(cnt, dim=1) - cnt  # a run's first sorted slot
        rank = (torch.arange(k, device=dev)[None, :]
                - torch.gather(start, 1, shard_s))
        keep = shard_s < m
        row = (torch.arange(idx.shape[0], device=dev)[:, None] + r0)
        pos = ((row * m + shard_s) * k_loc + rank)[keep]
        idx_s = torch.gather(idx, 1, order)[keep]
        flat_idx[pos] = (idx_s.long() - shard_s[keep] * d_loc).int()
        flat_val[pos] = torch.gather(val, 1, order)[keep].float()
    return FeatureShardedEll(out_idx, out_val, d, d_loc)

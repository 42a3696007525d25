"""Synthetic linear-classification datasets matched to the paper's Table 3.

PyTorch counterpart of ``repro/data/synthetic.py``.  Two generators:

* ``make_dataset`` — the repo's recipes (Table-3 shapes cut by about
  40×), drawn on the host with numpy exactly as the reference draws
  them: the arrays are bit-equal to ``repro.data.make_dataset`` at the
  same name and seed, then placed on ``device``.
* ``make_paper_split`` — the Table-3 shapes themselves (LIBSVM's
  ``rcv1.binary``: n = 677,399, d = 47,236, 73 nnz per row, C = 1;
  ``covtype.binary``: n = 581,012, d = 54 dense, C = 0.0625; the
  trigram ``webspam`` training split of the paper's Table 3:
  n = 280,000, d = 16,609,143, 3,728 nnz per row, C = 1), drawn on the
  device from a seeded ``torch.Generator``.  The reference's row-by-row
  ``rng.choice`` takes minutes at that n; this draw keeps the same
  law — zipf(0.9) column popularity sampled without replacement, that
  is the first k distinct columns of an i.i.d. zipf stream, unit-norm
  rows, the same margin and label-noise rule, labels folded into the
  rows — but it is a different random stream from the reference: equal
  in distribution, not in values.  Up to ``RACE_MAX_D`` features the
  columns come from an exponential race (the k smallest of E_j / p_j,
  E_j ~ Exp(1), in draw order), which costs n·d draws; above it (webspam)
  from the stream itself: k inverse-CDF draws per row (``searchsorted``
  on the zipf CDF), then only the repeated slots are drawn again until
  every row holds k distinct columns.

Rows are L2-normalized to ≤ 1 (R_max = 1) and label-folded
(x_i = y_i·ẋ_i).

    name          n       d      nnz/row   C       mirrors
    news20-like   2,000   8,192  60        2.0     n ≪ d, sparse, separable
    covtype-like  8,000   54     12 (dense)0.0625  n ≫ d, dense rows
    rcv1-like     8,000   4,096  73        1.0     sparse, mid
    webspam-like  4,000   8,192  200       1.0     denser sparse rows
    kddb-like     16,000  16,384 30        1.0     n & d both large, very sparse
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.data.sparse import EllMatrix
from repro_torch.dist.mesh import resolve_device


@dataclasses.dataclass(frozen=True)
class DatasetRecipe:
    name: str
    n_train: int
    n_test: int
    d: int
    nnz_per_row: int  # == d → dense
    C: float
    label_noise: float = 0.02
    margin: float = 0.5


DATASET_RECIPES = {
    "news20": DatasetRecipe("news20", 2_000, 500, 8_192, 60, 2.0),
    "covtype": DatasetRecipe("covtype", 8_000, 1_000, 54, 54, 0.0625,
                             label_noise=0.15, margin=0.1),
    "rcv1": DatasetRecipe("rcv1", 8_000, 1_000, 4_096, 73, 1.0),
    "webspam": DatasetRecipe("webspam", 4_000, 1_000, 8_192, 200, 1.0),
    "kddb": DatasetRecipe("kddb", 16_000, 2_000, 16_384, 30, 1.0,
                          label_noise=0.05),
    # tiny recipes for unit tests
    "tiny": DatasetRecipe("tiny", 256, 64, 128, 16, 1.0),
    "tiny-dense": DatasetRecipe("tiny-dense", 256, 64, 32, 32, 1.0),
}

# the paper's Table-3 training sets at their published shapes
PAPER_RECIPES = {
    "rcv1": DatasetRecipe("rcv1", 677_399, 0, 47_236, 73, 1.0),
    "covtype": DatasetRecipe("covtype", 581_012, 0, 54, 54, 0.0625,
                             label_noise=0.15, margin=0.1),
    "webspam": DatasetRecipe("webspam", 280_000, 0, 16_609_143, 3_728, 1.0),
}

# the widest d drawn by the exponential race (n·d draws); wider recipes
# draw the zipf stream by inverse CDF (n·k draws and a few redraws)
RACE_MAX_D = 1 << 20


@dataclasses.dataclass
class SyntheticDataset:
    recipe: DatasetRecipe
    X_train: EllMatrix  # label-folded rows
    X_test: EllMatrix
    w_true: np.ndarray

    def dense_train(self) -> torch.Tensor:
        return self.X_train.to_dense()

    def dense_test(self) -> torch.Tensor:
        return self.X_test.to_dense()


def _zipf_probs(d: int) -> np.ndarray:
    p = 1.0 / np.arange(1, d + 1) ** 0.9  # bag-of-words-ish popularity
    return p / p.sum()


def _draw_rows(rng, recipe: DatasetRecipe, n: int):
    """(idx, val) of n unit-norm rows, before labels — the reference's
    draw, call for call on ``rng``."""
    d, k = recipe.d, recipe.nnz_per_row
    if k >= d:
        idx = np.tile(np.arange(d, dtype=np.int32), (n, 1))
        val = rng.standard_normal((n, d)).astype(np.float32)
    else:
        # zipf-weighted sampling WITHOUT replacement: no duplicate ids
        probs = _zipf_probs(d)
        idx = np.empty((n, k), dtype=np.int32)
        for i in range(n):
            idx[i] = rng.choice(d, size=k, replace=False, p=probs)
        val = rng.standard_normal((n, k)).astype(np.float32)
    norms = np.sqrt((val**2).sum(axis=1, keepdims=True))
    return idx, val / np.maximum(norms, 1e-8)


def _fold_labels(rng, recipe: DatasetRecipe, val, margins):
    n = val.shape[0]
    y = np.where(margins + recipe.margin * rng.standard_normal(n) > 0,
                 1.0, -1.0)
    flip = rng.random(n) < recipe.label_noise
    y = np.where(flip, -y, y).astype(np.float32)
    return val * y[:, None]  # label folding: x_i = y_i * raw_i


def _make_split(rng, recipe: DatasetRecipe, n: int):
    w_true = rng.standard_normal(recipe.d).astype(np.float32)
    w_true *= (np.abs(w_true) > 0.6)  # sparse-ish ground truth
    idx, val = _draw_rows(rng, recipe, n)
    margins = np.zeros(n, dtype=np.float32)
    for i in range(n):
        margins[i] = (val[i] * w_true[idx[i]]).sum()
    return idx, _fold_labels(rng, recipe, val, margins), w_true


def make_dataset(name: str, seed: int = 0,
                 recipe: Optional[DatasetRecipe] = None, *,
                 device=None) -> SyntheticDataset:
    """The repo's recipe ``name``, bit-equal to ``repro.data.make_dataset``
    at the same seed, on ``device``."""
    dev = resolve_device(device)
    recipe = recipe or DATASET_RECIPES[name]
    rng = np.random.default_rng(seed)
    idx, val, w_true = _make_split(rng, recipe, recipe.n_train)
    # test split shares w_true: drawn from its own stream
    rng2 = np.random.default_rng(seed + 1)
    tidx, tval = _draw_rows(rng2, recipe, recipe.n_test)
    margins = np.array([(tval[i] * w_true[tidx[i]]).sum()
                        for i in range(recipe.n_test)])
    tval = _fold_labels(rng2, recipe, tval, margins)

    def ell(i, v):
        return EllMatrix(torch.from_numpy(i).to(dev),
                         torch.from_numpy(np.ascontiguousarray(v)).to(dev),
                         recipe.d)

    return SyntheticDataset(recipe, ell(idx, val), ell(tidx, tval), w_true)


def _race_cols(g, n: int, d: int, k: int, dev, chunk_elems: int):
    """k distinct zipf columns per row by the exponential race, in row
    chunks of about ``chunk_elems`` race keys."""
    inv_p = torch.from_numpy(1.0 / _zipf_probs(d)).float().to(dev)
    rows = max(1, chunk_elems // d)
    cols = torch.empty((n, k), dtype=torch.int32, device=dev)
    keys = torch.empty((min(rows, n), d), device=dev)
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        race = keys[: r1 - r0].exponential_(generator=g).mul_(inv_p)
        cols[r0:r1] = torch.topk(race, k, dim=1, largest=False,
                                 sorted=True).indices.int()
    return cols


def _stream_cols(g, n: int, d: int, k: int, dev, chunk_elems: int):
    """k distinct zipf columns per row as the first k distinct values of
    an i.i.d. zipf stream: k inverse-CDF draws, then every slot that
    repeats an earlier slot of its row draws again, until none does.  In
    row chunks of about ``chunk_elems`` slots."""
    cdf = torch.cumsum(torch.from_numpy(_zipf_probs(d)).to(dev), 0)

    def draw(shape):
        u = torch.rand(shape, dtype=torch.float64, generator=g, device=dev)
        return torch.searchsorted(cdf, u, right=True).clamp_(max=d - 1)

    rows = max(1, chunk_elems // k)
    cols = torch.empty((n, k), dtype=torch.int32, device=dev)
    for r0 in range(0, n, rows):
        c = draw((min(rows, n - r0), k))
        todo = torch.arange(c.shape[0], device=dev)
        while todo.numel():
            sub = c[todo]
            srt, order = torch.sort(sub, dim=1, stable=True)
            # a slot repeats when it sorts after an equal, earlier slot
            rep = torch.zeros_like(sub, dtype=torch.bool).scatter_(
                1, order[:, 1:], srt[:, 1:] == srt[:, :-1])
            has = rep.any(dim=1)
            todo, sub, rep = todo[has], sub[has], rep[has]
            sub[rep] = draw((int(rep.sum()),))
            c[todo] = sub
        cols[r0:r0 + c.shape[0]] = c.int()
    return cols


def make_paper_split(name: str, seed: int = 0, *, device=None,
                     recipe: Optional[DatasetRecipe] = None,
                     chunk_elems: int = 1 << 26):
    """The label-folded training split of a Table-3 dataset at its
    published shape, drawn on ``device`` (see the module docstring for
    the law and how it relates to the reference's stream).

    Returns ``(X, w_true)``: X is an ``EllMatrix`` for a sparse recipe
    and a dense (n, d) float32 tensor for a dense one.  The sparse draw
    runs in row chunks of about ``chunk_elems`` race keys or slots."""
    dev = resolve_device(device)
    recipe = recipe or PAPER_RECIPES[name]
    n, d, k = recipe.n_train, recipe.d, recipe.nnz_per_row
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w_true = torch.randn(d, generator=g, device=dev)
    w_true = w_true * (w_true.abs() > 0.6)
    if k >= d:
        val = torch.randn((n, d), generator=g, device=dev)
        val = val / torch.clamp(val.norm(dim=1, keepdim=True), min=1e-8)
        margins = val @ w_true
    else:
        draw_cols = _race_cols if d <= RACE_MAX_D else _stream_cols
        cols = draw_cols(g, n, d, k, dev, chunk_elems)
        val = torch.randn((n, k), generator=g, device=dev)
        val /= torch.clamp(val.norm(dim=1, keepdim=True), min=1e-8)
        rows = max(1, chunk_elems // k)
        margins = torch.cat([
            (v * w_true[c.long()]).sum(dim=1)
            for c, v in zip(cols.split(rows), val.split(rows))])
    noise = torch.randn(n, generator=g, device=dev)
    y = torch.where(margins + recipe.margin * noise > 0, 1.0, -1.0)
    flip = torch.rand(n, generator=g, device=dev) < recipe.label_noise
    y = torch.where(flip, -y, y)
    val *= y[:, None]
    X = val if k >= d else EllMatrix(cols, val, d)
    return X, w_true

"""Incremental warm-start training for the serving engine (the
counterpart of ``repro/serve/trainer.py``).

The trainer carries the label-folded training matrix as an
``EllMatrix`` plus the last solve's (α, w), all tensors on its device.
Fresh labeled rows are validated and buffered (``add_labeled``); a
re-solve (``resolve``) appends them through
``repro_torch.data.sparse.ell_append`` on the device and runs
``solve_segmented`` warm-started from the carried duals — old
coordinates keep their α, appended rows enter at α = 0, which is why the
resumed gap beats a from-scratch solve at equal epochs.  On the card
each re-solve is B1 over the shard grid (binary) or the task grid
(one-vs-rest).

Robustness, as the reference's: the solve runs under the resilience
layer's watchdog, and the trainer adds an *outer* retry with backoff — a
``SolverDiverged`` escape rolls the trainer back to its last healthy
(X, α, w) and retries after an exponential backoff (a transient
``FaultPlan`` disarms on the retry, a persistent one stays armed); if
every attempt fails, ``resolve`` returns None and serving keeps
answering from the last published snapshot.  The drift trigger
(``drift_trip``) compares the published model's error on freshly
ingested rows against its error on the data it was trained on.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.data.sparse import EllMatrix, ell_append
from repro_torch.dist.mesh import drift_trip, resolve_device
from repro_torch.resilience import FaultPlan, SolverDiverged, solve_segmented

# entries a chunk of ``ell_scores``' gather holds at once
_SCORE_CHUNK = 1 << 24


def ell_scores(X: EllMatrix, w) -> torch.Tensor:
    """w·x_i for every row of a (label-folded) ELL matrix, on X's device
    — a correct classification has score > 0.  The gather runs in row
    chunks, so no full-size temporary is held."""
    d = X.n_features
    w = torch.as_tensor(w).to(device=X.device,
                              dtype=torch.float32).reshape(-1)
    w_pad = torch.zeros((d + 1,), dtype=torch.float32, device=X.device)
    w_pad[: min(w.shape[0], d)] = w[:d]
    if not X.n_rows:
        return torch.zeros((0,), dtype=torch.float32, device=X.device)
    rows = max(1, _SCORE_CHUNK // max(X.k_max, 1))
    return torch.cat([
        (w_pad[c.long()] * v).sum(dim=1)
        for c, v in zip(X.indices.split(rows), X.values.split(rows))])


def fold_labels(rows: EllMatrix, y) -> EllMatrix:
    """Label-fold raw feature rows (x_i ← y_i·x_i) after validating the
    labels the way the solver's mouth does: finite, ±1."""
    y = torch.as_tensor(y).to(device=rows.device,
                              dtype=torch.float32).reshape(-1)
    if y.shape[0] != rows.n_rows:
        raise ValueError(f"{rows.n_rows} rows but {y.shape[0]} labels")
    if not bool(torch.isfinite(y).all()):
        raise ValueError("labels must be finite")
    if not bool((y.abs() == 1.0).all()):
        raise ValueError("labels must be +/-1")
    return EllMatrix(rows.indices, rows.values * y[:, None],
                     rows.n_features)


def _validate_class_ids(y, n_rows: int, n_classes: int,
                        device=None) -> torch.Tensor:
    """Validate integer class ids the way ``fold_labels`` validates ±1
    labels — right count, integral, in [0, n_classes) — and return them
    as int32 on ``device`` (y's own when None)."""
    y = torch.as_tensor(y)
    dev = y.device if device is None else device
    if y.dim() != 1 or y.shape[0] != n_rows:
        raise ValueError(
            f"{n_rows} rows but labels of shape {tuple(y.shape)}")
    if y.dtype.is_floating_point or y.dtype == torch.bool:
        yf = y.to(torch.float64)
        if not bool(torch.isfinite(yf).all()) or not bool(
                (yf == torch.round(yf)).all()):
            raise ValueError("class ids must be finite integers")
        y = yf.to(torch.int64)
    if y.numel() and (int(y.min()) < 0 or int(y.max()) >= n_classes):
        raise ValueError(f"class ids must lie in [0, {n_classes})")
    return y.to(device=dev, dtype=torch.int32)


def _ovr(y_ids: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(K, n) one-vs-rest ±1 matrix of validated ids, on their device
    (``repro_torch.data.ovr_labels``'s values, built without a trip to
    the host)."""
    k = torch.arange(n_classes, device=y_ids.device)[:, None]
    return torch.where(y_ids[None, :].long() == k, 1.0, -1.0).to(
        torch.float32)


class IncrementalTrainer:
    """Carries (X, α, w) across streaming warm-start re-solves on
    ``device`` (the card unless the caller asks for the CPU).

    Binary (``n_classes=0``): ``X0`` arrives label-folded, ingested rows
    are folded at admission, α is (n,) and w is (d,).  K-class
    (``n_classes=K``): ``X0`` stays *raw* (shared-X one-vs-rest tasks
    cannot pre-fold), ``y0`` carries the integer class ids, ingested
    rows buffer with their ids, and each re-solve gives the multi-task
    solver the full (K, n) one-vs-rest matrix — the carried α is the
    (K, n) dual stack, w the (K, d) head stack, and the error is argmax
    misclassification.
    """

    def __init__(self, X0: EllMatrix, loss, *, epochs: int = 4,
                 n_classes: int = 0, y0=None,
                 drift_ratio: float = 2.0, drift_floor: float = 0.05,
                 min_new_rows: int = 8, retries: int = 2,
                 backoff_s: float = 0.05,
                 fault_plan: Optional[FaultPlan] = None,
                 solver_kwargs: Optional[dict] = None, device=None):
        self.device = resolve_device(device)
        self.X = X0.to(self.device)
        self.loss = loss
        self.n_classes = int(n_classes)
        if self.n_classes:
            if self.n_classes < 2:
                raise ValueError(
                    f"n_classes must be >= 2 (or 0 for binary), "
                    f"got {n_classes}")
            if y0 is None:
                raise ValueError(
                    "a multiclass trainer needs the class ids of X0")
            self.y_ids = _validate_class_ids(
                y0, X0.n_rows, self.n_classes, self.device)
        else:
            if y0 is not None:
                raise ValueError("y0 is only meaningful with n_classes>0")
            self.y_ids = None
        self.epochs = int(epochs)
        self.drift_ratio = float(drift_ratio)
        self.drift_floor = float(drift_floor)
        self.min_new_rows = int(min_new_rows)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.fault_plan = fault_plan
        self.solver_kwargs = dict(solver_kwargs or {})
        self.alpha: Optional[torch.Tensor] = None
        self.w: Optional[torch.Tensor] = None
        self.err_base: Optional[float] = None
        self._pending: list = []
        self._pending_y: list = []
        self.ledger = {"solves": 0, "diverged": 0, "retries": 0,
                       "gave_up": 0, "drift_trips": 0}

    # ---------------------------------------------------- ingest ----

    @property
    def pending_rows(self) -> int:
        return sum(c.n_rows for c in self._pending)

    def add_labeled(self, rows: EllMatrix, y) -> int:
        """Buffer freshly labeled rows on the trainer's device.  Binary:
        validated and label-folded.  Multiclass: the rows stay raw and
        their integer ids buffer alongside (the solver folds on read).
        Returns the pending count."""
        if rows.n_features != self.X.n_features:
            raise ValueError(
                f"n_features mismatch: have {self.X.n_features}, "
                f"got {rows.n_features}")
        rows = rows.to(self.device)
        if not bool(torch.isfinite(rows.values).all()):
            raise ValueError("ingested features must be finite")
        if self.n_classes:
            self._pending_y.append(_validate_class_ids(
                y, rows.n_rows, self.n_classes, self.device))
            self._pending.append(rows)
        else:
            self._pending.append(fold_labels(rows, y))
        return self.pending_rows

    def _pending_matrix(self) -> Optional[EllMatrix]:
        if not self._pending:
            return None
        merged = self._pending[0]
        for chunk in self._pending[1:]:
            merged = ell_append(merged, chunk)
        return merged

    # ----------------------------------------------------- drift ----

    def error_on(self, X: EllMatrix, w, y_ids=None) -> float:
        """Misclassification fraction of ``w``.  Binary (``y_ids``
        None): folded rows, a correct row scores > 0.  Multiclass: w is
        the (K, d) head stack, a row is correct when its own class wins
        the argmax over the heads' margins (head by head, as the
        reference: all heads at once would hold K × the gather)."""
        if y_ids is None:
            wrong = int((ell_scores(X, w) <= 0.0).sum())
            return wrong / X.n_rows if X.n_rows else float("nan")
        w = torch.as_tensor(w)
        margins = torch.stack([ell_scores(X, w[k])
                               for k in range(w.shape[0])])  # (K, n)
        ids = torch.as_tensor(y_ids).to(margins.device).long()
        wrong = int((margins.argmax(dim=0) != ids).sum())
        return wrong / X.n_rows if X.n_rows else float("nan")

    def drifted(self, w=None) -> bool:
        """Has the stream drifted away from the published model?
        Compares the error on the pending rows against the baseline
        error via ``drift_trip``; needs ``min_new_rows`` pending and an
        established baseline (a solve must have run)."""
        w = self.w if w is None else w
        if w is None or self.err_base is None:
            return False
        if self.pending_rows < self.min_new_rows:
            return False
        pend = self._pending_matrix()
        pend_y = torch.cat(self._pending_y) if self.n_classes else None
        err_new = self.error_on(pend, w, pend_y)
        trip = bool(int(drift_trip(
            np.float32(self.err_base), np.float32(err_new),
            ratio=self.drift_ratio, floor=self.drift_floor)))
        if trip:
            self.ledger["drift_trips"] += 1
        return trip

    # ----------------------------------------------------- solve ----

    def _solve(self, X: EllMatrix, epochs: int, alpha0, w0, plan,
               y_ids=None):
        kw = dict(epochs=epochs, alpha0=alpha0, w0=w0,
                  fault_plan=plan, record=True, device=self.device)
        if y_ids is not None:
            kw["y"] = _ovr(y_ids, self.n_classes)
        kw.update(self.solver_kwargs)
        return solve_segmented(X, self.loss, **kw)

    def fit(self, epochs: Optional[int] = None):
        """Initial (or forced full) solve on the carried matrix."""
        return self.resolve(epochs=epochs, require_pending=False)

    def resolve(self, epochs: Optional[int] = None, *,
                require_pending: bool = True):
        """Merge the pending rows and warm-start re-solve.  Returns the
        ``ResilientResult`` on success and commits (X, α, w, baseline);
        returns None once the retry budget is spent — the carried state
        is untouched and serving continues on the last healthy
        snapshot."""
        if require_pending and not self._pending:
            return None
        epochs = self.epochs if epochs is None else int(epochs)
        pend = self._pending_matrix()
        X_new = self.X if pend is None else ell_append(self.X, pend)
        y_new = None
        if self.n_classes:
            y_new = (self.y_ids if not self._pending_y else
                     torch.cat([self.y_ids] + self._pending_y))
        plan = self.fault_plan
        for attempt in range(self.retries + 1):
            try:
                res = self._solve(X_new, epochs, self.alpha, self.w,
                                  plan, y_new)
            except SolverDiverged:
                self.ledger["diverged"] += 1
                # transient-fault assumption: disarm a non-persistent
                # plan on retry (its injection already fired); a
                # persistent fault keeps tripping until the budget ends
                if plan is not None and not plan.persistent:
                    plan = None
                if attempt >= self.retries:
                    self.ledger["gave_up"] += 1
                    return None
                self.ledger["retries"] += 1
                time.sleep(self.backoff_s * (2 ** attempt))
                continue
            self.X = X_new
            self.y_ids = y_new
            self.alpha = res.result.alpha
            self.w = res.result.w_hat
            self.err_base = self.error_on(self.X, self.w, self.y_ids)
            self._pending = []
            self._pending_y = []
            self.ledger["solves"] += 1
            return res
        return None

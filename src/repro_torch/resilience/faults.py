"""Declarative, seeded fault injection for the solver (the counterpart
of ``repro/resilience/faults.py``).

A ``FaultPlan`` names what breaks and when, in the solver's terms:
device faults key on the global epoch (the segment runner's
``(nan_e, drop_e, dup_e)`` triple), host faults on the segment index
(payload corruption, SIGKILL).  Given the plan everything is
deterministic, so every recovery path replays exactly.

  ``nan_psum_epoch``      NaN lands in w after the epoch's rounds (one
                          pod) or in the cross-pod merge (pod mesh)
                          → the watchdog's non-finite census (code 2)
                          → rollback and a same-knob replay, the clean
                            solve bit for bit when the fault was
                            transient
  ``drop_merge_epoch``    a cross-pod merge contributes nothing
  ``dup_merge_epoch``     a cross-pod merge lands twice
                          → the gap/ε trend (code 1), or a clean replay
  ``corrupt_payload_segment``  NaNs in X's values for one segment
                          → the census → rollback and a replay on the
                            pristine ``setup.X``
  ``sigkill_segment``     the process dies after computing a segment and
                          before saving it → the next process resumes
                          from the last checkpoint and replays the
                          segment bit for bit

``persistent=True`` keeps a fault armed across rollbacks (recovery is
then impossible and the ladder runs out into ``SolverDiverged``); by
default a fault disarms once detected.  ``async_only=True`` arms the
device faults only while the segment keeps asynchrony on, so the rung-1
(synchronous) retry survives: the degradation ladder's own test.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    nan_psum_epoch: int = -1
    drop_merge_epoch: int = -1
    dup_merge_epoch: int = -1
    corrupt_payload_segment: int = -1
    corrupt_frac: float = 0.05
    sigkill_segment: int = -1
    seed: int = 0
    persistent: bool = False
    async_only: bool = False

    def device_fault(self, *, delay_rounds: int, pod_delay_rounds: int):
        """The ``(nan_e, drop_e, dup_e)`` triple for a segment run with
        the given effective knobs, or None when no device fault is
        armed; an ``async_only`` plan disarms once the ladder has made
        the solve synchronous."""
        if (self.async_only and delay_rounds == 0
                and pod_delay_rounds == 0):
            return None
        triple = (int(self.nan_psum_epoch), int(self.drop_merge_epoch),
                  int(self.dup_merge_epoch))
        return triple if any(v >= 0 for v in triple) else None

    @property
    def any_armed(self) -> bool:
        return (self.nan_psum_epoch >= 0 or self.drop_merge_epoch >= 0
                or self.dup_merge_epoch >= 0
                or self.corrupt_payload_segment >= 0
                or self.sigkill_segment >= 0)


def corrupt_payload(setup, *, frac: float = 0.05, seed: int = 0):
    """A copy of ``setup.X`` with a seeded ``frac`` of its values NaN —
    the dense matrix's, or the values of the ELL, feature-sharded or pod
    layout (its column ids kept) — on ``setup``'s device: the corrupted
    payload fault.  The mask is drawn with numpy from ``seed`` over the
    placed layout's values (padding included), so it is the same every
    run; a NaN value is what a flipped bit in a copied tile becomes
    after one multiply."""
    rng = np.random.default_rng(seed)

    def poison(vals):
        mask = torch.from_numpy(
            rng.random(tuple(vals.shape), dtype=np.float32) < frac)
        return torch.where(mask.to(vals.device), float("nan"), vals)

    if isinstance(setup.X, tuple):
        cols, vals = setup.X
        return (cols, poison(vals))
    return poison(setup.X)

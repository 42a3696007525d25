"""The segmented solver's state on disk and between rungs (the
counterpart of ``repro/resilience/state.py``).

The carried state is a flat ``{name: tensor}`` dict
(``repro_torch.core.sharded.pipeline_state_keys``), so a checkpoint is
self-describing: ``save_checkpoint`` records each key as its leaf's name
and ``load_solver_state`` reads the flat dict back with no template.  A
resume may therefore target another mesh: the host arrays come first,
and the caller decides between a bit resume (the layout matches) and an
elastic warm start before anything reaches the card.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from repro_torch.train.checkpoint import available_steps


class SolverDiverged(RuntimeError):
    """The watchdog tripped and the retries and the degradation ladder
    ran out — raised instead of returning NaN iterates.  Carries the
    last *healthy* state's result (``result``), the global epoch it
    reached (``epoch``) and each segment's attempt count (``history``)."""

    def __init__(self, message, *, epoch: int, history, result=None):
        super().__init__(message)
        self.epoch = int(epoch)
        self.history = tuple(history)
        self.result = result


def load_solver_state(ckpt_dir: str, step: int, *,
                      validate: bool = True) -> dict:
    """Checkpoint ``step`` of ``ckpt_dir`` as the flat ``{name:
    np.ndarray}`` dict it was saved from — the state's leaves, the
    ``meta_*`` scalars and the canonical ``alpha_canon``/``w_canon`` —
    after the prefix-hash integrity check (``ValueError`` on a
    mismatch)."""
    path = os.path.join(ckpt_dir, f"ckpt_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        # each leaf read from the archive once
        arrays = {key: data[key] for key in manifest["leaves"]}
    if validate:
        hasher = hashlib.sha256()
        for i in range(len(manifest["leaves"])):
            hasher.update(arrays[f"leaf_{i}"].tobytes()[:4096])
        if hasher.hexdigest() != manifest["content_hash"]:
            raise ValueError(f"checkpoint {path} failed integrity check")
    return {meta["name"]: arrays[key]
            for key, meta in manifest["leaves"].items()}


def load_newest_solver_state(ckpt_dir: str, *, validate: bool = True,
                             attempts: int = 8):
    """The newest loadable checkpoint of ``ckpt_dir`` as ``(state,
    step)``, racing the writer's ``gc_checkpoints``: a listed step whose
    directory, manifest or arrays vanish before they are read raises
    ``FileNotFoundError``, and the walk falls back to the next older
    step, re-listing up to ``attempts`` times.  An integrity failure
    still raises at once: falling back past a corrupt checkpoint would
    hide real damage."""
    last_err: Exception | None = None
    for _ in range(max(int(attempts), 1)):
        steps = available_steps(ckpt_dir)
        if not steps:
            break
        for step in reversed(steps):
            try:
                return load_solver_state(
                    ckpt_dir, step, validate=validate), int(step)
            except FileNotFoundError as e:  # the GC won the race
                last_err = e
    raise FileNotFoundError(
        f"no loadable checkpoint in {ckpt_dir!r}") from last_err


def drain_state(state: dict, target_keys, *, p: int = 1) -> dict:
    """A carried ``SolverState`` converted to a degraded segment's key
    set (rung 1 of ``degrade_ladder``): every in-flight aggregate lands —
    w += Δw and the whole pod FIFO (its axis 1, (K, delay, *w)) — the
    asynchronous carries are zeroed and the adaptive latch is forced
    synchronous.  Keys the degraded segment does not carry (``pbuf``)
    are dropped; the one it may gain is ``dwo`` (turning the overlap off
    puts the 2-D path on the self-tuning round scan), zeros of the
    port's (K, p, *w), ``p`` the data shards.  Idempotent once
    synchronous."""
    st = dict(state)
    w = st["w"] + st["dw"]
    if "pbuf" in st:
        w = w + st["pbuf"].sum(1)
    st["w"] = w
    st["dw"] = torch.zeros_like(st["dw"])
    if "dwo" in st:
        st["dwo"] = torch.zeros_like(st["dwo"])
    if "delay" in st:
        st["delay"] = torch.zeros_like(st["delay"])
    target = set(target_keys)
    for k in list(st):
        if k not in target:
            del st[k]
    for k in target:
        if k not in st:
            if k != "dwo":
                raise KeyError(
                    f"cannot synthesize state leaf {k!r} while draining "
                    "to a degraded config")
            w = st["w"]
            st[k] = torch.zeros((w.shape[0], p, *w.shape[1:]),
                                dtype=w.dtype, device=w.device)
    return st

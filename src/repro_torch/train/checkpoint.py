"""Checkpoints of the solver's state: atomic, content-hashed, in the
reference's on-disk format (``repro/train/checkpoint.py``).

A checkpoint is a directory ``<ckpt_dir>/ckpt_<step>/`` holding
``arrays.npz`` (one array a leaf, ``leaf_<i>``) and ``manifest.json``
(``{"step", "leaves": {leaf_<i>: {"name", "shape", "dtype"}},
"content_hash"}``).  The leaves are a flat dict's entries in sorted key
order, each named by its key, which is the order and the names the
reference's pytree flattening gives a flat dict; the content hash is a
SHA-256 over the first 4,096 bytes of each leaf in that order.  A save
writes a temporary directory and renames it into place, so a crash
mid-write never leaves a half checkpoint under a step's name, and the
next save sweeps what such a crash left behind.  The reference's
``repro.resilience.load_solver_state`` reads what ``save_checkpoint``
writes, and ``repro_torch.resilience.load_solver_state`` what the
reference writes.

The reference's pytree ``restore_checkpoint`` serves its language-model
trainer and is not ported with the solver's half.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

_TMP_PREFIX = ".tmp_ckpt_"


def _step_of(name: str) -> Optional[int]:
    """A directory entry as a checkpoint step: exactly ``ckpt_<int>``
    gives the int; anything else — a stray file, a ``ckpt_12_old`` set
    aside by hand, the temporary directories — gives None, so the
    listers skip it (and never take ``ckpt_12_old`` for step 12)."""
    if not name.startswith("ckpt_"):
        return None
    tail = name[len("ckpt_"):]
    return int(tail) if tail.isdigit() else None


def _sweep_stale_tmp(ckpt_dir: str) -> None:
    """Remove orphaned ``.tmp_ckpt_*`` directories: a process killed
    between writing the arrays and the rename leaves its temporary
    directory behind.  Safe, since only the process that made one ever
    looks at it, and that process is gone by the next save."""
    for entry in os.listdir(ckpt_dir):
        if entry.startswith(_TMP_PREFIX):
            shutil.rmtree(os.path.join(ckpt_dir, entry),
                          ignore_errors=True)


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, state: dict) -> str:
    """Write the flat dict ``state`` (tensors on any device, numpy arrays
    or scalars) as ``<ckpt_dir>/ckpt_<step>``, atomically, replacing a
    checkpoint of the same step.  Each leaf is fetched to the host once.
    Returns the checkpoint's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    _sweep_stale_tmp(ckpt_dir)
    arrays = {}
    manifest = {"step": int(step), "leaves": {}}
    hasher = hashlib.sha256()
    for i, name in enumerate(sorted(state)):
        arr = _to_numpy(state[name])
        key = f"leaf_{i}"
        arrays[key] = arr
        manifest["leaves"][key] = {
            "name": str(name), "shape": list(arr.shape),
            "dtype": str(arr.dtype)}
        hasher.update(arr.tobytes()[:4096])  # a prefix hash: cheap integrity
    manifest["content_hash"] = hasher.hexdigest()
    final = os.path.join(ckpt_dir, f"ckpt_{step}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=_TMP_PREFIX)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def available_steps(ckpt_dir: str) -> list:
    """Every checkpoint step present, ascending.  A snapshot: under a
    concurrent ``gc_checkpoints`` a listed step may vanish before it is
    opened, which loaders that race the GC must survive
    (``repro_torch.resilience.load_newest_solver_state``)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(s for s in map(_step_of, os.listdir(ckpt_dir))
                  if s is not None)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest checkpoint step, or None when there is none."""
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def gc_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    for s in available_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"ckpt_{s}"),
                      ignore_errors=True)

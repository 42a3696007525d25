"""Checkpoints of the solver's state and of the LM trainer's: atomic,
content-hashed, in the reference's on-disk format
(``repro/train/checkpoint.py``).

A checkpoint is a directory ``<ckpt_dir>/ckpt_<step>/`` holding
``arrays.npz`` (one array a leaf, ``leaf_<i>``) and ``manifest.json``
(``{"step", "leaves": {leaf_<i>: {"name", "shape", "dtype"}},
"content_hash"}``).  A leaf is named by its path as the reference's
``_flatten_with_names`` names it: a flat dict's keys in sorted order (the
solver's state), a NamedTuple's fields, a dict's sorted keys and a
list's indices joined by "/" (``params/periods/0/block/wq``,
``opt/m/embed``, ``opt/count``, ``step``); a ``None`` field (no master
copy, no compression) gives no leaf.  The content hash is a SHA-256 over
the first 4,096 bytes of each leaf in that order.  A save writes a
temporary directory and renames it into place, so a crash mid-write
never leaves a half checkpoint under a step's name, and the next save
sweeps what such a crash left behind.

An LM ``TrainState`` is written in the reference's stacked (L, …)
layout (``convert.train_state_to_numpy``; a bf16 leaf widened to
float32), so the reference's ``restore_checkpoint`` loads a port
checkpoint into its own ``TrainState`` and ``restore_checkpoint`` here
loads the reference's.  The solver's flat dicts keep their layout:
``repro.resilience.load_solver_state`` reads what ``save_checkpoint``
writes, and ``repro_torch.resilience.load_solver_state`` what the
reference writes.
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

from repro_torch.dist.sharding import host_full, is_dtensor, place
from repro_torch.tree import (
    leaves,
    leaves_with_names,
    tree_map,
    unflatten_like,
)

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


def _to_numpy(leaf, dst=None) -> np.ndarray:
    if torch.is_tensor(leaf):
        leaf = host_full(leaf, dst)
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def _prefix(arr) -> bytes:
    """The first 4,096 bytes of ``arr.tobytes()`` (C order), without
    copying the rest of the array."""
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)[
        :4096].tobytes()


def _spread(state) -> bool:
    """Whether ``state`` lies on a live mesh of more than one rank (a
    DTensor leaf): its save is then a collective."""
    return any(is_dtensor(t) and t.device_mesh.size() > 1
               for t in leaves(state))


def _reference_layout(state, dst=None):
    """The tree a checkpoint holds for ``state``: an LM ``TrainState`` in
    the reference's stacked layout (gathered to rank ``dst`` alone where
    given), anything else as it is."""
    from repro_torch.train.step import TrainState
    if isinstance(state, TrainState):
        from repro_torch.convert import train_state_to_numpy
        return train_state_to_numpy(state, dst=dst)
    return state


def save_checkpoint(ckpt_dir: str, step: int, state) -> str:
    """Write ``state`` — the solver's flat dict or an LM ``TrainState``
    (tensors on any device, numpy arrays or scalars) — as
    ``<ckpt_dir>/ckpt_<step>``, atomically, replacing a checkpoint of
    the same step.  Each leaf is fetched to the host once.  Returns the
    checkpoint's path.

    A state on a live mesh (DTensor leaves) is saved by every rank of
    it: each leaf is gathered whole to rank 0 (a collective every rank
    enters; the others build no copy of it), rank 0 alone writes the
    files one process writes, and the ranks meet at a barrier after the
    write, so a checkpoint is there for every rank once the call
    returns."""
    final = os.path.join(ckpt_dir, f"ckpt_{step}")
    dst = 0 if _spread(state) else None
    named = [(n, _to_numpy(leaf, dst)) for n, leaf in
             leaves_with_names(_reference_layout(state, dst))]
    if dst is None:
        return _write(ckpt_dir, step, named, final)
    import torch.distributed as dist

    if dist.get_rank() == dst:
        _write(ckpt_dir, step, named, final)
    dist.barrier()
    return final


def _write(ckpt_dir: str, step: int, named: list, final: str) -> str:
    """Write the (name, array) pairs as ``final``, atomically."""
    os.makedirs(ckpt_dir, exist_ok=True)
    _sweep_stale_tmp(ckpt_dir)
    arrays = {}
    manifest = {"step": int(step), "leaves": {}}
    hasher = hashlib.sha256()
    for i, (name, arr) in enumerate(named):
        key = f"leaf_{i}"
        arrays[key] = arr
        manifest["leaves"][key] = {
            "name": name, "shape": list(arr.shape),
            "dtype": str(arr.dtype)}
        hasher.update(_prefix(arr))  # a prefix hash: cheap integrity
    manifest["content_hash"] = hasher.hexdigest()
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


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _meta_stack(layers: list) -> dict:
    return {k: torch.stack([_meta(lp[k]) for lp in layers])
            for k in layers[0]}


def restore_checkpoint(ckpt_dir: str, step: int, state_template,
                       shardings=None, *, validate: bool = True):
    """Load ``ckpt_<step>`` (written by either package, at any world
    size) into a new LM ``TrainState`` of the template's structure and
    dtypes.  Returns (state, step).  Leaves are matched by the
    reference's names and checked against the template's shapes in its
    stacked layout.  ``validate`` checks the content hash first.

    Without ``shardings`` every leaf is a plain tensor on the template's
    device.  With ``shardings`` (a ``TrainState`` of ``NamedSharding``,
    ``train.train_state_shardings``: the elastic path, any mesh) each
    rank reads the arrays and places every leaf under its sharding on
    their live mesh (``dist.sharding.place``), as the reference's
    ``jax.device_put(array, sharding)`` does.  The solver's flat dicts
    are read by ``repro_torch.resilience.load_solver_state``."""
    from repro_torch.convert import _unstack_params, map_train_state
    from repro_torch.tree import map_layer_groups

    path = os.path.join(ckpt_dir, f"ckpt_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        data = {key: npz[key] for key in manifest["leaves"]}  # read once
    if validate:
        hasher = hashlib.sha256()
        for i in range(len(manifest["leaves"])):
            hasher.update(_prefix(data[f"leaf_{i}"]))
        if hasher.hexdigest() != manifest["content_hash"]:
            raise ValueError(f"checkpoint {path} failed integrity check")
    by_name = {meta["name"]: key for key, meta in manifest["leaves"].items()}
    # the template's names and stacked shapes, without reading the device
    layout = map_train_state(
        state_template, lambda p: map_layer_groups(p, _meta_stack, _meta),
        _meta)
    loaded = []
    for name, tmpl in leaves_with_names(layout):
        key = by_name.get(name)
        if key is None:
            raise KeyError(f"leaf {name!r} missing from checkpoint {path}")
        arr = data[key]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"shape mismatch for {name}: ckpt {arr.shape} "
                             f"vs template {tuple(tmpl.shape)}")
        loaded.append(arr)
    if shardings is None:
        dev = state_template.step.device
        state = map_train_state(unflatten_like(layout, loaded),
                                lambda p: _unstack_params(p, dev),
                                lambda a: torch.tensor(a, device=dev))
    else:
        state = map_train_state(
            unflatten_like(layout, loaded),
            lambda p, sh: _unstack_params(p, None, sh),
            lambda a, sh: place(torch.tensor(a), sh), shardings)
    return (tree_map(lambda t, like: t.to(like.dtype), state, state_template),
            manifest["step"])


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

"""Worlds of ``gloo`` ranks for the distributed CPU tests.

``run_world(size, spec, tmp)`` spawns ``size`` ranks with
``torch.multiprocessing.spawn`` under a ``gloo`` group whose ``file://``
store lies in ``tmp`` (no TCP port, so parallel test workers never
meet).  Each rank runs every item of ``spec`` (name → ``{"kind": …}``)
in order; rank 0 writes each item's arrays to ``tmp/<name>.npz`` and
``run_world`` returns them.  Kinds:

  ``solve``       ``case`` (a ``test_torch_shards.case``) solved on its
                  mesh spread over ``ranks`` ({axis: count}), and again
                  in this process on the mesh without ranks (the
                  one-process solve at the same mesh and seed): arrays
                  ``dist_*`` and ``one_*`` (α, ŵ, gaps, ε, active, delay)
  ``collectives`` the collective layer's order, SUM, MAX and errors
  ``segmented``   the segmented solve saved at one world size and
                  resumed at another (``repro_torch.resilience``)
  ``fault``       a NaN fault armed on rank 0 only
  ``fake_mesh``   ``make_fake_mesh`` under the live group
  ``placement``   ``case``'s dataset placed on its mesh spread over
                  ``ranks``: every rank's bytes of placed X, their
                  storage's bytes and whether that storage is the
                  caller's X (``ranks``, one row a rank), and the
                  one-process placement's bytes (``one``)

No JAX here: the ranks import only ``repro_torch``.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import duals as td
from repro_torch.core import sharded as ts
from repro_torch.data.synthetic import make_dataset
from repro_torch.dist import collectives as tc
from repro_torch.dist.mesh import (
    SolverMesh,
    make_fake_mesh,
    rank_layout,
    solver_mesh_2d,
    solver_mesh_3d,
    with_ranks,
)
from repro_torch.resilience import FaultPlan, solve_segmented

FIELDS = ("alpha", "w_hat", "gaps", "eps", "active", "delay")


def port_X(rows: int, dense: bool):
    """The first ``rows`` rows of ``tiny`` (the arrays of
    ``repro.data.make_dataset("tiny")``, bit for bit), ELL or dense."""
    X = make_dataset("tiny", device="cpu").X_train
    X = type(X)(X.indices[:rows], X.values[:rows], X.n_features)
    return X.to_dense() if dense else X


def mesh_for(c: dict, ranks=None):
    """A case's mesh, spread over ``ranks`` when given."""
    P, p, m = c.get("pods"), c["p"], c["model"]
    if P and m is None:
        mesh = SolverMesh(("pod", "data"), (P, p))
    elif P:
        mesh = solver_mesh_3d(pod=P, data=p, model=m)
    elif m is None:
        mesh = SolverMesh(("data",), (p,))
    else:
        mesh = solver_mesh_2d(data=p, model=m)
    return mesh if not ranks else with_ranks(mesh, ranks)


def solve(c: dict, mesh):
    Y = c.get("Y")
    return ts.sharded_passcode_solve(
        port_X(c["rows"], c["dense"]), td.make_loss(c["loss"]), mesh=mesh,
        y=None if Y is None else np.asarray(Y, np.float32), device="cpu",
        **c["kw"])


def _arrays(res, prefix):
    return {f"{prefix}_{k}": np.asarray(getattr(res, k)) for k in FIELDS
            if getattr(res, k) is not None}


def _solve_item(item, rank):
    c = item["case"]
    out = _arrays(solve(c, mesh_for(c, item["ranks"])), "dist")
    if rank == 0:
        out.update(_arrays(solve(c, mesh_for(c)), "one"))
    return out


def _collectives_item(item, rank):
    size = dist.get_world_size()
    lay = rank_layout(with_ranks(SolverMesh(("data",), (2 * size,)),
                                 {"data": size}))
    out = {
        "order": tc.gather_axis(torch.full((2,), float(rank)), lay, "data"),
        "order_dim1": tc.gather_axis(torch.full((2, 1), float(rank)), lay,
                                     "data", 1),
        "sum": tc.sum_int(torch.tensor([rank + 1, 2**40 + rank]), lay),
        "max": tc.max_all(torch.tensor([float(rank), -float(rank)]), lay),
        "virtual": tc.gather_axis(torch.full((2,), float(rank)), lay,
                                  "model"),
        "span": torch.tensor(lay.span("data", 2 * size)),
    }
    errors = []
    try:
        tc.sum_int(torch.ones(2), lay)
    except TypeError as exc:
        errors.append(str(exc))
    try:
        with_ranks(SolverMesh(("data",), (3,)), {"data": size})
    except ValueError as exc:
        errors.append(str(exc))
    dm = with_ranks(SolverMesh(("data",), (size,)), {"data": size})
    try:
        rank_layout(SolverMesh(("data",), (size + 1,), dm.device_mesh))
    except ValueError as exc:
        errors.append(str(exc))
    out["errors"] = np.array(errors)
    return out


def _segmented_item(item, rank):
    """Save at one world size, resume at the other: ``order`` "2to1"
    saves at W ranks and resumes on rank 0 alone, "1to2" the reverse.
    The whole solve runs on rank 0 alone for the bits."""
    c, ckpt = item["case"], Path(item["dir"])
    X, loss = port_X(c["rows"], c["dense"]), td.make_loss(c["loss"])
    kw = dict(c["kw"], device="cpu")
    total, every = kw.pop("epochs"), item["every"]
    spread, alone = mesh_for(c, item["ranks"]), mesh_for(c)
    saver, resumer = ((spread, alone) if item["order"] == "2to1"
                      else (alone, spread))
    out = {}
    if saver is spread or rank == 0:
        r = solve_segmented(X, loss, epochs=total, checkpoint_every=every,
                            ckpt_dir=str(ckpt), mesh=saver, **kw)
        if rank == 0:
            out.update(_arrays(r.result, "saved"))
            # drop the final boundary: the resume replays from the one
            # before it
            shutil.rmtree(ckpt / f"ckpt_{total}")
    dist.barrier()
    if resumer is spread or rank == 0:
        r = solve_segmented(X, loss, epochs=total, checkpoint_every=every,
                            ckpt_dir=str(ckpt), resume=True, mesh=resumer,
                            **kw)
        if rank == 0:
            out.update(_arrays(r.result, "resumed"))
            out["resumed_from"] = np.int64(r.resumed_from)
            whole = solve_segmented(X, loss, epochs=total, mesh=alone, **kw)
            out.update(_arrays(whole.result, "whole"))
    dist.barrier()
    return out


def _fault_item(item, rank):
    """A NaN armed on rank 0 only (persistent while the solve is
    asynchronous): every rank's watchdog trips the same way."""
    c = item["case"]
    plan = (FaultPlan(nan_psum_epoch=item["epoch"], persistent=True,
                      async_only=True) if rank == 0 else FaultPlan())
    kw = dict(c["kw"], device="cpu")
    total = kw.pop("epochs")
    r = solve_segmented(port_X(c["rows"], c["dense"]),
                        td.make_loss(c["loss"]), epochs=total,
                        checkpoint_every=item["every"], fault_plan=plan,
                        mesh=mesh_for(c, item["ranks"]), **kw)
    rec = torch.full((8,), -1, dtype=torch.int64)
    vals = [r.health, r.rollbacks, r.rung, r.epochs_lost, *r.attempts]
    rec[:len(vals)] = torch.tensor(vals)
    every = [torch.empty_like(rec) for _ in range(dist.get_world_size())]
    dist.all_gather(every, rec)
    return {"records": torch.stack(every), **_arrays(r.result, "dist")}


def _fake_mesh_item(item, rank):
    size = dist.get_world_size()
    try:
        make_fake_mesh((size + 2,), ("data",))
        raised = ""
    except RuntimeError as exc:
        raised = str(exc)
    return {"raised": np.array(raised),
            "world": np.int64(dist.get_world_size()),
            "backend": np.array(dist.get_backend()),
            "gather": tc.gather_axis(
                torch.full((1,), float(rank)),
                rank_layout(with_ranks(SolverMesh(("data",), (size,)),
                                       {"data": size})), "data")}


def _placement_item(item, rank):
    c = item["case"]
    X = port_X(c["rows"], c["dense"])
    src = {t.untyped_storage().data_ptr()
           for t in ((X,) if c["dense"] else (X.indices, X.values))}

    def placed(mesh):
        setup = ts.solver_mouth(X, td.make_loss(c["loss"]), mesh=mesh,
                                device="cpu",
                                block_size=c["kw"]["block_size"])
        return setup.X if isinstance(setup.X, tuple) else (setup.X,)

    here = placed(mesh_for(c, item["ranks"]))
    rec = torch.tensor([
        sum(t.numel() * t.element_size() for t in here),
        sum(t.untyped_storage().nbytes() for t in here),
        int(any(t.untyped_storage().data_ptr() in src for t in here))])
    every = [torch.empty_like(rec) for _ in range(dist.get_world_size())]
    dist.all_gather(every, rec)
    one = placed(mesh_for(c))
    return {"ranks": torch.stack(every),
            "one": np.int64(sum(t.numel() * t.element_size() for t in one))}


ITEMS = {"solve": _solve_item, "collectives": _collectives_item,
         "segmented": _segmented_item, "fault": _fault_item,
         "fake_mesh": _fake_mesh_item, "placement": _placement_item}


def _rank(rank, size, store, spec_path, out_dir):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=size)
    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    for name, item in spec.items():
        out = ITEMS[item["kind"]](item, rank)
        if rank == 0:
            np.savez(Path(out_dir) / f"{name}.npz",
                     **{k: np.asarray(v) for k, v in out.items()})
    dist.barrier()
    dist.destroy_process_group()


def run_world(size: int, spec: dict, tmp) -> dict:
    """Run ``spec`` on a world of ``size`` gloo ranks; name → arrays."""
    tmp = Path(tmp)
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps(spec))
    mp.spawn(_rank, args=(size, str(tmp / "store"), str(spec_path),
                          str(tmp)), nprocs=size, join=True)
    return {name: dict(np.load(tmp / f"{name}.npz")) for name in spec}

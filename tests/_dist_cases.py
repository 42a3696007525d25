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
  ``trainer``     the binary ``IncrementalTrainer`` (fit, a drift-free
                  chunk, a drifted chunk, a warm re-solve) with its
                  solves on ``case``'s mesh spread over ``ranks``, then
                  on rank 0 with the mesh whole: ``dist_*`` and
                  ``one_*`` (each solve's α, ŵ and gaps, the published
                  snapshot's ``w_pad``, ``err_base``, the ledger, the
                  ``drifted()`` answers)

The LM stack on a live ``DeviceMesh`` (``make_rank_mesh(mesh,
names)``), each item on ``arch``'s smoke config from the reference's
parameters and train batch that the parent wrote to ``inputs`` (an
``.npz`` of "/"-joined names, ``save_tree``):

  ``lm_step``     one train step on the mesh (``microbatches``,
                  ``acc_shardings`` = ZeRO-1's when > 1): the gathered
                  gradients (``g/…``) and updated parameters (``p/…``)
                  in the reference's stacked layout, the metrics, and
                  ``inplace`` / ``shards`` (every rank wrote each leaf
                  in its own storage and holds exactly its shard)
  ``lm_codec``    the one-process gradients through both codecs, in
                  this process and placed on the mesh: ``<codec>/one/…``
                  and ``<codec>/mesh/…`` (sent and residual)
  ``lm_loop``     ``run_training`` on the mesh with a fault on rank 0
                  only, and without one; the checkpoint the clean run
                  saved restored at one process and onto the mesh
  ``lm_restore``  a reference checkpoint in ``dir`` restored onto the
                  mesh with ``shardings=``: every leaf's placements and
                  gathered values; and the state saved there restored at
                  one process
  ``lm_serve``    prefill and ``gen`` greedy decode steps on the mesh,
                  and in this process from the same parameters
  ``rank_mesh``   ``make_rank_mesh`` over the live group: its device
                  type and shape, and its refusal of a shape of another
                  size
  ``staging``     ``host_staged``'s gather, reduce-scatter and all-to-all
                  on CPU tensors against the same function of every
                  rank's input, gathered
  ``host_side``   the host-side collectives (``host_full`` to every rank
                  and to rank 0 alone, ``mesh_max``, ``mesh_gather``,
                  the loop's failure flag, a checkpoint's save) with
                  every tensor they hand to ``torch.distributed``
                  recorded: its device against ``crossing_device``'s,
                  and what each rank got
  ``moe_groups``  ``moe_mlp``'s scatter codec over token groups split
                  over ``data`` (the router and experts replicated
                  there): the output and every input's gradient, on the
                  mesh (gathered) and in this process

No JAX here: the ranks import only ``repro_torch``.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.convert import train_state_to_numpy
from repro_torch.core import duals as td
from repro_torch.core import sharded as ts
from repro_torch.data.synthetic import make_dataset
from repro_torch.dist import collectives as tc
from repro_torch.dist.collectives import mesh_gather, mesh_max
from repro_torch.dist.mesh import (
    SolverMesh,
    make_fake_mesh,
    make_rank_mesh,
    rank_layout,
    solver_mesh_2d,
    solver_mesh_3d,
    with_ranks,
)
from repro_torch.data.sparse import dense_to_ell
from repro_torch.resilience import FaultPlan, solve_segmented
from repro_torch.dist.sharding import (
    NO_RULES,
    ShardingRules,
    batch_sharding,
    cache_shardings,
    gather_full,
    is_dtensor,
    on_mesh,
    place,
    replicated,
)
from repro_torch.models.transformer import init_cache
from repro_torch.optim import make_schedule
from repro_torch.optim.grad_compress import compress_init, compressed_grads
from repro_torch.serve import IncrementalTrainer, snapshot_from_result
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.train import (
    LoopConfig,
    init_train_state,
    make_train_step,
    restore_checkpoint,
    run_training,
    save_checkpoint,
    train_state_for,
    train_state_shardings,
    train_state_specs,
)
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import leaves, leaves_with_names, unflatten_like

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


def run_trainer(inputs: dict, mesh) -> dict:
    """``inputs`` (``X0``, the label-folded rows, and ``chunks``, [rows,
    labels] pairs, as nested lists) through the port's binary trainer
    with its solves on ``mesh``: fit, ingest each chunk (asking
    ``drifted()`` after each), re-solve warm over 2 epochs, and publish
    the re-solve as the engine does (``snapshot_from_result``)."""
    tr = IncrementalTrainer(
        dense_to_ell(np.asarray(inputs["X0"], np.float32), device="cpu"),
        td.Hinge(C=1.0), epochs=3, drift_floor=0.1, min_new_rows=4,
        backoff_s=0.001, solver_kwargs=dict(block_size=8, seed=3,
                                            mesh=mesh), device="cpu")
    fit = tr.fit().result
    drifted = []
    for X, y in inputs["chunks"]:
        tr.add_labeled(dense_to_ell(np.asarray(X, np.float32),
                                    k_max=tr.X.k_max, device="cpu"),
                       np.asarray(y, np.float32))
        drifted.append(tr.drifted())
    res = tr.resolve(epochs=2)
    out = {f"fit_{k}": getattr(fit, k) for k in ("alpha", "w_hat", "gaps")}
    out.update({f"res_{k}": getattr(res.result, k)
                for k in ("alpha", "w_hat", "gaps")})
    out["w_pad"] = snapshot_from_result(res, 1).w_pad
    out["err_base"] = np.float64(tr.err_base)
    out["ledger"] = np.array([tr.ledger[k] for k in sorted(tr.ledger)])
    out["drifted"] = np.array(drifted)
    out["X_indices"], out["X_values"] = tr.X.indices, tr.X.values
    return out


def _trainer_item(item, rank):
    c = item["case"]
    out = {f"dist_{k}": v for k, v in run_trainer(
        item["inputs"], mesh_for(c, item["ranks"])).items()}
    if rank == 0:
        out.update({f"one_{k}": v for k, v in run_trainer(
            item["inputs"], mesh_for(c)).items()})
    return out


# ------------------------------------------------------------ the LM stack

LM_LR = dict(peak_lr=1e-3, total_steps=100, warmup_steps=2)


def save_tree(path, tree) -> None:
    """A tree of arrays as an ``.npz`` of "/"-joined leaf names."""
    np.savez(path, **{name: np.asarray(leaf)
                      for name, leaf in leaves_with_names(tree)})


def load_tree(path, prefix: str = "") -> dict:
    """``save_tree``'s file (the leaves under ``prefix``) as nested
    dicts, a run of digit keys a list."""
    out: dict = {}
    with np.load(path) as data:
        for name in data.files:
            if not name.startswith(prefix):
                continue
            node, keys = out, name[len(prefix):].split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = data[name]

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(out)


def _lm_setup(item, *, codec=None):
    """(cfg, mesh, rules, the reference's parameters as numpy, the batch
    as tensors, the state's shardings)."""
    cfg = get_smoke_config(item["arch"])
    mesh = make_rank_mesh(tuple(item["mesh"]), tuple(item["names"]),
                          device="cpu")
    params = load_tree(item["inputs"], "params/")
    batch = {k: torch.from_numpy(v) for k, v in
             load_tree(item["inputs"], "batch/").items()}
    sh = train_state_shardings(cfg, mesh, train_state_specs(
        cfg, dtype=torch.float32, compress=codec is not None))
    return cfg, mesh, ShardingRules(mesh), params, batch, sh


def _place_batch(batch, mesh):
    return place(batch, {k: batch_sharding(mesh, v.shape[0], v.dim())
                         for k, v in batch.items()})


def _placed_state(cfg, params, sh, *, compress=False):
    return train_state_for(params_from_numpy(cfg, params,
                                             shardings=sh.params),
                           compress=compress, opt_shardings=sh.opt.m)


def _all_ranks(flag: bool, mesh) -> bool:
    """``flag`` held on every rank (a MAX over the negations)."""
    return not int(mesh_max(torch.tensor([int(not flag)]), mesh)[0])


def _shards_held(state, sh) -> bool:
    """Every leaf of ``state`` a DTensor holding exactly its sharding's
    shard, under its placements."""
    return all(is_dtensor(t) and tuple(t.to_local().shape)
               == s.shard_shape(tuple(t.shape))
               and tuple(t.placements) == s.placements()
               for t, s in zip(leaves(state), leaves(sh)))


def _stacked(prefix, tree) -> dict:
    """A port parameter tree (DTensors gathered) in the reference's
    stacked layout, its leaves named under ``prefix``."""
    return {f"{prefix}/{n}": a for n, a in
            leaves_with_names(params_to_numpy(tree))}


def _lm_step_item(item, rank):
    mb = item.get("microbatches", 1)
    cfg, mesh, rules, params, batch, sh = _lm_setup(item)
    state = _placed_state(cfg, params, sh)
    placed = _place_batch(batch, mesh)
    grads, _, _ = loss_and_grads(cfg, state.params, placed, rules=rules)
    out = _stacked("g", unflatten_like(state.params, grads))
    del grads
    def ptrs(s):  # the leaves the step updates in place
        return [t.to_local().data_ptr()
                for t in leaves((s.params, s.opt.m, s.opt.v))]

    before = ptrs(state)
    step = make_train_step(cfg, schedule=make_schedule("cosine", **LM_LR),
                           rules=rules, microbatches=mb,
                           acc_shardings=sh.opt.m if mb > 1 else None)
    new, metrics = step(state, placed)
    out.update(_stacked("p", new.params))
    # each metric as a rank reads it (float() of its own tensor), on every
    # rank
    out.update({k: mesh_gather(torch.tensor([float(v)], dtype=torch.float64),
                               mesh)[:, 0] for k, v in metrics.items()})
    out["inplace"] = _all_ranks(before == ptrs(new), mesh)
    out["shards"] = _all_ranks(_shards_held(new, sh), mesh)
    return out


def _lm_codec_item(item, rank):
    cfg, mesh, rules, params, batch, sh = _lm_setup(item, codec="topk")
    one = params_from_numpy(cfg, params, device="cpu")
    grads, _, _ = loss_and_grads(cfg, one, batch)
    grads = unflatten_like(one, grads)
    out = {}
    for codec in ("topk", "int8"):
        sent, st = compressed_grads(grads, compress_init(one), codec=codec)
        out.update(_stacked(f"{codec}/one/sent", sent))
        out.update(_stacked(f"{codec}/one/residual", st.residual))
        placed = place(grads, sh.params)
        with on_mesh(rules):
            sent, st = compressed_grads(placed, compress_init(
                placed, sh.opt.m), codec=codec)
        out.update(_stacked(f"{codec}/mesh/sent", sent))
        out.update(_stacked(f"{codec}/mesh/residual", st.residual))
    return out


def _lm_loop_item(item, rank):
    """Four steps, a checkpoint every two; the fault run raises on rank
    0 alone at step 3, once."""
    cfg, mesh, rules, params, batch, sh = _lm_setup(item)
    step = make_train_step(cfg, schedule=make_schedule("cosine", **LM_LR),
                           rules=rules)
    placed = _place_batch(batch, mesh)
    fired = []

    def fault(s):
        if rank == 0 and s == 3 and not fired:
            fired.append(s)
            raise RuntimeError("injected on rank 0")

    out = {}
    for run, hook in (("clean", None), ("fault", fault)):
        ckpt = str(Path(item["dir"]) / run)
        state, rep = run_training(
            _placed_state(cfg, params, sh), step, lambda s: placed,
            LoopConfig(total_steps=4, ckpt_dir=ckpt, ckpt_every=2,
                       log_every=100), shardings=sh, fault_hook=hook,
            log=lambda *_: None)
        out.update(_stacked(f"{run}/p", state.params))
        rec = torch.tensor([rep.final_step, rep.n_failures,
                            len(rep.restarts)] + [
            s for _, s in rep.restarts[:1]], dtype=torch.int64)
        out[f"{run}/report"] = mesh_gather(rec, mesh)
        out[f"{run}/losses"] = mesh_gather(torch.tensor(
            rep.losses, dtype=torch.float64), mesh)
    # the clean run's last checkpoint (its final save, step 4) restored
    # at one process and onto the mesh
    ckpt = str(Path(item["dir"]) / "clean")
    saved = train_state_to_numpy(state)
    whole = {f"saved/{n}": a for n, a in leaves_with_names(saved)}
    onto, step_n = restore_checkpoint(ckpt, 4, state, sh)
    out["onto_step"] = np.int64(step_n)
    out["onto_shards"] = _all_ranks(_shards_held(onto, sh), mesh)
    out.update({f"onto/{n}": a for n, a in leaves_with_names(
        train_state_to_numpy(onto))})
    if rank == 0:
        template = train_state_for(params_from_numpy(cfg, params,
                                                     device="cpu"))
        alone, _ = restore_checkpoint(ckpt, 4, template)
        out.update({f"alone/{n}": a for n, a in leaves_with_names(
            train_state_to_numpy(alone))})
        out.update(whole)
    dist.barrier()
    return out


def _lm_restore_item(item, rank):
    """A reference checkpoint at ``step`` in ``dir`` restored onto the
    mesh; then saved there (every rank) and restored at one process."""
    cfg = get_smoke_config(item["arch"])
    mesh = make_rank_mesh(tuple(item["mesh"]), tuple(item["names"]),
                          device="cpu")
    template = init_train_state(cfg, 0, device="cpu")
    sh = train_state_shardings(cfg, mesh, template)
    state, step = restore_checkpoint(item["dir"], item["step"], template,
                                     sh)
    out = {"step": np.int64(step),
           "shards": _all_ranks(_shards_held(state, sh), mesh)}
    out.update({f"onto/{n}": a for n, a in leaves_with_names(
        train_state_to_numpy(state))})
    again = str(Path(item["dir"]).parent / (Path(item["dir"]).name
                                              + "-resaved"))
    save_checkpoint(again, step + 1, state)
    if rank == 0:
        alone, s1 = restore_checkpoint(again, step + 1, template)
        out["alone_step"] = np.int64(s1)
        out.update({f"alone/{n}": a for n, a in leaves_with_names(
            train_state_to_numpy(alone))})
    dist.barrier()
    return out


def _lm_serve_item(item, rank):
    cfg, mesh, rules, params, batch, sh = _lm_setup(item)
    tokens = batch["tokens"]
    B, S = tokens.shape
    gen = item["gen"]

    def serve(p, rules, put):
        cache = put(init_cache(cfg, B, S + gen, torch.float32, device="cpu"))
        prefill_fn = make_prefill_step(cfg, rules)
        decode_fn = make_decode_step(cfg, rules)
        logits, cache = prefill_fn(p, {"tokens": put(tokens)}, cache)
        first = gather_full(logits)
        tok = torch.argmax(first[:, -1, :cfg.vocab_size], -1).to(
            torch.int32)
        toks = [tok]
        for _ in range(gen):
            tok, logits, cache = decode_fn(p, {"tokens": put(tok[:, None])},
                                           cache)
            tok = gather_full(tok)
            toks.append(tok)
        return first, torch.stack(toks), gather_full(logits)

    def put(t):
        if isinstance(t, torch.Tensor):
            return place(t, batch_sharding(mesh, B, t.dim()))
        return place(t, cache_shardings(cfg, mesh, t, B))

    placed = params_from_numpy(cfg, params, shardings=sh.params)
    out = dict(zip(("mesh_prefill", "mesh_tokens", "mesh_last"),
                   serve(placed, rules, put)))
    if rank == 0:
        one = params_from_numpy(cfg, params, device="cpu")
        out.update(zip(("one_prefill", "one_tokens", "one_last"),
                       serve(one, NO_RULES, lambda t: t)))
    return out


def _rank_mesh_item(item, rank):
    size = dist.get_world_size()
    mesh = make_rank_mesh((size,), ("data",), device="cpu")
    try:
        make_rank_mesh((size + 1,), ("data",), device="cpu")
        raised = ""
    except ValueError as exc:
        raised = str(exc)
    return {"device_type": np.array(mesh.device_type),
            "shape": np.array(mesh.shape), "raised": np.array(raised)}


def _staging_item(item, rank):
    """Each staged collective on CPU tensors (the staging's arithmetic;
    on the card it takes the place of torch's own for CUDA tensors)
    against the same function of every rank's input, gathered."""
    size = dist.get_world_size()
    mesh = make_rank_mesh((size,), ("model",), device="cpu")
    t = torch.randn((2 * size, 3 * size),
                    generator=torch.Generator().manual_seed(rank))
    every = list(mesh_gather(t, mesh))
    total = every[0]
    for other in every[1:]:
        total = total + other
    tc.reset_stats()
    got, want = [], []
    for dim in (0, 1):
        got.append(tc._staged_gather(t, dim, (mesh, 0)))
        want.append(torch.cat(every, dim))
        got.append(tc._staged_reduce_scatter(t, "sum", dim, (mesh, 0)))
        want.append(total.chunk(size, dim)[rank])
    got.append(tc._staged_alltoall(t, 0, 1, mesh, 0))
    want.append(torch.cat(every, 0).chunk(size, 1)[rank])
    ok = torch.tensor([float(torch.equal(g, w)) for g, w in zip(got, want)])
    return {"equal": mesh_gather(ok, mesh),
            "staged_calls": np.int64(tc.STAGED["calls"])}


def _host_side_item(item, rank):
    """A (4, 6) leaf split over ``data`` and a replicated one through
    ``host_full`` (to every rank, then to rank 0 alone), ``mesh_max``,
    ``mesh_gather``, ``run_training``'s failure agreement and a mesh
    checkpoint's save, under a recorder of the devices of the tensors
    each ``torch.distributed`` call takes."""
    from repro_torch.dist.sharding import host_full, named
    from repro_torch.train.loop import _agreed_hook

    size = dist.get_world_size()
    mesh = make_rank_mesh((size, 1), ("data", "model"), device="cpu")
    full = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    split = place(full, named(mesh, "data", None))
    rep = place(full, replicated(mesh))
    seen = []
    saved = {n: getattr(dist, n) for n in ("all_reduce", "reduce",
                                           "all_gather")}

    def recorder(name):
        def fn(*args, **kw):
            t = args[0]
            for x in (t if isinstance(t, list) else [t]) + (
                    [args[1]] if name == "all_gather" else []):
                seen.append(x.device.type)
            return saved[name](*args, **kw)
        return fn

    for n in saved:
        setattr(dist, n, recorder(n))
    try:
        every = [host_full(split), host_full(rep)]
        to0 = [host_full(split, 0), host_full(rep, 0)]
        top = mesh_max(torch.tensor([rank]), mesh)
        both = mesh_gather(torch.tensor([rank]), mesh)
        def hook(step):
            if rank == 1:
                raise RuntimeError("injected on rank 1")

        try:
            _agreed_hook(hook, 0, mesh)
            agreed = False
        except RuntimeError:
            agreed = True
        save_checkpoint(item["dir"], 1, {"w": split})
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)
    want = tc.crossing_device(mesh)
    return {"every_equal": _all_ranks(all(torch.equal(t, full)
                                          for t in every), mesh),
            "to0_sizes": mesh_gather(torch.tensor(
                [t.numel() for t in to0]), mesh),
            "to0_equal": _all_ranks(rank != 0 or all(
                torch.equal(t, full) for t in to0), mesh),
            "max": top, "gathered": both,
            "agreed": _all_ranks(agreed, mesh),
            "devices_ok": _all_ranks(bool(seen) and all(
                d == want for d in seen), mesh),
            "calls": mesh_gather(torch.tensor([len(seen)]), mesh)}


def _moe_groups_item(item, rank):
    """Groups of 16 tokens (4 of them, 2 a rank) through the scatter
    codec, its router and experts replicated over the group split: each
    device's router and expert gradients are its own groups' part."""
    from repro_torch.models.moe import moe_mlp

    size = dist.get_world_size()
    mesh = make_rank_mesh((size,), ("data",), device="cpu")
    g = torch.Generator().manual_seed(7)
    T, D, E, F = 64, 8, 4, 16
    args = [torch.randn((T, D), generator=g),
            torch.randn((D, E), generator=g) * 0.5,
            *(torch.randn(s, generator=g) * 0.3
              for s in ((E, D, F), (E, D, F), (E, F, D)))]
    spec = [batch_sharding(mesh, T, 2)] + [None] * 4

    def run(inputs, rules):
        leaves_ = [t.detach().requires_grad_() for t in inputs]
        with on_mesh(rules):
            out, aux = moe_mlp(*leaves_, top_k=2, group_size=16,
                               rules=rules)
            loss = (out * out).sum() + aux
            grads = torch.autograd.grad(loss, leaves_)
        return [gather_full(t).detach() for t in (out, *grads)]

    placed = [place(t, sh if sh is not None else replicated(mesh))
              for t, sh in zip(args, spec)]
    got = run(placed, ShardingRules(mesh))
    want = run(args, NO_RULES)
    names = ("out", "d_x", "d_router", "d_wg", "d_wu", "d_wd")
    return {**{f"mesh_{n}": t for n, t in zip(names, got)},
            **{f"one_{n}": t for n, t in zip(names, want)}}


ITEMS = {"solve": _solve_item, "collectives": _collectives_item,
         "segmented": _segmented_item, "fault": _fault_item,
         "fake_mesh": _fake_mesh_item, "placement": _placement_item,
         "trainer": _trainer_item, "lm_step": _lm_step_item,
         "lm_codec": _lm_codec_item, "lm_loop": _lm_loop_item,
         "lm_restore": _lm_restore_item, "lm_serve": _lm_serve_item,
         "rank_mesh": _rank_mesh_item, "staging": _staging_item,
         "moe_groups": _moe_groups_item, "host_side": _host_side_item}


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

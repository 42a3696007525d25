"""The serving engine (``repro_torch.serve``) against the reference's
``repro.serve``, on the CPU.

* The twins of ``tests/test_serve.py``'s 17 test functions, on
  ``device="cpu"``: every admitted request reaches exactly one terminal
  outcome under overload, a mid-stream hot-swap drops nothing and never
  version-mixes a batch, a watchdog-tripped incremental solve leaves
  serving on the last healthy snapshot, and drift triggers a warm-start
  re-solve whose gap beats a from-scratch solve at equal epochs.
* Parity with the reference on the same seeded inputs: the engines'
  scores for the same payloads against the same snapshot (atol 1e-6,
  binary and K = 4); ``IncrementalTrainer.fit`` and one append and
  ``resolve`` (α and ŵ at atol 1e-5, the gaps at C.2's 1e-5 + 1e-6·M,
  the ledger and the ``drifted()`` answers equal); ``load_snapshot`` of
  a checkpoint the reference's ``solve_segmented`` wrote (the same
  ``w_pad`` and meta); and the serve policies over a grid, their
  ``ValueError``s included.  The reference's solves run once per module.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro import serve as rsv
from repro.core import duals as rd
from repro.data.sparse import EllMatrix as r_EllMatrix
from repro.data.sparse import dense_to_ell as r_dense_to_ell
from repro.dist import mesh as rm
from repro.resilience import solve_segmented as r_solve_segmented
from repro_torch.convert import ell_from_numpy, snapshot_from_numpy
from repro_torch.core.duals import Hinge, SquaredHinge
from repro_torch.data.sparse import EllMatrix, dense_to_ell
from repro_torch.dist import mesh as tm
from repro_torch.resilience import FaultPlan, solve_segmented
from repro_torch.serve import (
    IncrementalTrainer,
    RequestShed,
    ScoreOutcome,
    ServeEngine,
    SnapshotStore,
    load_snapshot,
    make_snapshot,
    snapshot_from_result,
)

from test_torch_solver import ATOL, _gap_atol

D = 12
CPU = "cpu"


def _ell(X, **kw):
    return dense_to_ell(X, device=CPU, **kw)


def _snap(w, version, **kw):
    return make_snapshot(w, version, device=CPU, **kw)


@pytest.fixture()
def store():
    rng = np.random.default_rng(0)
    return SnapshotStore(_snap(rng.standard_normal(D), 1))


def _engine(store, **kw):
    kw.setdefault("k_max", 6)
    kw.setdefault("max_batch", 8)
    kw.setdefault("queue_depth", 16)
    kw.setdefault("default_deadline_s", 30.0)
    return ServeEngine(store, device=CPU, **kw)


# ------------------------------------------------------ scoring ------


def test_scoring_dense_and_sparse_agree(store):
    eng = _engine(store)
    w = store.current().w_pad[:D].numpy()
    f = np.zeros(D, np.float32)
    f[2], f[7] = 1.5, -2.0
    t_dense = eng.submit(f)
    t_sparse = eng.submit(cols=[2, 7], vals=[1.5, -2.0])
    assert eng.step() == 2
    o1, o2 = t_dense.result(1.0), t_sparse.result(1.0)
    want = 1.5 * w[2] - 2.0 * w[7]
    assert isinstance(o1, ScoreOutcome) and isinstance(o2, ScoreOutcome)
    np.testing.assert_allclose([o1.score, o2.score], [want, want],
                               atol=1e-5)
    assert o1.version == o2.version == 1


@pytest.mark.parametrize("bad", [
    dict(features=np.full(D, np.nan)),                  # non-finite
    dict(features=np.ones(D + 3)),                      # shape mismatch
    dict(features=np.ones(D)),                          # nnz > k_max
    dict(cols=[0, 1], vals=[1.0]),                      # ragged payload
    dict(cols=[D], vals=[1.0]),                         # id out of range
    dict(cols=[0], vals=[np.inf]),                      # non-finite val
], ids=["nan", "shape", "kmax", "ragged", "range", "inf"])
def test_invalid_payload_shed_does_not_poison_batch(store, bad):
    eng = _engine(store)
    t_bad = eng.submit(**bad)
    t_good = eng.submit(cols=[0], vals=[1.0])
    shed = t_bad.result(0.0)  # shed at the mouth, before any step
    assert isinstance(shed, RequestShed) and shed.reason == "invalid"
    assert shed.detail
    eng.step()
    good = t_good.result(1.0)
    assert isinstance(good, ScoreOutcome)
    assert np.isfinite(good.score)


# ----------------------------------------- deadlines / backpressure --


def test_deadline_shed_deterministic(store):
    eng = _engine(store)
    t_live = eng.submit(cols=[0], vals=[1.0], deadline_s=60.0)
    t_dead = eng.submit(cols=[0], vals=[1.0], deadline_s=1e-4)
    t_pre = eng.submit(cols=[0], vals=[1.0], deadline_s=0.0)
    assert t_pre.result(0.0).reason == "deadline"  # expired at the mouth
    time.sleep(0.01)  # let t_dead expire in the queue
    assert eng.step() == 1
    assert isinstance(t_live.result(1.0), ScoreOutcome)
    shed = t_dead.result(1.0)
    assert isinstance(shed, RequestShed) and shed.reason == "deadline"
    assert eng.health()["shed"]["deadline"] == 2


def test_backpressure_shed_at_bound(store):
    eng = _engine(store, queue_depth=4)
    tickets = [eng.submit(cols=[0], vals=[1.0]) for _ in range(6)]
    assert len(eng.queue) == 4  # the bound held
    for t in tickets[4:]:
        out = t.result(0.0)
        assert isinstance(out, RequestShed)
        assert out.reason == "backpressure"
    while len(eng.queue):
        eng.step()
    for t in tickets[:4]:
        assert isinstance(t.result(1.0), ScoreOutcome)


def test_shutdown_leaves_no_request_unresolved(store):
    eng = _engine(store)
    tickets = [eng.submit(cols=[0], vals=[1.0]) for _ in range(5)]
    eng.stop(drain=False)  # no drain: leftovers shed as shutdown
    outcomes = [t.result(1.0) for t in tickets]
    assert all(o is not None for o in outcomes)
    assert {type(o) for o in outcomes} <= {ScoreOutcome, RequestShed}
    post = eng.submit(cols=[0], vals=[1.0])  # post-stop submit sheds too
    assert post.result(0.0).reason == "shutdown"


# ----------------------------------------------------- overload ------


def test_overload_flood_every_request_terminal(store):
    """A flood past queue and deadline capacity ends with every request
    carrying a terminal outcome and the queue empty."""
    eng = _engine(store, queue_depth=8, max_batch=4,
                  default_deadline_s=0.05, batch_wait_s=0.001)
    eng.start()
    tickets = []
    try:
        for _ in range(300):
            tickets.append(eng.submit(cols=[0], vals=[1.0]))
            assert len(eng.queue) <= 8
    finally:
        eng.stop()
    outcomes = [t.result(2.0) for t in tickets]
    assert len(outcomes) == 300
    served = sum(isinstance(o, ScoreOutcome) for o in outcomes)
    shed = [o for o in outcomes if isinstance(o, RequestShed)]
    assert served + len(shed) == 300
    assert served == eng.health()["served"]
    h = eng.health()
    assert h["shed_total"] == len(shed)
    assert len(shed) > 0
    for o in shed:
        assert o.reason in ("deadline", "backpressure", "shutdown")


def test_degrade_ladder_engages_under_occupancy(store):
    eng = _engine(store, queue_depth=8, max_batch=8)
    for _ in range(8):  # occupancy 1.0 → rung 2 (stale-model-only)
        eng.submit(cols=[0], vals=[1.0])
    eng.step()
    assert eng._rung == 2
    h = eng.health()
    assert h["rung_steps"][2] >= 1
    while len(eng.queue):
        eng.step()
    eng.step()  # empty queue → occupancy 0 → back to rung 0
    assert eng._rung == 0  # serve ladder is not sticky


# ----------------------------------------------------- hot swap ------


def test_publish_requires_increasing_version(store):
    with pytest.raises(ValueError, match="version must increase"):
        store.publish(_snap(np.zeros(D), 1))


def test_publish_waits_for_pinned_reader(store):
    snap = store.pin()
    new = _snap(np.ones(D), 2)
    t0 = time.monotonic()
    done = threading.Event()

    def unpin_later():
        time.sleep(0.15)
        store.unpin(snap.version)
        done.set()

    threading.Thread(target=unpin_later, daemon=True).start()
    pause = store.publish(new, grace_s=5.0)
    assert done.is_set()  # returned only after the pin drained
    assert 0.1 <= pause <= 5.0
    assert time.monotonic() - t0 < 4.0  # drained, not grace-expired
    assert store.version == 2
    assert store.pin().version == 2


def test_publish_grace_expiry_keeps_straggler_alive(store):
    snap = store.pin()
    pause = store.publish(_snap(np.ones(D), 2), grace_s=0.05)
    assert pause >= 0.05  # grace expired with the pin still held
    assert store.version == 2
    assert store.pinned(snap.version) == 1  # straggler still valid
    store.unpin(snap.version)


def test_hot_swap_zero_drop_and_post_swap_version(store):
    """Mid-stream swap: no request is dropped, no outcome carries a
    version never published, and everything scored after the swap's
    drain uses the new version."""
    eng = _engine(store, max_batch=4, queue_depth=256,
                  batch_wait_s=0.001)
    eng.start()
    tickets = []
    try:
        for i in range(100):
            tickets.append(eng.submit(cols=[0], vals=[1.0]))
            if i == 50:
                eng.publish(_snap(np.ones(D), 2))
        post_swap = [eng.submit(cols=[0], vals=[1.0]) for _ in range(10)]
    finally:
        eng.stop()
    outcomes = [t.result(2.0) for t in tickets + post_swap]
    assert all(isinstance(o, ScoreOutcome) for o in outcomes)
    assert {o.version for o in outcomes} <= {1, 2}
    for o in (t.result(0.0) for t in post_swap):
        assert o.version == 2
        np.testing.assert_allclose(o.score, 1.0, atol=1e-5)
    assert eng.health()["swaps"] == 1
    assert eng.health()["swap_pause_max_s"] >= 0.0


def test_concurrent_producers_and_publishes_stress(store):
    """More producer threads than cores submit while another thread
    publishes, with the interpreter switching threads every 10 µs: every
    request reaches one terminal outcome, served + shed = submitted, the
    metrics count the same, and no batch mixes versions (each batch's
    rids recorded at ``take``)."""
    eng = _engine(store, max_batch=4, queue_depth=32, batch_wait_s=0.0005,
                  default_deadline_s=5.0)
    batches, take = [], eng.queue.take

    def recording_take(*a, **k):
        live, expired = take(*a, **k)
        if live:
            batches.append([r.rid for r in live])
        return live, expired

    eng.queue.take = recording_take
    n_threads, per = 2 * (os.cpu_count() or 1) + 2, 40
    tickets = [[] for _ in range(n_threads)]

    def produce(i):
        for j in range(per):
            tickets[i].append(eng.submit(cols=[j % D], vals=[1.0]))

    def publish():
        for v in range(2, 7):
            eng.publish(_snap(np.full(D, float(v)), v))
            time.sleep(0.002)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    eng.start()
    try:
        threads = [threading.Thread(target=produce, args=(i,))
                   for i in range(n_threads)]
        threads.append(threading.Thread(target=publish))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        eng.stop()
        sys.setswitchinterval(old)
    outs = [t.result(5.0) for ts in tickets for t in ts]
    served = [o for o in outs if isinstance(o, ScoreOutcome)]
    shed = [o for o in outs if isinstance(o, RequestShed)]
    assert len(served) + len(shed) == n_threads * per
    h = eng.health()
    assert h["served"] == len(served) and h["shed_total"] == len(shed)
    assert h["swaps"] == 5 and store.version == 6
    by_rid = {o.rid: o for o in served}
    assert sum(len(b) for b in batches) == len(served)
    for b in batches:
        assert len({by_rid[r].version for r in b}) == 1
    for o in served:  # version v ≥ 2 publishes w = v everywhere
        if o.version > 1:
            assert o.score == pytest.approx(float(o.version), abs=1e-6)


# ------------------------------------- trainer / drift / watchdog ----


def _labeled_stream(rng, n, wstar, flip=False):
    X = rng.standard_normal((n, D)).astype(np.float32)
    y = np.where(X @ wstar > 0, 1.0, -1.0).astype(np.float32)
    return X, (-y if flip else y)


def _trainer(X0, **kw):
    kw.setdefault("epochs", 4)
    kw.setdefault("min_new_rows", 4)
    kw.setdefault("backoff_s", 0.001)
    solver = kw.pop("solver_kwargs", {})
    solver.setdefault("block_size", 16)
    solver.setdefault("seed", 0)
    return IncrementalTrainer(X0, Hinge(C=1.0), solver_kwargs=solver,
                              device=CPU, **kw)


def test_drift_triggers_warm_start_resolve_and_swap():
    rng = np.random.default_rng(5)
    wstar = rng.standard_normal(D)
    X, y = _labeled_stream(rng, 48, wstar)
    tr = _trainer(_ell(X * y[:, None]), drift_floor=0.25)
    res0 = tr.fit()
    store = SnapshotStore(snapshot_from_result(res0, 1))
    eng = _engine(store, trainer=tr)
    Xs, ys = _labeled_stream(rng, 8, wstar)
    eng.ingest(_ell(Xs, k_max=tr.X.k_max), ys)
    assert eng.train_if_drifted() is None
    assert store.version == 1
    Xf, yf = _labeled_stream(rng, 16, wstar, flip=True)
    eng.ingest(_ell(Xf, k_max=tr.X.k_max), yf)
    res = eng.train_if_drifted()
    assert res is not None
    assert store.version == 2
    assert tr.ledger["drift_trips"] >= 1
    assert tr.X.n_rows == 48 + 8 + 16  # both chunks merged
    t = eng.submit(cols=[0], vals=[1.0])
    eng.step()
    assert t.result(1.0).version == 2


def test_warm_start_beats_scratch_at_equal_epochs():
    rng = np.random.default_rng(7)
    wstar = rng.standard_normal(D)
    X, y = _labeled_stream(rng, 64, wstar)
    tr = _trainer(_ell(X * y[:, None]), epochs=6)
    tr.fit()
    Xs, ys = _labeled_stream(rng, 16, wstar)
    tr.add_labeled(_ell(Xs, k_max=tr.X.k_max), ys)
    res_warm = tr.resolve(epochs=3)
    assert res_warm is not None
    gap_warm = float(res_warm.result.gaps[-1])
    res_scratch = solve_segmented(tr.X, Hinge(C=1.0), epochs=3,
                                  block_size=16, seed=0, record=True,
                                  device=CPU)
    gap_scratch = float(res_scratch.result.gaps[-1])
    assert gap_warm < gap_scratch


def test_watchdog_tripped_solve_keeps_last_healthy_snapshot():
    rng = np.random.default_rng(9)
    wstar = rng.standard_normal(D)
    X, y = _labeled_stream(rng, 48, wstar)
    tr = _trainer(_ell(X * y[:, None]), retries=1,
                  solver_kwargs={"max_retries": 0})
    res0 = tr.fit()
    w_before = tr.w.clone()
    n_before = tr.X.n_rows
    store = SnapshotStore(snapshot_from_result(res0, 1))
    eng = _engine(store, trainer=tr)
    Xs, ys = _labeled_stream(rng, 8, wstar)
    eng.ingest(_ell(Xs, k_max=tr.X.k_max), ys)
    tr.fault_plan = FaultPlan(nan_psum_epoch=1, persistent=True)
    assert eng.train_if_drifted(force=True) is None
    assert store.version == 1                      # nothing published
    assert tr.X.n_rows == n_before                 # no commit
    assert tr.pending_rows == 8                    # rows still pending
    assert torch.equal(tr.w, w_before)
    assert tr.ledger["gave_up"] == 1
    assert tr.ledger["diverged"] == 2              # initial + 1 retry
    t = eng.submit(cols=[0], vals=[1.0])           # still serving
    eng.step()
    assert t.result(1.0).version == 1


def test_transient_fault_recovers_via_retry_backoff():
    rng = np.random.default_rng(11)
    wstar = rng.standard_normal(D)
    X, y = _labeled_stream(rng, 48, wstar)
    tr = _trainer(_ell(X * y[:, None]), retries=2,
                  solver_kwargs={"max_retries": 0},
                  fault_plan=FaultPlan(nan_psum_epoch=1))
    res = tr.fit()  # attempt 0 trips; retry disarms the transient plan
    assert res is not None
    assert tr.ledger["diverged"] == 1
    assert tr.ledger["retries"] == 1
    assert tr.ledger["solves"] == 1


def test_train_blocked_at_rung_2():
    rng = np.random.default_rng(13)
    wstar = rng.standard_normal(D)
    X, y = _labeled_stream(rng, 48, wstar)
    tr = _trainer(_ell(X * y[:, None]))
    res0 = tr.fit()
    store = SnapshotStore(snapshot_from_result(res0, 1))
    eng = _engine(store, trainer=tr, queue_depth=8, max_batch=8)
    Xf, yf = _labeled_stream(rng, 16, wstar, flip=True)
    eng.ingest(_ell(Xf, k_max=tr.X.k_max), yf)
    for _ in range(8):
        eng.submit(cols=[0], vals=[1.0])
    eng._rung = 2  # saturated queue put the ladder at stale-model-only
    assert eng.train_if_drifted() is None
    assert store.version == 1


# ------------------------------------------------ checkpoint boot ----


def test_load_snapshot_from_checkpoint(tmp_path, tiny_dense):
    X = torch.tensor(np.asarray(tiny_dense)[:48])
    res = solve_segmented(X, Hinge(C=1.0), epochs=4, checkpoint_every=2,
                          ckpt_dir=str(tmp_path), block_size=16, seed=0,
                          device=CPU)
    snap = load_snapshot(str(tmp_path), version=1, device=CPU)
    assert snap.version == 1
    assert snap.meta["ckpt_step"] == 4
    np.testing.assert_allclose(snap.w_pad[:X.shape[1]].numpy(),
                               res.result.w_hat.numpy(), atol=1e-6)
    assert snap.alpha is not None
    store = SnapshotStore(snap)
    eng = ServeEngine(store, k_max=4, max_batch=4, queue_depth=8,
                      device=CPU)
    t = eng.submit(cols=[0], vals=[1.0])
    eng.step()
    assert isinstance(t.result(1.0), ScoreOutcome)


# =========================================== parity with repro.serve ===


def _payloads(rng, n, d, kmax):
    """Seeded sparse payloads of 1..kmax entries, some with repeated
    columns."""
    out = []
    for i in range(n):
        k = int(rng.integers(1, kmax + 1))
        cols = rng.integers(0, d, size=k)
        out.append((cols.astype(np.int64),
                    rng.standard_normal(k).astype(np.float32)))
    return out


@pytest.mark.parametrize("K", [0, 4])
def test_scores_match_reference_engine(K):
    """The same payloads through both engines against the same snapshot
    (the reference's, carried over by ``snapshot_from_numpy``): every
    score, label and margin at atol 1e-6, over three batches (the last
    partial) and a dense payload."""
    rng = np.random.default_rng(21 + K)
    d, kmax = 40, 7
    w = rng.standard_normal((K, d) if K else d).astype(np.float32)
    r_snap = rsv.make_snapshot(w, 3)
    p_snap = snapshot_from_numpy(r_snap, device=CPU)
    assert p_snap.n_classes == r_snap.n_classes == K
    np.testing.assert_array_equal(p_snap.w_pad.numpy(), r_snap.w_pad)
    kw = dict(k_max=kmax, max_batch=8, queue_depth=64,
              default_deadline_s=30.0)
    r_eng = rsv.ServeEngine(rsv.SnapshotStore(r_snap), **kw)
    p_eng = ServeEngine(SnapshotStore(p_snap), device=CPU, **kw)
    pays = _payloads(rng, 20, d, kmax)
    dense = np.zeros(d, np.float32)
    dense[[1, 5, 33]] = [0.5, -2.0, 3.0]
    r_t = [r_eng.submit(cols=c, vals=v) for c, v in pays]
    r_t.append(r_eng.submit(dense))
    p_t = [p_eng.submit(cols=c, vals=v) for c, v in pays]
    p_t.append(p_eng.submit(dense))
    while len(r_eng.queue):
        r_eng.step()
    while len(p_eng.queue):
        p_eng.step()
    for a, b in zip(p_t, r_t):
        pa, rb = a.result(1.0), b.result(1.0)
        assert isinstance(pa, ScoreOutcome) and isinstance(
            rb, rsv.ScoreOutcome)
        assert pa.rid == rb.rid and pa.version == rb.version == 3
        np.testing.assert_allclose(pa.score, rb.score, rtol=0, atol=1e-6)
        assert pa.label == rb.label
        assert len(pa.margins) == len(rb.margins) == K
        np.testing.assert_allclose(pa.margins, rb.margins, rtol=0,
                                   atol=1e-6)
    assert p_eng.health()["batches"] == r_eng.health()["batches"] == 3


def _mt_rows(rng, n, d, k):
    idx = np.stack([rng.choice(d, size=k, replace=False)
                    for _ in range(n)]).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    return idx, val


def _trainer_case(K):
    """The seeded inputs of one trainer parity case: initial rows and
    labels (or ids), a drift-free chunk and a drifted chunk."""
    rng = np.random.default_rng(31 + K)
    d, kmax = 16, 5
    if not K:
        wstar = rng.standard_normal(d)
        X = rng.standard_normal((64, d)).astype(np.float32)
        y = np.where(X @ wstar > 0, 1.0, -1.0).astype(np.float32)
        Xs = rng.standard_normal((8, d)).astype(np.float32)
        ys = np.where(Xs @ wstar > 0, 1.0, -1.0).astype(np.float32)
        Xf = rng.standard_normal((16, d)).astype(np.float32)
        yf = -np.where(Xf @ wstar > 0, 1.0, -1.0).astype(np.float32)
        return dict(X0=X * y[:, None], chunks=[(Xs, ys), (Xf, yf)])
    W = rng.normal(size=(K, d + 1)).astype(np.float32)
    W[:, d] = 0.0

    def ids(idx, val):
        return (W[:, idx] * val[None]).sum(-1).argmax(0).astype(np.int32)

    X0 = _mt_rows(rng, 64, d, kmax)
    ok = _mt_rows(rng, 8, d, kmax)
    bad = _mt_rows(rng, 16, d, kmax)
    return dict(X0=X0, y0=ids(*X0), d=d,
                chunks=[(ok, ids(*ok)), (bad, (ids(*bad) + 1) % K)])


def _run_trainer(pkg, K):
    """fit, ingest a drift-free chunk (drifted?), ingest a drifted chunk
    (drifted?), resolve — in ``pkg`` ("ref" or "port")."""
    c = _trainer_case(K)
    ref = pkg == "ref"
    loss = (rd.SquaredHinge(C=1.0) if ref else SquaredHinge(C=1.0)) if K \
        else (rd.Hinge(C=1.0) if ref else Hinge(C=1.0))
    kw = dict(epochs=3, drift_floor=0.1, min_new_rows=4, backoff_s=0.001,
              solver_kwargs=dict(block_size=8, seed=3))
    if K:
        kw.update(n_classes=K, y0=c["y0"])
    if not ref:
        kw["device"] = CPU

    def ell(X, k_max=None):
        if K:
            idx, val = X
            return (r_EllMatrix(idx, val, c["d"]) if ref
                    else ell_from_numpy(idx, val, c["d"], device=CPU))
        return (r_dense_to_ell(X, k_max=k_max) if ref
                else dense_to_ell(X, k_max=k_max, device=CPU))

    Tr = rsv.IncrementalTrainer if ref else IncrementalTrainer
    tr = Tr(ell(c["X0"]), loss, **kw)
    fit = tr.fit()
    drifted = []
    for X, y in c["chunks"]:
        tr.add_labeled(ell(X, k_max=tr.X.k_max), y)
        drifted.append(tr.drifted())
    res = tr.resolve(epochs=2)
    return dict(fit=fit, res=res, tr=tr, drifted=drifted,
                err_base=tr.err_base)


@pytest.fixture(scope="module")
def ref_trainers():
    return {K: _run_trainer("ref", K) for K in (0, 4)}


@pytest.mark.parametrize("K", [0, 4])
def test_trainer_matches_reference(ref_trainers, K):
    """``fit`` and one append-and-``resolve`` against the reference's
    trainer on the same inputs: α and ŵ at atol 1e-5 after each solve,
    the gaps at 1e-5 + 1e-6·M, the ledger, the ``drifted()`` answers
    and the error baseline equal."""
    r, p = ref_trainers[K], _run_trainer("port", K)
    assert p["drifted"] == r["drifted"]
    assert r["drifted"][-1]
    assert p["tr"].ledger == r["tr"].ledger
    assert p["err_base"] == pytest.approx(r["err_base"], abs=1e-12)
    assert p["tr"].X.n_rows == r["tr"].X.n_rows == 64 + 8 + 16
    np.testing.assert_array_equal(p["tr"].X.indices.numpy(),
                                  np.asarray(r["tr"].X.indices))
    np.testing.assert_array_equal(p["tr"].X.values.numpy(),
                                  np.asarray(r["tr"].X.values))
    if K:
        np.testing.assert_array_equal(p["tr"].y_ids.numpy(),
                                      r["tr"].y_ids)
    for key in ("fit", "res"):
        pr, rr = p[key].result, r[key].result
        np.testing.assert_allclose(pr.alpha.numpy(), np.asarray(rr.alpha),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(pr.w_hat.numpy(), np.asarray(rr.w_hat),
                                   rtol=0, atol=ATOL)
        if K:
            continue  # the multi-task gaps: below, class by class
        Xp = p["tr"].X if key == "res" else EllMatrix(
            p["tr"].X.indices[:64], p["tr"].X.values[:64],
            p["tr"].X.n_features)
        tol = _gap_atol(Xp, pr.alpha, Hinge(C=1.0))
        np.testing.assert_allclose(pr.gaps.numpy(), np.asarray(rr.gaps),
                                   rtol=0, atol=tol)
    if K:
        # each task's gap on the rows it folds, at its own tolerance
        pr, rr = p["res"].result, r["res"].result
        X = p["tr"].X
        ids = p["tr"].y_ids.long()
        for k in range(K):
            yk = torch.where(ids == k, 1.0, -1.0)
            Xk = EllMatrix(X.indices, X.values * yk[:, None], X.n_features)
            tol = _gap_atol(Xk, pr.alpha[k], SquaredHinge(C=1.0))
            np.testing.assert_allclose(pr.gaps[k].numpy(),
                                       np.asarray(rr.gaps)[k], rtol=0,
                                       atol=tol)


@pytest.fixture(scope="module")
def ref_checkpoint(tmp_path_factory, tiny_dense):
    d = tmp_path_factory.mktemp("ref_serve_ckpt")
    X = np.asarray(tiny_dense)[:48]
    r_solve_segmented(X, rd.Hinge(C=1.0), epochs=4, checkpoint_every=2,
                      ckpt_dir=str(d), block_size=16, seed=0)
    return str(d)


def test_load_snapshot_of_reference_checkpoint(ref_checkpoint):
    """The port boots from a checkpoint the reference wrote: the same
    ``w_pad``, α and meta as the reference's own ``load_snapshot``."""
    r = rsv.load_snapshot(ref_checkpoint, version=2)
    p = load_snapshot(ref_checkpoint, version=2, device=CPU)
    np.testing.assert_array_equal(p.w_pad.numpy(), r.w_pad)
    np.testing.assert_array_equal(p.alpha.numpy(), r.alpha)
    assert (p.version, p.d, p.meta) == (r.version, r.d, r.meta)
    assert p.meta == {"ckpt_step": 4}


# ----------------------------------------------------- the policies ---


@pytest.mark.parametrize("prev", [0, 1, 2])
def test_serve_rung_matches_reference(prev):
    for occ in np.linspace(0.0, 1.0, 41):
        for up, down in (((0.5, 0.85), (0.2, 0.6)),
                         ((0.3, 0.6), (0.1, 0.4))):
            assert (tm.serve_rung(occ, prev, up=up, down=down)
                    == rm.serve_rung(occ, prev, up=up, down=down))


@pytest.mark.parametrize("prev", [-1, 3])
def test_serve_rung_rejects_like_reference(prev):
    with pytest.raises(ValueError, match="out of range"):
        rm.serve_rung(0.5, prev)
    with pytest.raises(ValueError, match="out of range"):
        tm.serve_rung(0.5, prev)


@pytest.mark.parametrize("rung", [-2, 0, 1, 2, 5])
def test_serve_degrade_ladder_matches_reference(rung):
    for batch in (1, 3, 4, 64, 1024):
        assert (tm.serve_degrade_ladder(rung, max_batch=batch)
                == rm.serve_degrade_ladder(rung, max_batch=batch))
    for mod in (rm, tm):
        with pytest.raises(ValueError, match="max_batch"):
            mod.serve_degrade_ladder(rung, max_batch=0)


ADMISSION = dict(queue_depth=8, max_batch=4, deadline_s=0.5,
                 swap_grace_s=0.1)


@pytest.mark.parametrize("knob,bad", [
    (None, None), ("queue_depth", 0), ("max_batch", -1),
    ("deadline_s", 0.0), ("deadline_s", float("nan")),
    ("swap_grace_s", -0.5)])
def test_serve_admission_policy_matches_reference(knob, bad):
    kw = dict(ADMISSION)
    if knob is None:
        kw.update(queue_depth=7.0, swap_grace_s=0)
        assert (tm.serve_admission_policy(**kw)
                == rm.serve_admission_policy(**kw))
        return
    kw[knob] = bad
    for mod in (rm, tm):
        with pytest.raises(ValueError, match=knob):
            mod.serve_admission_policy(**kw)


@pytest.mark.parametrize("ratio,floor", [(2.0, 0.05), (1.0, 0.0),
                                         (3.0, 0.25)])
def test_drift_trip_matches_reference(ratio, floor):
    vals = np.array([0.0, 0.01, 0.05, 0.1, 0.125, 0.25, 0.3, 0.5, 1.0,
                     np.nan, np.inf], np.float32)
    base, new = (g.reshape(-1) for g in np.meshgrid(vals, vals))
    ref = np.asarray(rm.drift_trip(base, new, ratio=ratio, floor=floor))
    got = tm.drift_trip(torch.from_numpy(base), torch.from_numpy(new),
                        ratio=ratio, floor=floor)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    one = tm.drift_trip(np.float32(0.1), np.float32(0.4), ratio=ratio,
                        floor=floor)
    assert one.dim() == 0 and one.dtype == torch.int32
    assert int(one) == int(rm.drift_trip(np.float32(0.1), np.float32(0.4),
                                         ratio=ratio, floor=floor))


def test_engine_rejects_a_snapshot_on_another_device():
    """A publish of a snapshot whose ``w_pad`` lies elsewhere raises and
    leaves the store as it was."""
    store = SnapshotStore(_snap(np.ones(D), 1))
    eng = _engine(store)
    other = make_snapshot(np.ones(D), 2, device="meta")
    with pytest.raises(ValueError, match="lies on"):
        eng.publish(other)
    assert store.version == 1
    with pytest.raises(ValueError, match="lies on"):
        ServeEngine(SnapshotStore(other), k_max=2, device=CPU)

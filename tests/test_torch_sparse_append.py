"""The streaming ELL row append (``repro_torch.data.sparse``:
``ell_row_nnz``, ``ell_repack``, ``ell_append``, ``ell_from_rows``)
against the reference's helpers, and the solves it feeds.

The twins of ``tests/test_sparse_append.py``: the append is a lossless
layout operation (``ell_append`` then ``to_dense`` is the dense vstack,
for ragged operands and any widened ``k_max``), lossy re-packs raise,
the feature mismatch raises, ``ell_from_rows`` packs and checks rows,
an appended matrix and the same rows packed fresh are the same solver
input, and a short ``alpha0`` is a zero-extension.  Every helper's
indices and values are held to ``repro``'s bit for bit.  The reference's
own p > 1 masked-tail test fails on the installed jax (ROADMAP C.4), so
the port's appended solve at p = 8 (103 = 90 + 13 rows) is held to the
reference's solve of the same rows in the test child
(``test_torch_shards.reference_solves``, its ``_finalize`` fetched to
the host).  Last, the twins of the three serving tests of
``tests/test_multitask.py``: the (K, d) snapshot scored in one
dispatch, the binary outcome's shape, and the multi-class trainer's
validation.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.data import sparse as rsp
from repro.data import make_dataset
from repro_torch.convert import ell_from_numpy
from repro_torch.core import duals as td
from repro_torch.core.sharded import sharded_passcode_solve
from repro_torch.data.sparse import (
    EllMatrix,
    dense_to_ell,
    ell_append,
    ell_from_rows,
    ell_repack,
    ell_row_nnz,
)
from repro_torch.dist.mesh import solver_mesh

from test_torch_shards import case, reference_solves
from test_torch_solver import ATOL, _gap_atol

CPU = "cpu"


def _ragged(rng, n, d, density):
    X = rng.standard_normal((n, d)).astype(np.float32)
    X[rng.random((n, d)) > density] = 0.0
    return X


def _same(port, ref):
    """A port ``EllMatrix`` against a reference one, bit for bit."""
    assert port.n_features == ref.n_features
    assert port.indices.dtype == torch.int32
    assert port.values.dtype == torch.float32
    np.testing.assert_array_equal(port.indices.numpy(),
                                  np.asarray(ref.indices))
    np.testing.assert_array_equal(port.values.numpy(),
                                  np.asarray(ref.values))


def _both(X, k_max=None):
    return (dense_to_ell(X, k_max, device=CPU), rsp.dense_to_ell(X, k_max))


def _shuffled(ell, rng):
    """The same rows with the padding moved among the real entries (the
    within-row order of the real entries kept): what the compaction
    must undo."""
    idx = ell.indices.numpy().copy()
    val = ell.values.numpy().copy()
    d = ell.n_features
    for i in range(idx.shape[0]):
        real = idx[i] < d
        pos = np.sort(rng.choice(idx.shape[1], int(real.sum()),
                                 replace=False))
        ni, nv = np.full_like(idx[i], d), np.zeros_like(val[i])
        ni[pos], nv[pos] = idx[i][real], val[i][real]
        idx[i], val[i] = ni, nv
    return idx, val


@settings(max_examples=25, deadline=None)
@given(
    n1=st.integers(1, 12), n2=st.integers(1, 12),
    d=st.integers(2, 16), seed=st.integers(0, 2**31 - 1),
    pad=st.integers(0, 3),
)
def test_append_round_trip(n1, n2, d, seed, pad):
    rng = np.random.default_rng(seed)
    A = _ragged(rng, n1, d, 0.5)
    B = _ragged(rng, n2, d, 0.3)
    (a, ra), (b, rb) = _both(A), _both(B)
    k = max(a.k_max, b.k_max) + pad
    out = ell_append(a, b, k_max=k)
    _same(out, rsp.ell_append(ra, rb, k_max=k))
    assert out.k_max == k
    np.testing.assert_array_equal(out.to_dense().numpy(), np.vstack([A, B]))
    idx, val = out.indices.numpy(), out.values.numpy()
    np.testing.assert_array_equal(val[idx == d], 0.0)
    nnz = ell_row_nnz(out)
    assert nnz.device == out.device
    np.testing.assert_array_equal(nnz.numpy(), rsp.ell_row_nnz(
        rsp.ell_append(ra, rb, k_max=k)))
    np.testing.assert_array_equal(
        nnz.numpy(), np.concatenate([(A != 0).sum(1), (B != 0).sum(1)]))
    # the padding scattered among the entries: the stable compaction
    # gives the reference's bits
    si, sv = _shuffled(a, rng)
    _same(ell_repack(EllMatrix(torch.from_numpy(si), torch.from_numpy(sv),
                               d), k),
          rsp.ell_repack(rsp.EllMatrix(si, sv, d), k))


def test_repack_lossy_rejection_parity():
    """Shrinking ``k_max`` below a row's nnz raises with
    ``dense_to_ell``'s message — never a silent truncation — and
    widening then narrowing back to the need is lossless."""
    rng = np.random.default_rng(0)
    X = _ragged(rng, 8, 16, 0.6)
    need = int((X != 0).sum(1).max())
    x, rx = _both(X)
    for fn in (lambda: ell_repack(x, need - 1),
               lambda: dense_to_ell(X, k_max=need - 1, device=CPU),
               lambda: ell_append(x, x, k_max=need - 1),
               lambda: rsp.ell_repack(rx, need - 1)):
        with pytest.raises(ValueError, match="max per-row nnz"):
            fn()
    wide = ell_repack(x, need + 5)
    _same(wide, rsp.ell_repack(rx, need + 5))
    back = ell_repack(wide, need)
    _same(back, rsp.ell_repack(rsp.ell_repack(rx, need + 5), need))
    np.testing.assert_array_equal(back.to_dense().numpy(), X)


def test_append_feature_mismatch_raises():
    a = dense_to_ell(np.eye(4, dtype=np.float32), device=CPU)
    b = dense_to_ell(np.eye(5, dtype=np.float32), device=CPU)
    with pytest.raises(ValueError, match="n_features"):
        ell_append(a, b)


def test_ell_from_rows():
    rows = [([0, 3], [1.0, 2.0]), ([], []), ([2], [-1.0])]
    m = ell_from_rows(rows, 5, device=CPU)
    _same(m, rsp.ell_from_rows(rows, 5))
    _same(ell_from_rows(rows, 5, k_max=4, device=CPU),
          rsp.ell_from_rows(rows, 5, k_max=4))
    want = np.zeros((3, 5), np.float32)
    want[0, 0], want[0, 3], want[2, 2] = 1.0, 2.0, -1.0
    np.testing.assert_array_equal(m.to_dense().numpy(), want)
    bad = [([([5], [1.0])], {}, "out of range"),
           ([([0, 1], [1.0])], {}, "ids vs"),
           ([([0, 1], [1.0, 2.0])], {"k_max": 1}, "max per-row nnz")]
    for rows, kw, match in bad:
        with pytest.raises(ValueError, match=match):
            ell_from_rows(rows, 5, device=CPU, **kw)
        with pytest.raises(ValueError, match=match):
            rsp.ell_from_rows(rows, 5, **kw)


def test_append_solve_matches_fresh_pack(tiny_dense):
    """An appended matrix and the same rows packed fresh are the same
    solver input: the same layout as the reference's append, and the
    same solve bit for bit."""
    X = np.asarray(tiny_dense)[:40]
    app = ell_append(dense_to_ell(X[:28], device=CPU),
                     dense_to_ell(X[28:], device=CPU))
    _same(app, rsp.ell_append(rsp.dense_to_ell(X[:28]),
                              rsp.dense_to_ell(X[28:])))
    fresh = dense_to_ell(X, k_max=app.k_max, device=CPU)
    assert torch.equal(app.indices, fresh.indices)
    kw = dict(epochs=2, block_size=8, seed=0, record=False, device=CPU)
    ra = sharded_passcode_solve(app, td.Hinge(1.0), **kw)
    rf = sharded_passcode_solve(fresh, td.Hinge(1.0), **kw)
    assert torch.equal(ra.alpha, rf.alpha)
    assert torch.equal(ra.w_hat, rf.w_hat)


def test_short_alpha0_warm_start_matches_zero_extended(tiny_dense):
    """A carried ``alpha0`` shorter than n (the streaming append's warm
    start) is exactly a zero-extension: appended rows enter at α = 0."""
    X = np.asarray(tiny_dense)[:40]
    hinge = td.Hinge(1.0)
    kw = dict(epochs=2, block_size=8, seed=0, record=False, device=CPU)
    r0 = sharded_passcode_solve(dense_to_ell(X[:32], device=CPU), hinge,
                                **kw)
    a_ext = torch.cat([r0.alpha, torch.zeros(8)])
    ell = dense_to_ell(X, device=CPU)
    r1 = sharded_passcode_solve(ell, hinge, alpha0=r0.alpha, w0=r0.w_hat,
                                **kw)
    r2 = sharded_passcode_solve(ell, hinge, alpha0=a_ext, w0=r0.w_hat,
                                **kw)
    assert torch.equal(r1.alpha, r2.alpha)
    assert torch.equal(r1.w_hat, r2.w_hat)


TAIL = case(rows=103, p=8, epochs=3, block_size=8, seed=0)


@pytest.fixture(scope="module")
def ref_tail(tmp_path_factory):
    return reference_solves({"tail": TAIL},
                            tmp_path_factory.mktemp("ref_append"))["tail"]


def test_append_tail_p8_matches_reference(ref_tail):
    """p = 8 over 103 = 90 + 13 rows (103 % 8 ≠ 0: the masked tail):
    the port's solve of the appended matrix equals its solve of the
    fresh pack bit for bit, and the reference's solve of the same rows
    on 8 devices at atol 1e-5 (the gaps at 1e-5 + 1e-6·M); the tail
    rows train."""
    X = make_dataset("tiny").X_train
    idx, val = np.asarray(X.indices)[:103], np.asarray(X.values)[:103]
    d = X.n_features
    head = ell_from_numpy(idx[:90], val[:90], d, device=CPU)
    app = ell_append(head, ell_from_numpy(idx[90:], val[90:], d,
                                          device=CPU))
    _same(app, rsp.ell_append(rsp.EllMatrix(idx[:90], val[:90], d),
                              rsp.EllMatrix(idx[90:], val[90:], d)))
    fresh = ell_from_numpy(idx, val, d, device=CPU)
    kw = dict(mesh=solver_mesh(n_devices=8), device=CPU, **TAIL["kw"])
    ra = sharded_passcode_solve(app, td.Hinge(1.0), **kw)
    rf = sharded_passcode_solve(fresh, td.Hinge(1.0), **kw)
    assert ra.alpha.shape == (103,)
    assert float(ra.alpha[96:].abs().sum()) > 0  # the tail trained
    assert torch.equal(ra.alpha, rf.alpha) and torch.equal(ra.w_hat,
                                                           rf.w_hat)
    np.testing.assert_allclose(ra.alpha.numpy(), ref_tail["alpha"],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(ra.w_hat.numpy(), ref_tail["w_hat"],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(ra.gaps.numpy(), ref_tail["gaps"], rtol=0,
                               atol=_gap_atol(app, ra.alpha, td.Hinge(1.0)))


# ============================================ multi-class serving ======


def _ell_rows(rng, n, d, k):
    idx = np.stack([rng.choice(d, size=k, replace=False)
                    for _ in range(n)]).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    return ell_from_numpy(idx, val, d, device=CPU)


def test_serve_multiclass_end_to_end():
    """(K, d) snapshot stack → one dispatch scores all heads; the outcome
    carries the argmax label and every head's margin; the incremental
    trainer warm-starts the (K, n) dual carry across an append."""
    from repro_torch.serve import (
        IncrementalTrainer,
        ScoreOutcome,
        ServeEngine,
        SnapshotStore,
        snapshot_from_result,
    )

    rng = np.random.default_rng(0)
    K, n, d, kmax = 4, 64, 16, 5
    X0 = _ell_rows(rng, n, d, kmax)
    W_true = rng.normal(size=(K, d)).astype(np.float32)
    wp = np.zeros((K, d + 1), np.float32)
    wp[:, :d] = W_true
    idx0, val0 = X0.indices.numpy(), X0.values.numpy()
    y0 = (wp[:, idx0] * val0[None]).sum(-1).argmax(0).astype(np.int32)

    tr = IncrementalTrainer(X0, td.SquaredHinge(C=1.0), n_classes=K, y0=y0,
                            epochs=5, device=CPU)
    res = tr.fit()
    assert res is not None
    assert tr.alpha.shape == (K, n) and tr.w.shape == (K, d)

    snap = snapshot_from_result(res, 1)
    assert snap.w_pad.shape == (K, d + 1) and snap.n_classes == K
    eng = ServeEngine(SnapshotStore(snap), k_max=kmax, trainer=tr,
                      device=CPU)
    tickets = [eng.submit(cols=idx0[i], vals=val0[i]) for i in range(8)]
    eng.step()
    w = tr.w.numpy()
    for i, t in enumerate(tickets):
        out = t.result(5.0)
        assert isinstance(out, ScoreOutcome)
        assert len(out.margins) == K
        assert out.label == int(np.argmax(out.margins))
        ref = (w[:, idx0[i]] * val0[i]).sum(-1)
        np.testing.assert_allclose(np.asarray(out.margins), ref,
                                   rtol=1e-5, atol=1e-5)

    Xn = _ell_rows(rng, 24, d, kmax)
    idxn, valn = Xn.indices.numpy(), Xn.values.numpy()
    yn = (wp[:, idxn] * valn[None]).sum(-1).argmax(0).astype(np.int32)
    tr.add_labeled(Xn, yn)
    res2 = tr.resolve()
    assert res2 is not None
    assert tr.alpha.shape == (K, n + 24) and tr.w.shape == (K, d)
    eng.publish(snapshot_from_result(res2, 2))
    t = eng.submit(cols=idxn[0], vals=valn[0])
    eng.step()
    assert t.result(5.0).version == 2
    eng.stop()


def test_serve_binary_outcome_unchanged():
    """A binary snapshot keeps the binary outcome: label −1, no margins,
    a scalar score."""
    from repro_torch.serve import ServeEngine, SnapshotStore, make_snapshot

    w = np.arange(6, dtype=np.float32)
    snap = make_snapshot(w, 1, device=CPU)
    assert snap.w_pad.shape == (7,) and snap.n_classes == 0
    eng = ServeEngine(SnapshotStore(snap), k_max=3, device=CPU)
    t = eng.submit(cols=[1, 4], vals=[2.0, 0.5])
    eng.step()
    out = t.result(5.0)
    assert out.label == -1 and out.margins == ()
    assert out.score == pytest.approx(1.0 * 2.0 + 4.0 * 0.5)
    eng.stop()


def test_trainer_multiclass_validation():
    from repro_torch.serve import IncrementalTrainer

    rng = np.random.default_rng(1)
    X0 = _ell_rows(rng, 16, 8, 3)
    hinge = td.Hinge(C=1.0)
    with pytest.raises(ValueError):  # ids required for multiclass
        IncrementalTrainer(X0, hinge, n_classes=3, device=CPU)
    with pytest.raises(ValueError):  # K=1 is not a multiclass problem
        IncrementalTrainer(X0, hinge, n_classes=1,
                           y0=np.zeros(16, np.int32), device=CPU)
    with pytest.raises(ValueError):  # ids out of range
        IncrementalTrainer(X0, hinge, n_classes=3,
                           y0=np.full(16, 3, np.int32), device=CPU)
    with pytest.raises(ValueError):  # y0 meaningless for binary
        IncrementalTrainer(X0, hinge, y0=np.zeros(16, np.int32),
                           device=CPU)
    tr = IncrementalTrainer(X0, hinge, n_classes=3,
                            y0=np.zeros(16, np.int32), device=CPU)
    with pytest.raises(ValueError):  # pending ids out of range
        tr.add_labeled(_ell_rows(rng, 4, 8, 3),
                       np.asarray([0, 1, 2, 3], np.int32))

"""The 2-D solve over data > 1 shards against the reference's on p × m
fake CPU devices (the reference in one child process per module,
``test_torch_shards.reference_solves``).

Cases at data ∈ {2, 4} and model = 2: the unfused engine (the port's
"auto" on the CPU, the reference's ``use_kernel=False``), the fused one
(``use_kernel=True``: the reference's Pallas kernels in interpret mode,
the port's plain B4/B5 over the data shards), and the overlapped round
(fused with delay_rounds = 1), plus p ∤ n (n = 250 at data = 4).  The
fused plain versions over the data grid are held to p single-shard
calls.  Tolerances as ``test_torch_shards``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import duals as td
from repro_torch.core import sharded as ts
from repro_torch.dist.mesh import solver_mesh_2d
from repro_torch.kernels import dcd_feature as feat
from repro_torch.kernels import ops

from test_torch_shards import case, reference_solves
from test_torch_shards import EPOCHS, SEED, assert_matches, port_X, tiny  # noqa: F401

B = 16
ENGINES = {"unfused": dict(use_kernel=False), "fused": dict(use_kernel=True),
           "overlap": dict(use_kernel=True, delay_rounds=1)}
CASES = {}
for _p, _loss_of in [(2, ("hinge", "squared_hinge", "logistic")),
                     (4, ("logistic", "hinge", "squared_hinge"))]:
    for (_eng, _kw), _loss in zip(ENGINES.items(), _loss_of):
        CASES[f"p{_p}-{_eng}-{_loss}"] = case(
            loss=_loss, p=_p, model=2, epochs=EPOCHS, block_size=B,
            seed=SEED, **_kw)
CASES["p2-unfused-delay"] = case(p=2, model=2, epochs=EPOCHS, block_size=B,
                                 seed=SEED, use_kernel=False, delay_rounds=1)
CASES["n250-p4-fused"] = case(rows=250, p=4, model=2, epochs=EPOCHS,
                              block_size=B, seed=SEED, use_kernel=True)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_solves(CASES, tmp_path_factory.mktemp("ref_shards2d"))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_2d_matches_reference(ref, tiny, name):
    c = CASES[name]
    Xp = port_X(tiny, c["rows"], False)
    loss = td.make_loss(c["loss"])
    kw = dict(c["kw"])
    if not kw["use_kernel"]:
        kw["use_kernel"] = "auto"  # the unfused engine on the CPU
    mesh = solver_mesh_2d(data=c["p"], model=c["model"])
    setup = ts.prepare_solver(Xp, loss, mesh=mesh, device="cpu",
                              **{k: v for k, v in kw.items()
                                 if k != "epochs"})
    assert (setup.p, setup.m, setup.fused) == (c["p"], 2,
                                               kw["use_kernel"] is True)
    assert setup.overlap == (kw["use_kernel"] is True
                             and kw.get("delay_rounds", 0) == 1)
    res = ts.sharded_passcode_solve(Xp, loss, mesh=mesh, device="cpu", **kw)
    assert_matches(res, ref[name], Xp, loss)


def test_data_grid_plain_b4_b5_are_p_single_calls(tiny):
    """B4's and B5's plain versions over a data grid, and the ops phases
    over it, equal p single-shard calls against each shard's own w."""
    from repro_torch.data.sparse import ell_column_split
    idx_np, val, d, _ = tiny
    Xp = port_X(tiny, 256, False)
    fse = ell_column_split(Xp, 2)
    cols, vals, q = fse.indices, fse.values, fse.row_sq_norms()
    p, n_loc, Bk, d1 = 2, 128, 8, fse.d_loc + 1
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, n_loc, (p, Bk)).astype(np.int32))
    w = torch.from_numpy((rng.standard_normal((p, 2, d1)) * 0.05)
                         .astype(np.float32))
    w[..., -1] = 0.0
    alpha = torch.zeros(256)
    base_p, gram_p = feat.dcd_feature_gram_plain(cols, vals, w, ids, n_loc)
    base, gram = ops.dcd_feature_gram(cols, vals, w, ids, n_loc=n_loc)
    corr = ops.dcd_feature_base_correction(cols, vals, w[0], ids, n_loc)
    a_all, w_all = feat.dcd_feature_update_plain(
        cols, vals, alpha, q, w, ids, base, gram, loss=td.Hinge(),
        n_loc=n_loc)
    a = alpha
    for s in range(p):
        gid = ids[s] + s * n_loc
        b1, g1 = feat.dcd_feature_gram_plain(cols, vals, w[s], gid)
        assert torch.equal(base_p[s], b1) and torch.equal(gram_p[s], g1)
        assert torch.equal(base[s], b1.sum(0))
        assert torch.equal(corr[s], ops.dcd_feature_base_correction(
            cols, vals, w[0], gid))
        a, w1 = feat.dcd_feature_update_plain(
            cols, vals, a, q, w[s], gid, b1.sum(0), g1.sum(0),
            loss=td.Hinge())
        assert torch.equal(w_all[s], w1)
    assert torch.equal(a_all, a)

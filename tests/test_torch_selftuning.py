"""The self-tuning solve — shrinking, repacking and the adaptive delay —
against the reference's, on the 1-D mesh at p = 4 and the 2-D mesh at
data = 2, model = 2 (the reference on fake CPU devices in one child
process per module, ``test_torch_shards.reference_solves``), with the
policies it rests on: ``core/shrinking.py`` (``active_mask``,
``dcd_solve_shrink``), ``active_row_remap``, ``adaptive_delay_policy``
and ``resolve_self_tuning``.

α and ŵ at atol 1e-5, the gap and ‖w(α) − ŵ‖ at 1e-5 + 1e-6·M
(``test_torch_solver._gap_atol``), and the per-record active fractions
and delay flags equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import duals as rd
from repro.core import shrinking as rshrink
from repro.data import make_dataset
from repro.data.sparse import active_row_remap as ref_remap
from repro.dist import mesh as rmesh
from repro_torch.core import duals as td
from repro_torch.core import shrinking as tshrink
from repro_torch.core import sharded as ts
from repro_torch.data.sparse import active_row_remap
from repro_torch.dist import mesh as tmesh

from test_torch_shards import case, reference_solves
from test_torch_shards import SEED, assert_matches, port_X, tiny  # noqa: F401
from test_torch_solver import ATOL

EPOCHS, B = 5, 16
ONE = dict(epochs=EPOCHS, block_size=B, seed=SEED)
CASES = {
    "1d-shrink": case(p=4, shrink_every=1, repack=False, **ONE),
    "1d-shrink-repack": case(p=4, shrink_every=1, repack=True, **ONE),
    "1d-dense-shrink2-sq": case(p=2, dense=True, loss="squared_hinge",
                                shrink_every=2, repack="auto",
                                repack_threshold=0.8, **ONE),
    "1d-logistic-shrink": case(p=4, loss="logistic", shrink_every=1, **ONE),
    "1d-adaptive-0.95": case(p=4, adaptive=True, delay_rounds=1, **ONE),
    "1d-adaptive-0.5": case(p=4, dense=True, adaptive=True, delay_rounds=1,
                            adaptive_ratio=0.5, **ONE),
    "1d-shrink-repack-adaptive": case(p=4, shrink_every=1, repack=True,
                                      adaptive=True, adaptive_ratio=0.5,
                                      **ONE),
    "2d-shrink": case(p=2, model=2, shrink_every=1, repack=False,
                      use_kernel=False, **ONE),
    "2d-shrink-repack-fused": case(p=2, model=2, shrink_every=1,
                                   repack=True, use_kernel=True, **ONE),
    "2d-adaptive-0.5-fused": case(p=2, model=2, adaptive=True,
                                  delay_rounds=1, adaptive_ratio=0.5,
                                  use_kernel=True, **ONE),
    "2d-shrink-overlap": case(p=2, model=2, shrink_every=1, overlap=True,
                              use_kernel=True, delay_rounds=1, **ONE),
}


# Shrinking under the stale reads of the delayed round (delay_rounds = 1
# with shrink_every, fixed or adaptive): a row's α that lands on a bound
# in one float32 summation order and a rounding short of it in another
# flips the mask (``alpha >= C``), and the solves part.  The reference's
# own ELL and dense engines part by 1.0 on α here; the port is held to
# one of them, every record included.
STALE = {
    "1d-stale-shrink-repack": dict(p=4, shrink_every=1, repack=True,
                                   delay_rounds=1, **ONE),
    "1d-stale-shrink-repack-adaptive": dict(p=4, shrink_every=1,
                                            repack=True, adaptive=True,
                                            delay_rounds=1,
                                            adaptive_ratio=0.5, **ONE),
}
STALE_CASES = {f"{name}-{kind}": case(dense=kind == "dense", **kw)
               for name, kw in STALE.items() for kind in ("ell", "dense")}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_solves({**CASES, **STALE_CASES},
                            tmp_path_factory.mktemp("ref_tuning"))


def _mesh(c):
    return (tmesh.solver_mesh(n_devices=c["p"]) if c["model"] is None
            else tmesh.solver_mesh_2d(data=c["p"], model=c["model"]))


@pytest.mark.parametrize("name", list(CASES))
def test_self_tuning_matches_reference(ref, tiny, name):
    c = CASES[name]
    Xp = port_X(tiny, c["rows"], c["dense"])
    loss = td.make_loss(c["loss"])
    kw = dict(c["kw"])
    if kw.get("use_kernel") is False:
        kw["use_kernel"] = "auto"  # the unfused engine on the CPU
    reads = ts.sharded_passcode_solve.host_reads
    res = ts.sharded_passcode_solve(Xp, loss, mesh=_mesh(c), device="cpu",
                                    **kw)
    r = ref[name]
    assert_matches(res, r, Xp, loss)
    setup = ts.prepare_solver(Xp, loss, mesh=_mesh(c), device="cpu",
                              **{k: v for k, v in kw.items()
                                 if k != "epochs"})
    # one host read of the round count an epoch, where repacking is on
    assert ts.sharded_passcode_solve.host_reads - reads == (
        EPOCHS if setup.tuning.repack else 0)
    if "repack" in name:  # the repack acted: a shrunk epoch before the last
        assert (r["active"][:-1] < kw.get("repack_threshold", 0.5)).any()
    if name == "1d-adaptive-0.5":  # the controller backed off at a record
        assert r["delay"][0] == 1 and r["delay"][-1] == 0


def test_stale_epoch_can_raise_the_gap_in_the_reference(ref, tiny):
    """The adaptive round reads truly stale w (its own shard's last Δw,
    not its peers'), so an epoch can raise the gap: the reference's own
    "1d-adaptive-0.95" solve rises in its final epoch with the flag still
    1 (the controller acts only at later records), and the port, held to
    it above, rises with it."""
    r = ref["1d-adaptive-0.95"]
    assert (r["delay"] == 1).all()
    assert r["gaps"][-1] > r["gaps"][-2]
    c = CASES["1d-adaptive-0.95"]
    res = ts.sharded_passcode_solve(port_X(tiny, c["rows"], c["dense"]),
                                    td.make_loss(c["loss"]), mesh=_mesh(c),
                                    device="cpu", **c["kw"])
    assert res.gaps[-1] > res.gaps[-2]


@pytest.mark.parametrize("dense", [False, True], ids=["ell", "dense"])
@pytest.mark.parametrize("name", list(STALE))
def test_stale_shrinking_matches_a_reference_engine(ref, tiny, name, dense):
    c = STALE_CASES[f"{name}-{'dense' if dense else 'ell'}"]
    Xp = port_X(tiny, c["rows"], dense)
    loss = td.make_loss(c["loss"])
    res = ts.sharded_passcode_solve(Xp, loss, mesh=_mesh(c), device="cpu",
                                    **c["kw"])
    errors = []
    for kind in ("ell", "dense"):
        try:
            assert_matches(res, ref[f"{name}-{kind}"], Xp, loss)
            return
        except AssertionError as err:
            errors.append(f"{kind}: {err}")
    raise AssertionError("matches neither reference engine:\n"
                         + "\n".join(errors))


def test_dcd_solve_shrink_matches_reference(tiny):
    _, _, _, dense = tiny
    for loss, every in [("hinge", 1), ("squared_hinge", 2)]:
        ra, rw, rg, ract = rshrink.dcd_solve_shrink(
            jnp.asarray(dense), rd.make_loss(loss), epochs=4, seed=3,
            shrink_every=every)
        pa, pw, pg, pact = tshrink.dcd_solve_shrink(
            torch.from_numpy(dense), td.make_loss(loss), epochs=4, seed=3,
            shrink_every=every, device="cpu")
        np.testing.assert_allclose(pa.numpy(), np.asarray(ra), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(pw.numpy(), np.asarray(rw), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(pg.numpy(), np.asarray(rg), atol=1e-4,
                                   rtol=1e-5)
        np.testing.assert_array_equal(pact.numpy(), np.asarray(ract))


@pytest.mark.parametrize("loss", ["hinge", "squared_hinge", "logistic"])
def test_active_mask_and_remap_match_reference(loss):
    rng = np.random.default_rng(5)
    alpha = rng.choice([0.0, 0.3, 1.0], 64).astype(np.float32)
    wx = rng.uniform(-1, 3, 64).astype(np.float32)
    ref = rshrink.active_mask_from_w(rd.make_loss(loss), jnp.asarray(alpha),
                                     jnp.asarray(wx), 1e-3)
    got = tshrink.active_mask_from_w(td.make_loss(loss),
                                     torch.from_numpy(alpha),
                                     torch.from_numpy(wx), 1e-3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ids, cnt = active_row_remap(got)
    rids, rcnt = ref_remap(ref)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    assert int(cnt) == int(rcnt)


def test_adaptive_delay_policy_matches_reference():
    prev = np.array([np.inf, 10.0, 10.0, 10.0], np.float32)
    new = np.array([5.0, 9.0, 9.6, 11.0], np.float32)
    for ratio in (0.95, 0.5):
        ref = rmesh.adaptive_delay_policy(jnp.asarray(prev), jnp.asarray(new),
                                          improve_ratio=ratio)
        got = tmesh.adaptive_delay_policy(torch.from_numpy(prev),
                                          torch.from_numpy(new),
                                          improve_ratio=ratio)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


TUNING = [
    dict(shrink_every=1, repack="auto", adaptive=False),
    dict(shrink_every=0, repack="auto", adaptive=True),
    dict(shrink_every=2, repack=False, adaptive=True),
    dict(shrink_every=1, repack="auto", adaptive=False, overlap_on=True),
    dict(shrink_every=1, repack=False, adaptive=False, overlap_on=True,
         overlap_knob=True),
    # the reference's ValueErrors
    dict(shrink_every=-1, repack="auto", adaptive=False),
    dict(shrink_every=1, repack="auto", adaptive=False, pipeline=False),
    dict(shrink_every=0, repack="auto", adaptive=True, record=False),
    dict(shrink_every=1, repack="yes", adaptive=False),
    dict(shrink_every=0, repack=True, adaptive=False),
    dict(shrink_every=1, repack=True, adaptive=False, overlap_on=True,
         overlap_knob=True),
    dict(shrink_every=0, repack="auto", adaptive=True, overlap_on=True,
         overlap_knob=True),
]


@pytest.mark.parametrize("kw", TUNING, ids=[str(i) for i in range(len(TUNING))])
def test_resolve_self_tuning_matches_reference(kw):
    kw = dict(dict(overlap_knob="auto", overlap_on=False, pipeline=True,
                   record=True), **kw)
    args = (kw.pop("shrink_every"), kw.pop("repack"), kw.pop("adaptive"))
    try:
        ref = rmesh.resolve_self_tuning(*args, **kw)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tmesh.resolve_self_tuning(*args, **kw)
        assert str(got.value) == str(err)
        return
    assert tuple(tmesh.resolve_self_tuning(*args, **kw)) == tuple(ref)


def test_mesh_policies():
    one, four = tmesh.solver_mesh(), tmesh.solver_mesh(n_devices=4)
    assert one.shape == {"data": 1} and four.shape == {"data": 4}
    two = tmesh.solver_mesh_2d(data=2, model=3)
    assert tmesh.data_axes(two) == ("data",) and tmesh.dp_size(two) == 2
    assert tmesh.dp_size(four) == 4
    assert tmesh.solver_mesh("model", 3).shape == {"model": 3}
    with pytest.raises(ValueError):
        tmesh.solver_mesh(n_devices=0)


def test_repack_needs_a_drawn_schedule(tiny):
    """``blocks=`` is a fixed schedule: with repacking on it raises, as the
    repacked epochs redraw."""
    Xp = port_X(tiny, 256, False)
    with pytest.raises(ValueError, match="repack"):
        ts.sharded_passcode_solve(Xp, td.Hinge(), epochs=1, block_size=64,
                                  shrink_every=1, device="cpu",
                                  blocks=np.zeros((1, 4, 64)))

"""The segmented solve across processes (``repro_torch.resilience``): a
checkpoint saved by a world of two ``gloo`` ranks resumes bit for bit in
one process, and the reverse, and a fault armed on one rank trips the
watchdog on both.

One world for the module (``_dist_cases.run_world``).  The checkpoint
is the whole solve's, in the reference's format, whatever the world size
(rank 0 writes what every rank gathered), so each resume from the
boundary before the last gives the whole one-process solve's α and ŵ
bit for bit, and its gap records within C.2's 1e-5 + 1e-6·M (on the
CPU a record taken at two ranks sums the ranks' float w(α) partials;
with the ``data`` axis whole on every rank it is the same bits); so does
the two-rank segmented solve itself.
The fault: a NaN in w armed on rank 0 only, persistent while the solve
keeps asynchrony (``delay_rounds`` 1); the watchdog's census is the
ranks' int64 SUM, so both ranks trip at once, replay twice, fall to the
synchronous rung together and end healthy with the same record.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import duals as td

from _dist_cases import port_X, run_world
from test_torch_shards import case
from test_torch_solver import _gap_atol

ONE = dict(epochs=4, block_size=8, seed=5)
SEG = {
    "ell-p4": dict(case=case(p=4, delay_rounds=1, **ONE),
                   ranks={"data": 2}),
    "pods-2x2": dict(case=case(rows=250, pods=2, p=2, pod_delay_rounds=1,
                               **ONE), ranks={"pod": 2}),
    "2d-m4": dict(case=case(p=1, model=4, use_kernel=True, delay_rounds=1,
                            **ONE), ranks={"model": 2}),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_ckpt")
    spec = {}
    for name, item in SEG.items():
        for order in ("2to1", "1to2"):
            spec[f"{name}-{order}"] = dict(
                kind="segmented", order=order, every=2,
                dir=str(tmp / f"ckpt-{name}-{order}"), **item)
    spec["fault"] = dict(kind="fault", epoch=1, every=2, **SEG["ell-p4"])
    return run_world(2, spec, tmp)


@pytest.mark.parametrize("order", ["2to1", "1to2"])
@pytest.mark.parametrize("name", list(SEG))
def test_resume_across_world_sizes_is_the_whole_solve(world, name, order):
    out, c = world[f"{name}-{order}"], SEG[name]["case"]
    assert int(out["resumed_from"]) == 2
    tol = _gap_atol(port_X(c["rows"], c["dense"]),
                    torch.from_numpy(out["whole_alpha"]),
                    td.make_loss(c["loss"]))
    runs = ["resumed"] + (["saved"] if order == "2to1" else [])
    for run in runs:  # "saved": the two-rank segmented solve itself
        for k in ("alpha", "w_hat"):
            np.testing.assert_array_equal(out[f"{run}_{k}"],
                                          out[f"whole_{k}"])
        for k in ("gaps", "eps"):
            np.testing.assert_allclose(out[f"{run}_{k}"], out[f"whole_{k}"],
                                       rtol=0, atol=tol)
        if "data" not in SEG[name]["ranks"] and "pod" not in SEG[name][
                "ranks"]:
            np.testing.assert_array_equal(out[f"{run}_gaps"],
                                          out["whole_gaps"])


def test_fault_on_one_rank_trips_both(world):
    rec = world["fault"]["records"]
    # (health, rollbacks, rung, epochs lost, attempts …) on each rank
    np.testing.assert_array_equal(rec[0], rec[1])
    health, rollbacks, rung, lost = rec[0][:4]
    assert (health, rung) == (0, 1)
    assert rollbacks == 2 and lost == 4
    np.testing.assert_array_equal(rec[0][4:6], [3, 1])
    assert np.isfinite(world["fault"]["dist_alpha"]).all()

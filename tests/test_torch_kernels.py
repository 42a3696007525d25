"""The port's DCD kernels.

On the CPU each kernel's plain version — reached through
``repro_torch.kernels.ops``, as the solver reaches it — is held to the
reference's Pallas kernel in interpret mode (as ``tests/test_kernels.py``
runs it): the same id sequence with repeated and out-of-order ids, an
``active`` mask and ±1 ``y``, for the three losses.  atol 1e-5 on α and
w (float32; the sums run in another order).  The CUDA kernels are held
to these plain versions on the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import duals as rd
from repro.kernels import ops as rops
from repro.kernels.ref import dcd_epoch_ref as jax_epoch_ref
from repro_torch.core import duals as td
from repro_torch.kernels import build, ops
from repro_torch.kernels.dcd_block import dcd_indexed_epoch, dcd_tile_epoch
from repro_torch.kernels.dcd_ell import dcd_ell_epoch
from repro_torch.kernels.ref import dcd_epoch_ref

LOSSES = ["hinge", "squared_hinge", "logistic"]
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, ref):
    np.testing.assert_allclose(port.cpu().numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def _ell_case(seed=0, n=48, d=40, k=9):
    """A ragged ELL shard (padding id d, value 0) with one duplicated
    column, feasible α, a mask, ±1 labels and an id sequence with
    repeats, in no order, of a length that is not a block multiple."""
    rng = np.random.default_rng(seed)
    cols = np.full((n, k), d, np.int32)
    vals = np.zeros((n, k), np.float32)
    for i in range(n):
        nnz = rng.integers(1, k + 1)
        cols[i, :nnz] = rng.choice(d, nnz, replace=False)
        vals[i, :nnz] = rng.standard_normal(nnz) * 0.4
    cols[5, 1] = cols[5, 0]  # a repeated column accumulates
    return cols, vals, _state(rng, n, d + 1)


def _state(rng, n, w_len):
    alpha = rng.uniform(0.05, 0.5, n).astype(np.float32)
    w = (rng.standard_normal(w_len) * 0.1).astype(np.float32)
    active = (rng.random(n) > 0.25).astype(np.float32)
    y = np.where(rng.random(n) > 0.5, 1.0, -1.0).astype(np.float32)
    idx = np.concatenate([rng.permutation(n)[: n - 7],
                          [3, 3, 0, n - 1, 17]]).astype(np.int32)
    return alpha, w, active, y, idx


@pytest.mark.parametrize("loss", LOSSES)
def test_b1_plain_matches_pallas_ell(loss):
    cols, vals, (alpha, w, active, y, idx) = _ell_case()
    d = 40
    w[d] = 0.0  # the dummy slot starts (and stays) 0
    q = (vals * vals).sum(1)
    ra, rdw = rops.dcd_ell_block_update_pallas(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(q),
        jnp.asarray(alpha), jnp.asarray(w), jnp.asarray(idx),
        loss=rd.make_loss(loss, 0.8), interpret=True,
        active=jnp.asarray(active), y=jnp.asarray(y))
    pa, pdw = ops.dcd_ell_block_update(
        _t(cols), _t(vals), _t(q), _t(alpha), _t(w), _t(idx),
        loss=td.make_loss(loss, 0.8), active=_t(active), y=_t(y))
    _close(pa, ra)
    _close(pdw, rdw)
    assert float(pdw[d]) == 0.0
    frozen = np.setdiff1d(np.arange(48), idx[active[idx] > 0])
    np.testing.assert_array_equal(pa.numpy()[frozen], alpha[frozen])


@pytest.mark.parametrize("loss", LOSSES)
def test_b2_plain_matches_pallas_indexed(loss):
    rng = np.random.default_rng(1)
    n, d = 40, 24
    X = (rng.standard_normal((n, d)) * 0.2).astype(np.float32)
    alpha, w, active, y, idx = _state(rng, n, d)
    q = (X * X).sum(1)
    ra, rdw = rops.dcd_block_update_pallas(
        jnp.asarray(X), jnp.asarray(q), jnp.asarray(alpha), jnp.asarray(w),
        jnp.asarray(idx), loss=rd.make_loss(loss, 0.8), interpret=True,
        active=jnp.asarray(active), y=jnp.asarray(y))
    pa, pdw = ops.dcd_block_update(
        _t(X), _t(q), _t(alpha), _t(w), _t(idx), loss=td.make_loss(loss, 0.8),
        active=_t(active), y=_t(y))
    _close(pa, ra)
    _close(pdw, rdw)


@pytest.mark.parametrize("n,block", [(96, 32), (100, 64)])
@pytest.mark.parametrize("sq_hinge", [False, True], ids=["hinge", "sq"])
def test_b3_plain_matches_pallas_tile_and_ref(n, block, sq_hinge):
    """The in-order epoch against the Pallas tile kernel and both
    oracles; when n is not a block multiple the reference pads rows and
    the port runs X as given."""
    rng = np.random.default_rng(2)
    d = 30
    X = (rng.standard_normal((n, d)) * 0.1).astype(np.float32)
    q = (X * X).sum(1)
    a0, w0 = np.zeros(n, np.float32), np.zeros(d, np.float32)
    ra, rw = rops.dcd_epoch_pallas(jnp.asarray(X), jnp.asarray(a0),
                                   jnp.asarray(w0), jnp.asarray(q), c=0.5,
                                   sq_hinge=sq_hinge, block_rows=block,
                                   interpret=True)
    pa, pw = ops.dcd_epoch(_t(X), _t(a0), _t(w0), _t(q), c=0.5,
                           sq_hinge=sq_hinge, block_rows=block)
    _close(pa, ra)
    _close(pw, rw)
    oa, ow = dcd_epoch_ref(_t(X), _t(a0), _t(w0), _t(q), 0.5, sq_hinge)
    ja, jw = jax_epoch_ref(jnp.asarray(X), jnp.asarray(a0), jnp.asarray(w0),
                           jnp.asarray(q), 0.5, sq_hinge)
    _close(oa, ja)
    _close(ow, jw)
    _close(pa, ja)
    _close(pw, jw)


def test_b3_logistic_and_indexed_padding_match_pallas():
    """``loss=`` overrides the legacy flags in the tile mode; in the
    indexed mode an id count that is not a block multiple pads onto the
    extra zero row n."""
    rng = np.random.default_rng(3)
    n, d = 64, 20
    X = (rng.standard_normal((n, d)) * 0.2).astype(np.float32)
    a0 = np.full(n, 0.3, np.float32)
    w0 = np.zeros(d, np.float32)
    idx = np.array([5, 5, 63, 0, 17, 40, 2], np.int32)
    for kw_ref, kw_port in [
        (dict(loss=rd.Logistic(1.0), block_rows=32),
         dict(loss=td.Logistic(1.0), block_rows=32)),
        (dict(loss=rd.Hinge(1.0), idx=jnp.asarray(idx), block_rows=4),
         dict(loss=td.Hinge(1.0), idx=_t(idx), block_rows=4)),
    ]:
        ra, rw = rops.dcd_epoch_pallas(jnp.asarray(X), jnp.asarray(a0),
                                       jnp.asarray(w0), interpret=True,
                                       **kw_ref)
        pa, pw = ops.dcd_epoch(_t(X), _t(a0), _t(w0), **kw_port)
        _close(pa, ra)
        _close(pw, rw)


def test_epoch_rejects_out_of_range_ids():
    X = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="row ids"):
        ops.dcd_epoch(X, torch.zeros(4), torch.zeros(3),
                      idx=torch.tensor([0, 4], dtype=torch.int32))


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "strided"])
def test_launch_checks_reject_bad_operands(bad):
    """The operand checks every CUDA launch runs first (exercised here on
    CPU tensors against a CPU device)."""
    a = torch.zeros(6)
    ops_ = {"alpha": (a, (6,)), "idx": (torch.zeros(3, dtype=torch.int32),
                                       None)}
    if bad == "dtype":
        ops_["alpha"] = (a.double(), (6,))
    elif bad == "shape":
        ops_["alpha"] = (torch.zeros(5), (6,))
    elif bad == "device":
        ops_["alpha"] = (torch.zeros(6, device="meta"), (6,))
    else:
        ops_["alpha"] = (torch.zeros(12)[::2], (6,))
    with pytest.raises(ValueError):
        build.check_operands(torch.device("cpu"), ops_, int32=("idx",))
    build.check_operands(torch.device("cpu"), {"alpha": (a, (6,))})


def test_cpu_wrappers_do_not_launch():
    """A CPU tensor takes the plain version and never counts a launch."""
    before = (dcd_ell_epoch.launches, dcd_indexed_epoch.launches,
              dcd_tile_epoch.launches)
    cols, vals, (alpha, w, _, _, idx) = _ell_case(seed=4)
    dcd_ell_epoch(_t(cols), _t(vals), _t(alpha), _t(w),
                  _t((vals * vals).sum(1)), loss=td.Hinge(), idx=_t(idx))
    X = torch.ones((4, 3))
    dcd_indexed_epoch(X, torch.zeros(4), torch.zeros(3), torch.ones(4),
                      loss=td.Hinge(), idx=torch.arange(4, dtype=torch.int32))
    dcd_tile_epoch(X, torch.zeros(4), torch.zeros(3), torch.ones(4),
                   loss=td.Hinge())
    assert (dcd_ell_epoch.launches, dcd_indexed_epoch.launches,
            dcd_tile_epoch.launches) == before

"""The linear-probe twin (``examples/linear_probe_lm_torch.py``) against
the reference example's pipeline (``examples/linear_probe_lm.py``) on the
same weights and tokens: the smoke mistral-nemo-12b's parameters from
``jax.random.PRNGKey(0)`` carried across with ``params_from_numpy``, the
reference's token recipe from ``PRNGKey(1)``.  The features, both head
stacks (the one multi-task solve and the loop over K of serial DCD) and
both top-1 scores must be the reference's.

Tolerances, float32 on both sides: the normalised features at rtol/atol
1e-4 (``_lm_cases.RTOL``); the heads (entries up to about 2.2) at atol
1e-5, the solvers' own parity tolerance (2.5e-6 measured); top-1 exactly
(one of the 64 test rows is 0.0156)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import Hinge, dcd_solve, multiclass_accuracy
from repro.core import sharded_passcode_solve
from repro.data import ovr_labels
from repro.models import lm_features
from repro_torch.configs import get_smoke_config as port_smoke_config

from _lm_cases import close, port_params, ref_params

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
from linear_probe_lm_torch import (  # noqa: E402
    ARCH,
    EPOCHS,
    N,
    N_CLASSES,
    N_TRAIN,
    SEQ,
    linear_probe,
)

HEAD_ATOL = 1e-5


@pytest.fixture(scope="module")
def reference():
    """The reference example's steps, as ``examples/linear_probe_lm.py``
    runs them (its own ``acc > 0.7`` assertion aside: ROADMAP C.15)."""
    cfg = get_smoke_config(ARCH)
    params = ref_params(ARCH)
    ky, kt = jax.random.split(jax.random.PRNGKey(1))
    y = jax.random.randint(ky, (N,), 0, N_CLASSES)
    quart = cfg.vocab_size // N_CLASSES
    tokens = jax.random.randint(kt, (N, SEQ), 0, quart) + y[:, None] * quart
    feats = np.array(lm_features(cfg, params, tokens))
    feats /= np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-6)
    X = jnp.asarray(feats)
    Y = ovr_labels(y, N_CLASSES)
    X_train, X_test = X[:N_TRAIN], X[N_TRAIN:]
    y_test, Y_train = y[N_TRAIN:], Y[:, :N_TRAIN]
    loss = Hinge(C=1.0)
    W = np.asarray(sharded_passcode_solve(X_train, loss, y=Y_train,
                                          epochs=EPOCHS,
                                          block_size=16).w_hat)
    W_ref = np.stack([
        np.asarray(dcd_solve(X_train * np.asarray(Y_train)[k][:, None],
                             loss, epochs=EPOCHS).w)
        for k in range(N_CLASSES)])
    return dict(tokens=np.asarray(tokens), y=np.asarray(y), X=feats, W=W,
                W_ref=W_ref,
                acc=float(multiclass_accuracy(W, X_test, y_test)),
                acc_ref=float(multiclass_accuracy(W_ref, X_test, y_test)))


@pytest.fixture(scope="module")
def twin(reference):
    data = (torch.tensor(reference["tokens"]).long(),
            torch.tensor(reference["y"]).long())
    return linear_probe(port_smoke_config(ARCH), port_params(ARCH),
                        device="cpu", data=data)


def test_probe_features_match_reference(twin, reference):
    assert tuple(twin["X"].shape) == reference["X"].shape
    close(twin["X"], reference["X"])


@pytest.mark.parametrize("heads", ["W", "W_ref"],
                         ids=["multi_task", "loop_over_k"])
def test_probe_heads_match_reference(twin, reference, heads):
    got = twin[heads].detach().cpu().numpy()
    assert got.shape == reference[heads].shape == (N_CLASSES,
                                                   reference["X"].shape[1])
    np.testing.assert_allclose(got, reference[heads], rtol=0.0,
                               atol=HEAD_ATOL)


@pytest.mark.parametrize("acc", ["acc", "acc_ref"],
                         ids=["multi_task", "loop_over_k"])
def test_probe_top1_matches_reference(twin, reference, acc):
    assert twin[acc] == reference[acc], (twin[acc], reference[acc])
    assert twin[acc] > twin["majority"], twin

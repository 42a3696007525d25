"""PASSCoDe inside the LM stack on the PyTorch port — the twin of
``examples/linear_probe_lm.py`` (``repro_torch``, no jax): a K-class
one-vs-rest linear probe on FROZEN LM features, trained with ONE
multi-task PASSCoDe solve.

Pipeline: an LM with random weights → ``repro_torch.models.lm_features``
(mean-pooled final-norm hidden states) of n = 256 labeled sequences of
32 tokens, each drawn from the vocabulary quarter of its class (its first
``POOL`` = 128 ids: the whole quarter of the smoke config's 512-token
vocabulary, the reference's recipe there) → K = 4
shared-X hinge heads in one solve (``sharded_passcode_solve(X, loss,
y=Y)``: on the card one B2 task-grid launch a round) → argmax top-1 on
the 64 held-out sequences (``multiclass_accuracy``); then the loop over
K of serial DCD (one wide B2 launch an epoch on the card), whose heads
the batched solve should match.

    PYTHONPATH=src python examples/linear_probe_lm_torch.py [--device cpu]
                                                            [--full-width]

The default is the smoke mistral-nemo-12b on the card; ``--device cpu``
runs the kernels' plain versions.  ``--full-width`` takes the full
config (40 layers of d_model 5120, about 49 GB of float32 weights: the
card only).  Both assert top-1 above the majority class's share of the
test rows.  At full width a class's tokens come from 128 of its
quarter's 32,768 ids: the mean of 32 random embeddings drawn from a
whole quarter carries next to nothing of the quarter's own mean (about
1/180 of a sequence's spread), and the probe sat at chance there (top-1
0.2031 against a majority share of 0.3906, NVIDIA H100 80GB HBM3,
700 W, ``chip_smoke.py`` phase 7).  The reference example's floor of 0.7 is not a property of
the solver: at this recipe the classes' mean features lie about 0.3
apart against a spread of about 1 within a class, the reference's own
example gives 0.547 on jax 0.9.0, and the smoke twin's top-1 spreads
over 0.52–0.77 across 16 seed pairs (ROADMAP C.15).  What holds the
solver is ``tests/test_torch_probe.py``: on the reference example's own
weights and tokens the twin's features, both head stacks and both top-1
scores are the reference's (0.547 each).
"""

import argparse

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import (
    Hinge,
    dcd_solve,
    multiclass_accuracy,
    sharded_passcode_solve,
)
from repro_torch.data import ovr_labels
from repro_torch.models import init_params, lm_features

ARCH = "mistral-nemo-12b"
N_CLASSES, N, SEQ, N_TRAIN, EPOCHS = 4, 256, 32, 192, 15
POOL = 128  # ids a class draws from: the first of its vocabulary quarter
FEATURE_BATCH = 64  # sequences a call of lm_features


def probe_tokens(cfg, seed: int = 1):
    """(tokens (N, SEQ), classes (N,)) on the CPU: class c's tokens are
    drawn from the first ``POOL`` ids of the c-th quarter of the
    vocabulary (the whole quarter where it holds no more)."""
    gen = torch.Generator().manual_seed(seed)
    y = torch.randint(0, N_CLASSES, (N,), generator=gen)
    quart = cfg.vocab_size // N_CLASSES
    lo = torch.randint(0, min(quart, POOL), (N, SEQ), generator=gen)
    return lo + y[:, None] * quart, y


def linear_probe(cfg, params, *, device, seed: int = 1, data=None) -> dict:
    """The probe on ``params``: features, the multi-task solve, the
    loop-over-K reference.  ``data`` is (tokens (N, SEQ), classes (N,)),
    ``probe_tokens(cfg, seed)`` by default.  Returns top-1 of both, the
    largest head difference, the majority class's share, the feature
    width, the normalised features and both head stacks (K, d)."""
    dev = torch.device(device)
    tokens, y = probe_tokens(cfg, seed) if data is None else data
    with torch.inference_mode():
        feats = torch.cat([lm_features(cfg, params, t.to(dev))
                           for t in tokens.split(FEATURE_BATCH)])
    X = feats.float()
    X = X / torch.clamp(X.norm(dim=1, keepdim=True), min=1e-6)
    Y = ovr_labels(y, N_CLASSES, device=dev)  # (K, n) ±1, X unfolded
    y = y.to(dev)
    X_train, X_test = X[:N_TRAIN], X[N_TRAIN:]
    y_test = y[N_TRAIN:]
    Y_train = Y[:, :N_TRAIN]
    loss = Hinge(C=1.0)
    # ONE solve trains all K heads against the shared X
    dist = sharded_passcode_solve(X_train, loss, y=Y_train, epochs=EPOCHS,
                                  block_size=16, device=dev)
    acc = float(multiclass_accuracy(dist.w_hat, X_test, y_test))
    # the loop over K of serial DCD, each head's labels folded into X
    W_ref = torch.stack([
        dcd_solve(X_train * Y_train[k][:, None], loss, epochs=EPOCHS,
                  device=dev).w for k in range(N_CLASSES)])
    acc_ref = float(multiclass_accuracy(W_ref, X_test, y_test))
    majority = float(torch.bincount(y_test, minlength=N_CLASSES).max()
                     / y_test.numel())
    return dict(acc=acc, acc_ref=acc_ref,
                head_gap=float((dist.w_hat - W_ref).abs().max()),
                majority=majority, d=X.shape[1], X=X, W=dist.w_hat,
                W_ref=W_ref)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--full-width", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = get_config(ARCH) if args.full_width else get_smoke_config(ARCH)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    r = linear_probe(cfg, params, device=dev)
    print(f"{N_CLASSES}-class linear probe on frozen {cfg.name} features "
          f"({N_TRAIN} train / {N - N_TRAIN} test, d={r['d']})")
    print(f"  multi-task PASSCoDe (1 solve, K={N_CLASSES}) "
          f"top1={r['acc']:.3f} (majority {r['majority']:.3f})")
    print(f"  loop-over-K serial DCD           top1={r['acc_ref']:.3f} "
          f"max|ΔW|={r['head_gap']:.2e}")
    assert r["acc"] > r["majority"], r
    assert r["acc_ref"] > r["majority"], r
    return r


if __name__ == "__main__":
    main()

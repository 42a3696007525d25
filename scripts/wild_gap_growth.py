#!/usr/bin/env python3
"""One PASSCoDe-Atomic and one PASSCoDe-Wild epoch at rcv1's width, in
the reference (``repro``) and the port (``repro_torch``, on the CPU) on
the same rows: each epoch's duality gap over the gap at α = 0, and how
far the port's ŵ lies from the reference's.

    PYTHONPATH=src python scripts/wild_gap_growth.py [--rows 4000 20000 100000]

The rows have rcv1's shape (d = 47,236, 73 distinct zipf-weighted
columns a row, unit norm, label-folded), drawn with numpy from
``--seed``; the solve is hinge C = 1, 8 threads, conflict rate 0.5, no
delay, seed 0 (the settings of ``chip_smoke.py``'s Atomic and Wild
epochs).  Wild's nominal gap is that of w̄ = Σ α_i x_i (eq. 6), which
runs ahead of the ŵ its updates read: on the hot columns most of a
conflicted feature's increments are lost, so α is pushed on against a
lagging ŵ and w̄'s gap grows with n.  The table shows it grow in both
packages alike, past the gap at α = 0 once n is large, while Atomic's
stays below it.
"""

import argparse

import numpy as np

D, K, C = 47_236, 73, 1.0
THREADS, CONFLICT_RATE = 8, 0.5


def rcv1_rows(n: int, seed: int = 0):
    """(indices, values) of n rcv1-shape rows: K distinct columns a row,
    zipf(0.9)-weighted (a draw repeated within its row draws again),
    unit-norm normal values, the label folded in (y from a sparse
    ground truth's margin plus noise, 2% flipped)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, D + 1) ** 0.9
    cdf = np.cumsum(p / p.sum())

    def draw(size):
        return np.minimum(np.searchsorted(cdf, rng.random(size), "right"),
                          D - 1)

    cols = draw((n, K))
    while True:
        srt = np.sort(cols, axis=1)
        order = np.argsort(cols, axis=1, kind="stable")
        rep = np.zeros(cols.shape, bool)
        np.put_along_axis(rep, order[:, 1:], srt[:, 1:] == srt[:, :-1], 1)
        if not rep.any():
            break
        cols[rep] = draw(int(rep.sum()))
    val = rng.standard_normal((n, K)).astype(np.float32)
    val /= np.maximum(np.linalg.norm(val, axis=1, keepdims=True), 1e-8)
    w_true = rng.standard_normal(D).astype(np.float32)
    w_true *= np.abs(w_true) > 0.6
    margins = (val * w_true[cols]).sum(1)
    y = np.where(margins + 0.5 * rng.standard_normal(n) > 0, 1.0, -1.0)
    y = np.where(rng.random(n) < 0.02, -y, y).astype(np.float32)
    return cols.astype(np.int32), val * y[:, None]


def solve_both(n: int, seed: int = 0):
    """One Atomic and one Wild epoch on the same n rows in each package.
    Returns (the port's X, {"repro": gap at α = 0, "repro_torch": ...},
    {mm: (the reference's PasscodeResult, the port's)})."""
    import jax.numpy as jnp
    import torch

    from repro.core import duals as rd
    from repro.core import passcode as rp
    from repro.core.objective import duality_gap as ref_gap
    from repro.data.sparse import EllMatrix as RefEll
    from repro_torch.convert import ell_from_numpy
    from repro_torch.core import duals as td
    from repro_torch.core import passcode as tp
    from repro_torch.core.objective import duality_gap as port_gap

    idx, val = rcv1_rows(n, seed)
    Xr = RefEll(jnp.asarray(idx), jnp.asarray(val), D)
    Xp = ell_from_numpy(idx, val, D, device="cpu")
    gap0 = {"repro": float(ref_gap(jnp.zeros(n), Xr, rd.Hinge(C))),
            "repro_torch": float(port_gap(torch.zeros(n), Xp, td.Hinge(C)))}
    kw = dict(n_threads=THREADS, epochs=1, seed=0, delay=0,
              conflict_rate=CONFLICT_RATE)
    runs = {mm: (rp.passcode_solve(Xr, rd.Hinge(C), memory_model=mm, **kw),
                 tp.passcode_solve(Xp, td.Hinge(C), memory_model=mm,
                                   device="cpu", **kw))
            for mm in ("atomic", "wild")}
    return Xp, gap0, runs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, nargs="+",
                    default=[4_000, 20_000, 100_000])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print("rows     | gap / gap at α = 0: repro atomic, wild | repro_torch "
          "atomic, wild | max |ŵ_port − ŵ_ref| atomic, wild")
    for n in args.rows:
        _, gap0, runs = solve_both(n, args.seed)
        ref = [float(r.gaps[0]) / gap0["repro"] for r, _ in runs.values()]
        port = [float(p.gaps[0]) / gap0["repro_torch"]
                for _, p in runs.values()]
        err = [float(np.abs(p.w_hat.numpy() - np.asarray(r.w_hat)).max())
               for r, p in runs.values()]
        print(f"{n:8d} | {ref[0]:.4f}, {ref[1]:.4f} | {port[0]:.4f}, "
              f"{port[1]:.4f} | {err[0]:.3g}, {err[1]:.3g}", flush=True)

if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The pod solve's duality gap at ``pod_delay_rounds`` 2 on rcv1's rows:
the serial oracle ``cocoa_pod_solve`` of the reference (``repro``) and
of the port (``repro_torch``) on the same rows, each one's gap epoch by
epoch at pod delays 0 and 2 (P = 2 pods, hinge C = 1, B = 64, 3 epochs,
seed 0: the settings of ``chip_smoke.py``'s rcv1 pod paths).

With a merge two outer rounds in flight, each pod's third local epoch
moves α against a w that lacks the last two merges, and the gap can
rise in that epoch.  The table shows whether it rises in both packages
alike on each prefix of the rows.

    # on the card: draw rcv1 as chip_smoke.py does (make_paper_split,
    # seed 0, on the card), print the port's gaps on each prefix, and
    # keep the first --keep rows
    python3 scripts/pod_delay_rise.py --card --rows 4000 20000 100000 \\
        --keep 20000 --save chiprun_out/rcv1_rows.npz

    # on the CPU: both packages on the kept rows
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/pod_delay_rise.py \\
        --load chiprun_out/rcv1_rows.npz --rows 4000 10000 20000

The reference densifies its input, so a prefix of n rows takes
n × 47,236 × 4 bytes there (3.8 GB at 20,000 rows).
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
P, B, C, EPOCHS, SEED = 2, 64, 1.0, 3, 0


def port_gaps(X, n, device):
    """The port's oracle on X's first n rows at delays 0 and 2."""
    from repro_torch.core import duals
    from repro_torch.core.cocoa import cocoa_pod_solve
    from repro_torch.data.sparse import EllMatrix

    Xn = EllMatrix(X.indices[:n], X.values[:n], X.n_features)
    return {delay: cocoa_pod_solve(
        Xn, duals.Hinge(C), n_pods=P, epochs=EPOCHS, block_size=B,
        pod_delay_rounds=delay, seed=SEED, device=device).gaps.tolist()
        for delay in (0, 2)}


def ref_gaps(idx, val, d, n):
    """The reference's oracle on the first n rows at delays 0 and 2."""
    import jax.numpy as jnp

    from repro.core import duals
    from repro.core.cocoa import cocoa_pod_solve
    from repro.data.sparse import EllMatrix

    X = EllMatrix(jnp.asarray(idx[:n]), jnp.asarray(val[:n]), d)
    return {delay: [float(g) for g in cocoa_pod_solve(
        X, duals.Hinge(C), n_pods=P, epochs=EPOCHS, block_size=B,
        pod_delay_rounds=delay, seed=SEED).gaps]
        for delay in (0, 2)}


def show(n, who, gaps, sec):
    for delay, g in gaps.items():
        rises = g[-1] > g[-2]
        print(f"{n:>7} {who:<12} delay {delay}: gaps "
              + " ".join(f"{x:.6g}" for x in g)
              + f"  (third epoch {'rises' if rises else 'falls'}; "
              f"{sec:.1f} s both delays)", flush=True)


def on_card(rows, keep, save):
    import numpy as np
    import torch

    from repro_torch.data.synthetic import make_paper_split

    if not torch.cuda.is_available():
        sys.exit("--card needs a CUDA card")
    dev = torch.device("cuda")
    X, _ = make_paper_split("rcv1", seed=0, device=dev)
    for n in rows:
        t0 = time.perf_counter()
        gaps = port_gaps(X, n, dev)
        show(n, "repro_torch", gaps, time.perf_counter() - t0)
    if save:
        out = Path(save)
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(out, indices=X.indices[:keep].cpu().numpy(),
                            values=X.values[:keep].cpu().numpy(),
                            d=X.n_features)
        print(f"kept rcv1's first {keep} rows in {out}")


def on_cpu(rows, load):
    import numpy as np

    from repro_torch.convert import ell_from_numpy

    data = np.load(load)
    idx, val, d = data["indices"], data["values"], int(data["d"])
    X = ell_from_numpy(idx, val, d, device="cpu")
    for n in rows:
        if n > idx.shape[0]:
            sys.exit(f"{load} keeps {idx.shape[0]} rows, not {n}")
        t0 = time.perf_counter()
        show(n, "repro", ref_gaps(idx, val, d, n), time.perf_counter() - t0)
        t0 = time.perf_counter()
        show(n, "repro_torch", port_gaps(X, n, "cpu"),
             time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[4000, 20000])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--card", action="store_true",
                      help="draw rcv1 on the card, run the port there")
    mode.add_argument("--load", help="rows kept by a --card run (.npz)")
    ap.add_argument("--keep", type=int, default=20000)
    ap.add_argument("--save", help="where --card keeps its first rows")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    if args.card:
        on_card(args.rows, args.keep, args.save)
    else:
        on_cpu(args.rows, args.load)


if __name__ == "__main__":
    main()

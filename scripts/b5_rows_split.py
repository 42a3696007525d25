#!/usr/bin/env python3
"""B5's rows layout on the shim's block, its time split between the
recursion and the scatter.

    python3 scripts/b5_rows_split.py [--src DIR] [--ids 4096 2048]

Draws rcv1's shape (47,236 columns, 73 slots a row, the paper recipe of
``repro_torch.data.synthetic``) at 4,096 rows from seed 0, splits it into
m = 4 feature shards as the 2-D solver does, and runs B4 then B5 on one
block of the first ``--ids`` rows in a random order (the
``sharded_passcode_feature`` shim's one block an epoch, past 1,024 ids:
both kernels' rows layout), hinge, C = 1.  Prints the card's name and
power limit, B5's device ms a launch (CUDA events behind a 20 ms spin,
the mean of 5), and the device ms of each of its kernels from
``torch.profiler`` (the mean of 3 launches), then one JSON object.

``--src`` runs the ``repro_torch`` of another checkout's ``src/``
(default: this one's), so that two trees are timed in one call on one
card.  Needs one CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--ids", type=int, nargs="+", default=[4096, 2048])
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("b5_rows_split: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import duals
    from repro_torch.data.sparse import ell_column_split
    from repro_torch.data.synthetic import DatasetRecipe, make_paper_split
    from repro_torch.kernels import dcd_feature as feat

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    n, m = max(args.ids), 4
    X, _ = make_paper_split("rcv1", recipe=DatasetRecipe(
        "rcv1", n, 0, 47_236, 73, 1.0), device=dev)
    fs = ell_column_split(X, m)
    cols, vals, q = fs.indices, fs.values, fs.row_sq_norms()
    d1 = fs.d_loc + 1
    gen = torch.Generator(device=dev).manual_seed(1)
    order = torch.randperm(n, generator=gen, device=dev).int()
    w = torch.randn((m, d1), generator=gen, device=dev) * 1e-3
    w[:, -1] = 0.0
    a0 = torch.zeros(n, device=dev)
    loss = duals.Hinge(1.0)
    out = {"card": card, "src": args.src, "blocks": []}
    for b in args.ids:
        idx = order[:b].contiguous()
        ws = feat.gram_workspace(m, b, fs.k_loc, d1, dev)
        base_p, gram_p = feat.dcd_feature_gram(cols, vals, w, idx,
                                               workspace=ws)
        base, gram = base_p.sum(0), gram_p.sum(0)

        def run():
            return feat.dcd_feature_update(cols, vals, a0, q, w, idx, base,
                                           gram, loss=loss, workspace=ws)

        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(5):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 5
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run()
            torch.cuda.synchronize()
        kernels = {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0))
            if t > 0:
                kernels[ev.key.split("(")[0]] = t / 3 / 1e3
        print(f"  {b} ids: {ms:.4f} ms a launch; "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in kernels.items()))
        out["blocks"].append({"ids": b, "ms": ms, "kernels": kernels})
        del ws, base_p, gram_p, gram
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

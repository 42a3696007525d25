#!/usr/bin/env python3
"""Time B3's stream kernel at the covtype shape under other ring layouts
than the one ``repro_torch.dist.mesh.dcd_tile_plan`` picks: the rows a
stage holds (T) and the stages of the ring (S).

    python3 scripts/b3_stream_layouts.py

One in-order hinge epoch (C = 0.0625, from α = 0, w = 0) over the whole
covtype shard (n = 581,012, d = 54, drawn on the card from seed 1 as in
``chip_smoke.py``) per launch.  Each layout is held to the wide kernel's
result (max abs err, tolerance 1e-5) and timed twice, in turns (all
layouts, then all again in reverse order), with ``chip_smoke.cuda_ms``
(device time, launches queued behind a spin).  Prints the card's name and
power limit, a line per layout and a JSON object of the times.  Needs one
CUDA card.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
# (T rows a stage, S stages)
LAYOUTS = [(256, 2), (8, 4), (32, 4), (64, 4), (128, 2), (128, 4), (256, 4)]


def main():
    import torch

    if not torch.cuda.is_available():
        print("b3_stream_layouts: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import card_line, cuda_ms
    from repro_torch.core import duals
    from repro_torch.data.synthetic import make_paper_split
    from repro_torch.dist.mesh import (
        TilePlan,
        dcd_tile_plan,
        dcd_tile_stream_bytes,
    )
    from repro_torch.kernels.dcd_block import dcd_tile_epoch, tile_launch

    print(card_line())
    dev = torch.device("cuda")
    X, _ = make_paper_split("covtype", seed=1, device=dev)
    n, d = X.shape
    q = (X * X).sum(1)
    loss = duals.Hinge(0.0625)
    a0, w0 = torch.zeros(n, device=dev), torch.zeros(d, device=dev)
    ref_a, ref_w = dcd_tile_epoch(X, a0, w0, q, loss=loss, wide=True)
    print(f"covtype {n} x {d}; the plan: {dcd_tile_plan(n, d)}")

    def run(plan):
        a, w = a0.clone(), w0.clone()
        tile_launch(plan, X, a, w, q, loss)
        return a, w

    per_lane = dcd_tile_plan(n, d).per_lane
    plans = {}
    for T, S in LAYOUTS:
        plan = TilePlan("stream", 64, per_lane, T, S,
                        dcd_tile_stream_bytes(T, S, d))
        a, w = run(plan)
        torch.cuda.synchronize()
        err = max(float((a - ref_a).abs().max()),
                  float((w - ref_w).abs().max()))
        if not err <= ATOL:
            raise RuntimeError(f"layout {(T, S)}: max abs err {err} against "
                               "the wide kernel")
        plans[(T, S)] = (plan, err)
    times = {k: [] for k in plans}
    for order in (list(plans), list(reversed(plans))):
        for k in order:
            times[k].append(cuda_ms(lambda: run(plans[k][0]), 3, torch))
    for k, (plan, err) in plans.items():
        T, S = k
        print(f"  T {T:3d} S {S}: "
              f"{' / '.join(f'{t:.4f}' for t in times[k])} ms per epoch "
              f"({plan.smem_bytes} B of shared memory; max abs err against "
              f"the wide kernel {err:.3g})")
    print(json.dumps({"card": card_line(), "ms": {
        f"T{k[0]}_S{k[1]}": v for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

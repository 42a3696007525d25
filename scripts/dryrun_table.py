"""Print the port's dry-run grid as a markdown table: one row an (arch,
mesh), one column a shape, each cell the per-device GiB
(``peak_bytes_est``), the three roofline terms in seconds (compute /
memory / collective), the dominant one and the useful-FLOPs fraction.
The figures are predictions of the H100 roofline, counted on the host
(no card).

Usage (after ``python -m repro_torch.launch.dryrun --arch all --shape all
--both-meshes``):

  python scripts/dryrun_table.py [out/dryrun]
"""

import json
import sys
from pathlib import Path

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cell(r):
    rf = r["roofline"]
    return (f"{r['memory']['peak_bytes_est'] / 2**30:.1f} GiB; "
            f"{rf['t_compute_s']:.3g} / {rf['t_memory_s']:.3g} / "
            f"{rf['t_collective_s']:.3g} s, {rf['dominant']}; "
            f"{rf['useful_flops_fraction']:.3f}")


def main(out_dir="out/dryrun"):
    rows = {}
    for path in sorted(Path(out_dir).glob("*.json")):
        r = json.loads(path.read_text())
        rows.setdefault((r["arch"], r["mesh"]), {})[r["shape"]] = r
    print("| arch, mesh | " + " | ".join(SHAPES) + " |")
    print("|---" * (len(SHAPES) + 1) + "|")
    for (arch, mesh), by_shape in sorted(rows.items()):
        cols = [cell(by_shape[s]) if s in by_shape else "—" for s in SHAPES]
        print(f"| {arch}, {mesh} | " + " | ".join(cols) + " |")


if __name__ == "__main__":
    main(*sys.argv[1:])

#!/usr/bin/env python3
"""Run one `cuda`-marked test of ``tests/test_torch_cuda.py`` many
times in one process on the GPU and count its failures: how often a
check that reads a sum made with atomics (the gap's w(α), an
``index_add_``) parts from its tolerance.

    python3 scripts/repeat_cuda_twin.py \\
        test_multitask_k1_bit_identical_on_the_card 2d --times 20
    # the same test in another checkout (its src/ and tests/)
    python3 scripts/repeat_cuda_twin.py \\
        test_multitask_k1_bit_identical_on_the_card 2d --times 20 \\
        --root build/parent

Prints one line: the test, its parameter, the runs, the failures and
the first failure's message.
"""

import argparse
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("test", help="a test function of test_torch_cuda.py")
    ap.add_argument("param", help="its one parameter, e.g. 2d")
    ap.add_argument("--times", type=int, default=20)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent
                                          .parent),
                    help="the checkout whose src/ and tests/ to import")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root / "tests")]
    import test_torch_cuda

    fn = getattr(test_torch_cuda, args.test)
    failures, first = 0, ""
    for _ in range(args.times):
        try:
            fn(args.param)
        except AssertionError as err:
            failures += 1
            first = first or " ".join(str(err).split())[:300]
    print(f"{args.test}[{args.param}] in {root.name}: {failures} of "
          f"{args.times} runs failed" + (f"; first: {first}" if first
                                         else ""), flush=True)


if __name__ == "__main__":
    main()

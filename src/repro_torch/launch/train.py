"""The training launcher: ``--arch <id>`` trains any assigned
architecture on the Markov corpus through the fault-tolerant loop (the
counterpart of ``repro/launch/train.py``).

The smoke config by default, the published one with ``--full``; on the
card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --steps 50 --batch 4 --seq 64
"""

from __future__ import annotations

import argparse

from repro_torch.configs.registry import (
    ARCHS,
    get_config,
    get_schedule,
    get_smoke_config,
)
from repro_torch.data.lm_data import MarkovCorpus, make_lm_batch
from repro_torch.dist.mesh import resolve_device
from repro_torch.optim.schedules import make_schedule
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.step import init_train_state, make_train_step


def main(argv=None):
    """Parse ``argv``, train, print the final loss; returns the
    ``LoopReport``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true",
                    help="use the FULL config")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", choices=["topk", "int8"], default=None,
                    help="error-feedback gradient compression codec")
    ap.add_argument("--ckpt-dir", default="out/train_ckpt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if cfg.embeds_in or cfg.is_encdec:
        raise SystemExit(
            f"{args.arch}: modality-frontend archs train via examples/ "
            "drivers that synthesize frontend embeddings")
    print(f"arch={cfg.name} params={cfg.n_params()/1e6:.1f}M "
          f"schedule={get_schedule(args.arch)} device={dev}")
    state = init_train_state(cfg, 0, compress=args.compress is not None,
                             device=dev)
    schedule = make_schedule(get_schedule(args.arch), peak_lr=args.lr,
                             total_steps=args.steps,
                             warmup_steps=max(args.steps // 20, 2))
    step_fn = make_train_step(
        cfg, schedule=schedule, remat=False,
        microbatches=args.microbatches, compress_codec=args.compress)
    corpus = MarkovCorpus(cfg.vocab_size, seed=0, device=dev)
    state, report = run_training(
        state, step_fn,
        lambda t: make_lm_batch(corpus, t, batch=args.batch, seq=args.seq),
        LoopConfig(total_steps=args.steps,
                   ckpt_dir=f"{args.ckpt_dir}/{args.arch}",
                   ckpt_every=max(args.steps // 4, 5), log_every=10),
    )
    print(f"final loss {report.losses[-1]:.4f} "
          f"({report.final_step} steps, {report.n_failures} failures)")
    return report


if __name__ == "__main__":
    main()

"""Train a ~100M-parameter LM with the port's whole training stack — the
fault-tolerant loop, checkpoints, the WSD schedule, step-indexed data —
on the card unless ``--device cpu`` (the twin of ``train_lm.py``).

The default model is a 12-layer, 768-wide model of the minicpm family
(about 100M parameters); ``--small`` shrinks it for quick runs.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --small --steps 40 \
        --device cpu
"""

import argparse
import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.data.lm_data import MarkovCorpus, make_lm_batch
from repro_torch.dist.mesh import resolve_device
from repro_torch.optim.schedules import make_schedule
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.step import init_train_state, make_train_step

LM_100M = ModelConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=2048, vocab_size=8192, head_dim=64,
    tie_embeddings=True,
)

LM_SMALL = dataclasses.replace(
    LM_100M, name="lm-small", n_layers=4, d_model=256, n_heads=4,
    n_kv_heads=2, d_ff=512, vocab_size=2048)


def train(cfg, *, steps, batch, seq, lr, ckpt_dir, device=None,
          ckpt_every=None, step_deadline_s=None, **run_kw):
    """Train ``cfg`` through the loop (``run_kw``: ``run_training``'s
    ``fault_hook``, ``on_straggler``, ``log``); returns (state, report,
    the mean loss of the first 10 steps, that of the last 10)."""
    dev = resolve_device(device)
    state = init_train_state(cfg, 0, device=dev)
    schedule = make_schedule("wsd", peak_lr=lr, total_steps=steps,
                             warmup_steps=20)
    step_fn = make_train_step(cfg, schedule=schedule, remat=False)
    corpus = MarkovCorpus(cfg.vocab_size, seed=0, device=dev)

    def batch_fn(step):
        return make_lm_batch(corpus, step, batch=batch, seq=seq)

    state, report = run_training(
        state, step_fn, batch_fn,
        LoopConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                   ckpt_every=ckpt_every or max(steps // 5, 10),
                   step_deadline_s=step_deadline_s, log_every=10),
        **run_kw)
    first = sum(report.losses[:10]) / max(len(report.losses[:10]), 1)
    last = sum(report.losses[-10:]) / max(len(report.losses[-10:]), 1)
    return state, report, first, last


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt-dir", default="out/lm_ckpt_torch")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = LM_SMALL if args.small else LM_100M
    print(f"model={cfg.name} params={cfg.n_params()/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq} "
          f"device={args.device}")
    _, report, first, last = train(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"done: loss {first:.3f} → {last:.3f} "
          f"({report.final_step} steps, {report.n_failures} failures, "
          f"{len(report.restarts)} restarts)")
    assert last < first, "loss did not decrease"


if __name__ == "__main__":
    main()

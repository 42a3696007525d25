"""Serve a small LM to a batch of requests: prefill once, decode
greedily, on the card unless ``--device cpu`` (the twin of
``serve_lm.py``).

    PYTHONPATH=src python examples/serve_lm_torch.py --requests 6 --gen 24

The prompts are the reference example's tokens (``prng.randint`` from
key 1); the weights and an encoder's inputs come from a
``torch.Generator``.
"""

import argparse
import time

import torch

from repro_torch import prng
from repro_torch.configs import get_smoke_config
from repro_torch.dist.mesh import resolve_device
from repro_torch.models import init_cache, init_params, prefill
from repro_torch.models.transformer import cache_max_len
from repro_torch.serve.step import make_decode_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b",
                    help="smoke config family to serve")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = init_params(cfg, 0, device=dev)
    B, S = args.requests, args.prompt_len
    prompts = prng.randint(prng.PRNGKey(1, device=dev), (B, S), 0,
                           cfg.vocab_size)
    batch = {"tokens": prompts}
    if cfg.mrope_sections:
        batch["positions"] = torch.arange(S, device=dev)[None, None].expand(
            3, B, S)
    if cfg.family == "encdec":
        gen = torch.Generator(device=dev).manual_seed(2)
        batch["enc_embeds"] = torch.randn(
            (B, cfg.enc_len, cfg.d_model), generator=gen, device=dev) * 0.1

    cache = init_cache(cfg, B, cache_max_len(S + args.gen),
                       dtype=torch.float32, device=dev)
    t0 = time.time()
    with torch.no_grad():
        logits, cache = prefill(cfg, params, batch, cache)
    tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1).to(
        torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_prefill = time.time() - t0
    decode = make_decode_step(cfg)

    generated = [tok]
    t0 = time.time()
    for _ in range(args.gen - 1):
        step_in = {"tokens": tok[:, None]}
        if cfg.mrope_sections:
            step_in["positions"] = torch.full((3, B, 1), cache.length,
                                              dtype=torch.int64, device=dev)
        tok, logits, cache = decode(params, step_in, cache)
        generated.append(tok)
    out = torch.stack(generated, dim=1).cpu().numpy()  # (B, gen)
    t_decode = time.time() - t0
    print(f"arch={cfg.name}: {B} requests, prompt={S}, generated "
          f"{out.shape[1]} tokens each")
    print(f"prefill {t_prefill*1e3:.0f} ms; decode "
          f"{t_decode/max(args.gen-1,1)*1e3:.1f} ms/token/batch")
    for b in range(min(B, 3)):
        print(f"  req{b}: {out[b][:12].tolist()} ...")
    assert out.min() >= 0 and out.max() < cfg.vocab_size
    assert cache.length == S + args.gen - 1


if __name__ == "__main__":
    main()

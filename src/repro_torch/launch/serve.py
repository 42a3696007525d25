"""The serving launcher: ``--arch <id>`` prefills a batch of prompts and
decodes greedily with the cache-aware step, on the arch's smoke config
(the counterpart of ``repro/launch/serve.py``); on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mistral-nemo-12b --requests 4 --gen 16

The prompts' tokens are the reference's (``prng.randint`` from key 1);
the embeddings of an ``embeds_in`` arch and an encoder's inputs are
drawn from a ``torch.Generator`` (seeds 1 and 2), as are the weights
(seed 0), so they are not the reference's numbers.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import prng
from repro_torch.configs.registry import ARCHS, get_smoke_config
from repro_torch.dist.mesh import resolve_device
from repro_torch.models import init_cache, init_params
from repro_torch.models.transformer import cache_max_len
from repro_torch.serve.step import make_decode_step, make_prefill_step


def _normal(shape, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev) * 0.1


def main(argv=None):
    """Parse ``argv``, prefill and decode; returns {"tokens": (B, gen)
    int32 numpy, "cache_length": the cache's length at the end}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = init_params(cfg, 0, device=dev)
    B, S = args.requests, args.prompt_len
    batch = {}
    if cfg.embeds_in and not cfg.is_encdec:
        batch["embeds"] = _normal((B, S, cfg.d_model), 1, dev)
    else:
        batch["tokens"] = prng.randint(prng.PRNGKey(1, device=dev), (B, S),
                                       0, cfg.vocab_size)
    if cfg.mrope_sections:
        batch["positions"] = torch.arange(S, device=dev)[None, None].expand(
            3, B, S)
    if cfg.is_encdec:
        batch["enc_embeds"] = _normal((B, cfg.enc_len, cfg.d_model), 2, dev)

    cache = init_cache(cfg, B, cache_max_len(S + args.gen),
                       dtype=torch.float32, device=dev)
    t0 = time.time()
    logits, cache = make_prefill_step(cfg)(params, batch, cache)
    tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1).to(
        torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"prefill({B}x{S}) {time.time()-t0:.2f}s")
    decode = make_decode_step(cfg)
    # no host read in the loop: positions come from a host counter
    # (the cache's length is S after prefill, +1 a step) and the tokens
    # stay on the device until one copy at the end
    toks = [tok]
    pos = S
    t0 = time.time()
    for _ in range(args.gen - 1):
        step_in = {}
        if cfg.embeds_in and not cfg.is_encdec:
            step_in["embeds"] = params["embed"][tok.long()][:, None, :]
        else:
            step_in["tokens"] = tok[:, None]
        if cfg.mrope_sections:
            step_in["positions"] = torch.full((3, B, 1), pos,
                                              dtype=torch.int64, device=dev)
        tok, _, cache = decode(params, step_in, cache)
        pos += 1
        toks.append(tok)
    out = torch.stack(toks, 1).cpu().numpy()  # the one read, after the loop
    dt = (time.time() - t0) / max(args.gen - 1, 1)
    print(f"decode {dt*1e3:.1f} ms/token/batch")
    for b in range(min(B, 3)):
        print(f"  req{b}: {out[b][:10].tolist()}")
    return {"tokens": out, "cache_length": int(cache.length)}


if __name__ == "__main__":
    main()

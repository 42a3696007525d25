"""The port's launchers and the LM system paths on the CPU: the twins of
``tests/test_launchers.py`` (train, compressed, microbatched, serve,
serve on the hybrid) and of ``tests/test_system.py``'s LM training and
serving tests, all with ``device="cpu"``; the serve launcher's prompts
are the reference's tokens."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro_torch import prng
from repro_torch.configs import get_smoke_config
from repro_torch.data.lm_data import MarkovCorpus, make_lm_batch
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import init_cache, init_params, prefill
from repro_torch.models.transformer import cache_max_len
from repro_torch.optim import make_schedule
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.train import init_train_state, make_train_step


def _finite(report, steps):
    assert report.final_step == steps and report.n_failures == 0
    assert all(np.isfinite(report.losses))


def test_train_launcher(tmp_path):
    _finite(train_main(["--arch", "minitron-4b", "--steps", "8",
                        "--batch", "2", "--seq", "32", "--ckpt-dir",
                        str(tmp_path), "--device", "cpu"]), 8)


def test_train_launcher_with_compression(tmp_path):
    _finite(train_main(["--arch", "minicpm-2b", "--steps", "8", "--batch",
                        "2", "--seq", "32", "--compress", "int8",
                        "--ckpt-dir", str(tmp_path), "--device", "cpu"]), 8)


def test_train_launcher_microbatched(tmp_path):
    _finite(train_main(["--arch", "granite-moe-3b-a800m", "--steps", "6",
                        "--batch", "4", "--seq", "32", "--microbatches",
                        "2", "--ckpt-dir", str(tmp_path), "--device",
                        "cpu"]), 6)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-small"])
def test_train_launcher_refuses_frontend_archs(tmp_path, arch):
    with pytest.raises(SystemExit, match="frontend"):
        train_main(["--arch", arch, "--steps", "2", "--ckpt-dir",
                    str(tmp_path), "--device", "cpu"])


@pytest.mark.parametrize("arch,gen", [("mamba2-780m", 6),
                                      ("jamba-1.5-large-398b", 4),
                                      ("qwen2-vl-72b", 3),
                                      ("whisper-small", 3)])
def test_serve_launcher(arch, gen):
    r = serve_main(["--arch", arch, "--requests", "2", "--prompt-len", "16",
                    "--gen", str(gen), "--device", "cpu"])
    V = get_smoke_config(arch).vocab_size
    assert r["tokens"].shape == (2, gen) and r["tokens"].dtype == np.int32
    assert r["tokens"].min() >= 0 and r["tokens"].max() < V
    assert r["cache_length"] == 16 + gen - 1


def test_serve_launcher_prompts_are_the_reference_tokens():
    cfg = ref_smoke_config("mistral-nemo-12b")
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 24), 0,
                                         cfg.vocab_size))
    got = prng.randint(prng.PRNGKey(1), (4, 24), 0, cfg.vocab_size)
    np.testing.assert_array_equal(got.numpy(), want)


def test_e2e_lm_training_decreases_loss():
    """The twin of the reference's: the smoke minicpm learns the Markov
    corpus (WSD, 30 steps)."""
    cfg = get_smoke_config("minicpm-2b")
    state = init_train_state(cfg, 0, device="cpu")
    step = make_train_step(cfg, schedule=make_schedule(
        "wsd", peak_lr=5e-3, total_steps=60, warmup_steps=3), remat=False)
    corpus = MarkovCorpus(cfg.vocab_size, seed=0, device="cpu")
    losses = []
    for t in range(30):
        state, m = step(state, make_lm_batch(corpus, t, batch=4, seq=32))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def test_e2e_serve_generates():
    """The twin of the reference's: prefill and greedy decode emit tokens
    in the vocabulary and a cache that grows a token a step."""
    cfg = get_smoke_config("mistral-nemo-12b")
    params = init_params(cfg, 0, device="cpu")
    B, S = 2, 16
    prompt = {"tokens": prng.randint(prng.PRNGKey(1), (B, S), 0,
                                     cfg.vocab_size)}
    cache = init_cache(cfg, B, cache_max_len(S + 8), dtype=torch.float32,
                       device="cpu")
    logits, cache = make_prefill_step(cfg)(params, prompt, cache)
    decode = make_decode_step(cfg)
    tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1).to(
        torch.int32)
    outs = []
    for _ in range(5):
        tok, logits, cache = decode(params, {"tokens": tok[:, None]}, cache)
        assert tok.dtype == torch.int32 and tok.shape == (B,)
        outs.append(tok)
    toks = torch.stack(outs).numpy()
    assert toks.min() >= 0 and toks.max() < cfg.vocab_size
    assert cache.length == S + 5


def test_decode_step_is_the_greedy_argmax_over_the_real_vocabulary():
    """The padded columns [vocab, Vp) never win, however large."""
    cfg = dataclasses.replace(get_smoke_config("minicpm-2b"),
                              vocab_size=500)  # 12 padded columns
    params = init_params(cfg, 0, device="cpu")
    decode = make_decode_step(cfg)

    def run():
        cache = init_cache(cfg, 2, cache_max_len(8), dtype=torch.float32,
                           device="cpu")
        _, cache = prefill(cfg, params, {"tokens": torch.zeros(
            (2, 4), dtype=torch.int64)}, cache)
        return decode(params, {"tokens": torch.ones((2, 1),
                                                    dtype=torch.int64)},
                      cache)[:2]

    tok, logits = run()
    best = int(tok[0])
    assert float(logits[0, -1, best]) > 0
    # the padded rows of the tied head: ten times the best row's logit
    params["embed"][cfg.vocab_size:] = 10 * params["embed"][best]
    tok2, logits2 = run()
    assert int(logits2[0, -1].argmax()) >= cfg.vocab_size
    assert int(tok2[0]) == best
    assert torch.equal(tok2, torch.argmax(
        logits2[:, -1, :cfg.vocab_size], dim=-1).to(torch.int32))

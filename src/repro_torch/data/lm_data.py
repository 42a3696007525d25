"""The deterministic, step-indexed LM data of the training loop (the
counterpart of ``repro/data/lm_data.py``).

The batch of step t is a pure function of (seed, t), so a restart from
a checkpoint at step t reads the same data with no iterator state to
keep, and a replayed step reads what the failed one read.  The corpus is
a synthetic bigram chain: each symbol prefers about 8 successors, so the
loss of a model that learns it falls.

``batch_at`` gives the reference's tokens bit for bit: its bigram tables
come from the same ``np.random.default_rng(seed)`` draws, and its keys
and draws from ``repro_torch.prng``'s counterparts of ``fold_in``,
``split``, ``randint`` and ``gumbel``.  The reference draws one
categorical a position inside a scan; the keys of those draws do not
depend on the tokens, so the port draws a batch's Gumbel noise in one
call and keeps only the gather and the argmax over a symbol's
successors sequential.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import prng
from repro_torch.dist.mesh import resolve_device


@dataclasses.dataclass
class MarkovCorpus:
    """A bigram LM over ``vocab_size`` symbols, its tables on ``device``
    (the card unless the caller asks for the CPU)."""

    vocab_size: int
    seed: int = 0
    temperature: float = 0.7
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        V = self.vocab_size
        n = min(8, V)
        nexts = rng.integers(0, V, size=(V, n))
        logits = (rng.standard_normal((V, n)).astype(np.float32)
                  / np.float32(self.temperature))
        self._nexts = torch.from_numpy(nexts).to(self.device)
        self._logits = torch.from_numpy(logits).to(self.device)

    def batch_at(self, step: int, batch: int, seq: int) -> torch.Tensor:
        """(batch, seq + 1) int32 tokens on the corpus's device — a pure
        function of (seed, step)."""
        key = prng.fold_in(prng.PRNGKey(self.seed, device=self.device),
                           step)
        keys = prng.split(prng.split(key, batch))  # (batch, 2, 2)
        k0, kscan = keys[:, 0], keys[:, 1]
        tok = prng.randint(k0, (), 0, self.vocab_size)  # (batch,)
        noise = prng.gumbel(prng.split(kscan, seq),
                            (self._logits.shape[1],))  # (batch, seq, n)
        toks = [tok]
        for t in range(seq):
            choice = torch.argmax(noise[:, t] + self._logits[tok], dim=-1)
            tok = self._nexts[tok, choice]
            toks.append(tok)
        return torch.stack(toks, dim=1).to(torch.int32)


def make_lm_batch(corpus: MarkovCorpus, step: int, batch: int, seq: int):
    """{'tokens': (B, S), 'labels': (B, S)}: ``cross_entropy`` shifts
    inside, so the labels are the same token stream."""
    toks = corpus.batch_at(step, batch, seq)[:, :seq]
    return {"tokens": toks, "labels": toks}

"""The four assigned input shapes and the (arch × shape) cell enumeration.

    train_4k     seq_len=4,096    global_batch=256   lowers train_step
    prefill_32k  seq_len=32,768   global_batch=32    lowers prefill_step
    decode_32k   seq_len=32,768   global_batch=128   lowers serve_step
                                                     (1 new token, KV cache
                                                     of seq_len)
    long_500k    seq_len=524,288  global_batch=1     lowers serve_step;
                                                     sub-quadratic archs ONLY

Skips (DESIGN.md §4): ``long_500k`` runs only for sub_quadratic archs
(mamba2-780m, jamba-1.5-large-398b); full-attention archs skip it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode needs sub-quadratic"
    return True, ""


def cells_for_arch(cfg: ModelConfig) -> List[InputShape]:
    return [s for s in SHAPES.values() if shape_applicable(cfg, s)[0]]

"""minitron-4b — pruned nemotron [arXiv:2407.14679; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    head_dim=128,
)

SMOKE = ModelConfig(
    name="minitron-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    head_dim=16,
)

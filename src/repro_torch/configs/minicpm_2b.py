"""minicpm-2b — WSD schedule, llama-like arch [arXiv:2404.06395; hf].

40L d_model=2304 36H (full MHA kv=36) d_ff=5760 vocab=122753.
The WSD (warmup-stable-decay) schedule lives in
``repro_torch.optim.schedules`` and is selected by this config's
``SCHEDULE`` hint in the launcher.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    head_dim=64,
    tie_embeddings=True,
)

SCHEDULE = "wsd"

SMOKE = ModelConfig(
    name="minicpm-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=6,
    d_ff=192,
    vocab_size=512,
    head_dim=16,
    tie_embeddings=True,
)

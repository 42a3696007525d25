"""mistral-nemo-12b — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128
(explicit in the HF config — not d_model/n_heads).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="mistral-nemo-12b-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    head_dim=32,
    rope_theta=1e6,
)

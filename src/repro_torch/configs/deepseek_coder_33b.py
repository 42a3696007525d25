"""deepseek-coder-33b — llama-arch [arXiv:2401.14196; hf].

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    head_dim=128,
)

SMOKE = ModelConfig(
    name="deepseek-coder-33b-smoke",
    family="dense",
    n_layers=2,
    d_model=112,
    n_heads=7,
    n_kv_heads=1,
    d_ff=224,
    vocab_size=512,
    head_dim=16,
)

"""qwen2-vl-72b — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
Backbone only: the vision frontend is a STUB — ``input_specs()`` feeds
precomputed patch/text embeddings plus (3, B, S) M-RoPE position ids.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    embeds_in=True,
)

SMOKE = ModelConfig(
    name="qwen2-vl-72b-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=32,
    rope_theta=1e6,
    mrope_sections=(4, 6, 6),
    embeds_in=True,
)

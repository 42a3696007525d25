"""jamba-1.5-large-398b — Mamba+attention 1:7 interleave, MoE
[arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Period of 8 layers: 7 Mamba + 1 attention; MoE MLP every 2nd layer.
Hybrid ⇒ sub-quadratic ⇒ runs long_500k (attention layers decode O(L)).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    moe_dispatch="einsum",
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    n_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_period=8,
    ssm_state=16,  # Jamba uses Mamba-1-style small state
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_kernel=4,
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="jamba-1.5-large-398b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    n_experts=4,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_period=2,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_chunk=8,
    conv_kernel=4,
    sub_quadratic=True,
)

"""mamba2-780m — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1536, attention-free, vocab=50280, ssm_state=128.
Pure-SSM: no d_ff MLP (Mamba2 blocks only), sub-quadratic ⇒ runs
long_500k.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=0,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_kernel=4,
    tie_embeddings=True,
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    head_dim=0,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_chunk=16,
    conv_kernel=4,
    tie_embeddings=True,
    sub_quadratic=True,
)

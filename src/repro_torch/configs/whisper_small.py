"""whisper-small — enc-dec, conv frontend (stub) [arXiv:2212.04356].

12L (decoder) + 12L encoder, d_model=768 12H (MHA kv=12) d_ff=3072
vocab=51865.  The mel-spectrogram conv stem is a STUB: ``input_specs()``
provides precomputed (B, enc_len, d_model) frame embeddings.  Decoder
shapes follow the assigned seq_len; encoder length is whisper's fixed
1500 frames (30 s), reduced in smoke configs.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    n_enc_layers=12,
    enc_len=1500,
    embeds_in=True,  # encoder input: precomputed frame embeddings
)

SMOKE = ModelConfig(
    name="whisper-small-smoke",
    family="encdec",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    n_enc_layers=2,
    enc_len=64,
    embeds_in=True,
)

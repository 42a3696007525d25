"""Model configuration dataclass shared by all 10 assigned architectures."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1  # MoE MLP on layers where (layer % moe_every == moe_offset)
    moe_offset: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "scatter"  # "scatter" (zero-FLOP) | "einsum" (GShard)
    moe_ep_resident: bool = True  # experts owned per-device (no FSDP dim)
    moe_remat_groups: bool = True  # jax.checkpoint around each MoE group

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_kernel: int = 4

    # --- hybrid (Jamba): period of `attn_period` layers, last one is attention
    attn_period: int = 0

    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_len: int = 1500  # whisper 30 s @ 50 Hz after conv stem (stubbed)

    # --- positions / misc ---
    rope_theta: float = 1e4
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # does the arch support 500k-token decode (sub-quadratic path)?
    sub_quadratic: bool = False
    # inputs are precomputed modality embeddings instead of token ids
    embeds_in: bool = False

    def __post_init__(self):
        if self.head_dim is None and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included once; used for
        MODEL_FLOPS = 6·N·D in the roofline)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim or 0
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d if self.n_heads else 0
        mlp_dense = 3 * d * f  # SwiGLU
        ssm = 0
        if self.ssm_state:
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = d * (2 * di + 2 * ns + nh) + di * d \
                + (di + 2 * ns) * self.conv_kernel + nh * ns  # in/out/conv/D
        total = 0
        for layer in range(self.n_layers):
            if self.family == "ssm":
                total += ssm + mlp_dense if self.d_ff else ssm
            elif self.family == "hybrid":
                is_attn = (layer % self.attn_period) == self.attn_period - 1
                total += att if is_attn else ssm
                is_moe = self.n_experts and (layer % self.moe_every
                                             == self.moe_offset)
                total += (self.n_experts * 3 * d * f) if is_moe else mlp_dense
            elif self.family in ("moe",):
                total += att + self.n_experts * 3 * d * f + d * self.n_experts
            else:
                total += att + mlp_dense
            total += 2 * d  # norms
        total += v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # lm head
        if self.is_encdec:
            enc = self.n_enc_layers * (att + mlp_dense + 2 * d)
            crs = self.n_layers * att  # cross-attention
            total += enc + crs
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense_moe = self.n_experts * 3 * d * f
        active_moe = self.top_k * 3 * d * f
        n_moe_layers = (
            len([l for l in range(self.n_layers)
                 if l % self.moe_every == self.moe_offset])
            if self.family == "hybrid" else self.n_layers
        )
        return self.n_params() - n_moe_layers * (dense_moe - active_moe)

"""Shared model primitives on PyTorch: RMSNorm, RoPE / M-RoPE, SwiGLU and
the initialisers (counterpart of ``repro/models/layers.py``).

Parameters are plain tensors.  Matrix products run in the parameters'
dtype with float32 accumulation: bf16 operands give a bf16 product (the
card's tensor cores accumulate in float32), float32 operands a float32
product end to end.  The initialisers draw from an explicit
``torch.Generator`` on the tensors' device; they give other numbers
than the reference's ``jax.random`` from the same seed, so the tests
carry the reference's parameters across (``repro_torch.convert.
params_from_numpy``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

ACC = torch.float32


def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.to(ACC)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.to(ACC)).to(x.dtype)


def dense(x, w):
    """x @ w over x's last dimension, accumulated in float32, in x's
    dtype."""
    return torch.matmul(x, w.to(x.dtype))


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(dense(x, w_gate)) * dense(x, w_up)
    return dense(h, w_down)


def remat_call(fn, *args, remat: bool = True):
    """``fn(*args)``, its activations recomputed in the backward pass
    (``jax.checkpoint``'s counterpart) when ``remat`` and gradients are
    on."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------- RoPE ----


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    exps = torch.arange(half, dtype=ACC, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float, sections=None):
    """Rotate-half RoPE.

    x: (B, S, H, hd).  positions: (B, S) integers, or (3, B, S) for
    M-RoPE with ``sections`` (s_t, s_h, s_w) summing to hd // 2 — each
    frequency band takes its angle from the temporal, height or width
    position stream (Qwen2-VL's M-RoPE)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(hd, theta, x.device)  # (half,)
    positions = torch.as_tensor(positions, device=x.device)
    if sections is not None:
        if positions.dim() != 3 or sum(sections) != half:
            raise ValueError(f"M-RoPE needs (3, B, S) positions and "
                             f"sections summing to {half}, got "
                             f"{tuple(positions.shape)} and {sections}")
        sec_id = torch.repeat_interleave(
            torch.arange(3, device=x.device),
            torch.tensor(sections, device=x.device))  # (half,)
        pos = positions.to(ACC)[sec_id]  # (half, B, S)
        angles = torch.einsum("hbs,h->bsh", pos, freqs)  # (B, S, half)
    else:
        if positions.dim() == 3:  # M-RoPE ids fed to a non-M-RoPE arch
            positions = positions[0]
        angles = positions.to(ACC)[..., None] * freqs  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]  # (B, S, 1, half)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].to(ACC), x[..., half:].to(ACC)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- init ----


def he_init(generator, shape, dtype, fan_in=None):
    """N(0, 1/fan_in) (fan_in defaults to shape[0]) on the generator's
    device, drawn in float32 and cast."""
    fan_in = fan_in if fan_in is not None else shape[0]
    t = torch.randn(shape, generator=generator, dtype=ACC,
                    device=generator.device)
    return t.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def embed_init(generator, shape, dtype):
    t = torch.randn(shape, generator=generator, dtype=ACC,
                    device=generator.device)
    return t.mul_(0.02).to(dtype)

"""Device and launch-width policy of the port — the counterpart of the
part of ``repro/dist/mesh.py`` this slice uses.

``resolve_device`` is where every entry point decides where it runs:
on the card unless the caller asks for the CPU, and never quietly on the
CPU when the card is missing.  ``lane_pad`` and ``cta_threads`` size a
kernel's thread block.  The reference's 128-lane padding of d and k is
TPU tiling, not semantics: the CUDA kernels take any width, so the port
pads nothing but the thread count, which rounds up to whole warps.
"""

from __future__ import annotations

import torch

WARP = 32
MAX_CTA_THREADS = 256


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for (or
    defaulted to) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU unless the "
            "caller passes device='cpu'")
    return dev


def lane_pad(d: int, lanes: int = WARP) -> int:
    """Round ``d`` up to a multiple of ``lanes`` (a warp by default)."""
    return ((d + lanes - 1) // lanes) * lanes


def cta_threads(width: int) -> int:
    """Threads of the one CTA that runs a DCD kernel over rows of
    ``width`` entries: one thread per entry, in whole warps, at most
    ``MAX_CTA_THREADS`` (wider rows loop)."""
    return min(lane_pad(max(int(width), 1)), MAX_CTA_THREADS)

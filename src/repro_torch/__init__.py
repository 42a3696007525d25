"""PASSCoDe on PyTorch and CUDA for NVIDIA Hopper — the port of the JAX
package ``repro`` (which stays the reference).

The module layout mirrors ``repro``: ``repro_torch.core.sharded`` is the
counterpart of ``repro.core.sharded`` and so on.  Entry points run on
the card unless the caller passes ``device="cpu"``; the hand-written
CUDA kernels live in ``repro_torch.kernels`` beside their plain PyTorch
versions.  This package imports torch and numpy, never jax or repro.
"""

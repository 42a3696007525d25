"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.

  dcd_ell.py   — B1, indexed DCD over an ELL shard (csrc/dcd_ell.cu)
  dcd_block.py — B2, indexed DCD over a dense shard, and B3, the in-order
                 dense epoch (csrc/dcd_block.cu)
  dcd_feature.py — B4, the block Gram of the feature-sharded round, and
                 B5, its δ-recursion (csrc/dcd_feature.cu)
  ops.py       — the reference's entry points and padding contract, and
                 the (α, Δw) block engines the solvers run per round,
                 over a grid of p data shards (``(p, B)`` ids)
  ref.py       — the plain in-order epoch oracle of B3
  build.py     — nvcc build into build/repro_torch_kernels/, ctypes load
  csrc/        — the CUDA sources; dcd_delta.cuh holds the δ the DCD
                 kernels share
"""

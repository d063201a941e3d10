"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  ops         dispatch wrappers: kernel for CUDA tensors, plain version
              for CPU tensors, launch counts
  fused_turn  ctypes launches of ``csrc/fused_turn.cu`` (IVF)
  pq_adc      ctypes launches of ``csrc/pq_adc.cu`` (IVF-PQ)
  ref         plain PyTorch versions of the kernels
  sorting     the tie-aware top-k order the kernels keep
  tiling      padding contract and shared-memory caps
"""
from repro_torch.kernels import ops, ref, sorting, tiling  # noqa: F401

"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  ops              dispatch wrappers: kernel for CUDA tensors, plain
                   version for CPU tensors, launch counts
  fused_turn       ctypes launches of ``csrc/fused_turn.cu`` (IVF)
  pq_adc           ctypes launches of ``csrc/pq_adc.cu`` (IVF-PQ)
  flash_attention  ctypes launch of ``csrc/flash_attention.cu`` (the
                   bi-encoder's attention, forward)
  flash_decode     ctypes launch of ``csrc/flash_decode.cu`` (the LM's
                   decode attention over its KV cache)
  embedding_bag    ctypes launch of ``csrc/embedding_bag.cu`` (the
                   two-tower user history bag, forward)
  ref              plain PyTorch versions of the kernels
  sorting          the tie-aware top-k order the kernels keep
  tiling           padding contract, shared-memory caps, merge plan
"""
from repro_torch.kernels import ops, ref, sorting, tiling  # noqa: F401

"""PyTorch/CUDA port of the TopLoc conversational-search system.

A second package beside the JAX reference (``repro``): the same module
layout, the same index/session layouts and the same cost counters, in
PyTorch, with every Pallas kernel of the ported path replaced by a
hand-written CUDA kernel for Hopper (``kernels/csrc``).  The package
imports ``torch`` and ``numpy`` only — never ``jax``, never ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``repro_torch.device``); on the CPU the kernel wrappers take their
plain PyTorch versions.
"""
import torch

# The reference contract is full float32: every product the JAX package
# computes (XLA dots, Pallas MXU dots at precision="f32") accumulates in
# f32.  TF32 keeps ~3 decimal digits and would move scores far outside
# the port's 1e-5 tolerance, so it is switched off for matmuls and
# convolutions alike before any entry point runs.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

"""Synthetic CAsT-like workload, its token view, and the hash tokenizer
(numpy copies of the reference's recipes)."""
from repro_torch.data import synthetic, tokenizer  # noqa: F401

"""Synthetic CAsT-like workload, its token view, the hash tokenizer and
the graph substrate (numpy copies of the reference's recipes)."""
from repro_torch.data import graph, synthetic, tokenizer  # noqa: F401

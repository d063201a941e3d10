"""Synthetic CAsT-like workload (numpy copy of the reference's recipe)."""
from repro_torch.data import synthetic  # noqa: F401

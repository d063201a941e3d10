"""Core library of the port: TopLoc sessions and the IVF substrate.

  backend  — RetrievalBackend registry (``IVFBackend`` in this slice)
  ivf      — bucketed-padded IVF index (build / search / search_cached)
  toploc   — TopLoc sessions, ``FusedTurn`` and the generic drivers
  kmeans   — balanced k-means, chunked over points (index build)
  topk     — top-k selection in ``lax.top_k`` order
"""
from repro_torch.core import backend, ivf, kmeans, topk, toploc  # noqa: F401
from repro_torch.core.backend import IVFBackend, RetrievalBackend  # noqa: F401

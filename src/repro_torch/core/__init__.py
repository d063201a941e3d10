"""Core library of the port: TopLoc sessions, the IVF and HNSW substrates.

  backend  — RetrievalBackend registry (``IVFBackend``, ``IVFPQBackend``,
             ``HNSWBackend``, ``ExactBackend``)
  hnsw     — HNSW index: host build, one-kernel-per-query search
  ivf      — bucketed-padded IVF index (build / search / search_cached)
  pq       — product quantisation, ``IVFPQIndex`` / ``build_ivf_pq``
  toploc   — TopLoc sessions, ``FusedTurn`` and the generic drivers
  kmeans   — balanced k-means, chunked over points (index build; ++
             seeding for the PQ codebooks)
  topk     — top-k selection in ``lax.top_k`` order
"""
from repro_torch.core import (  # noqa: F401
    backend, hnsw, ivf, kmeans, pq, topk, toploc)
from repro_torch.core.backend import (  # noqa: F401
    ExactBackend, HNSWBackend, IVFBackend, IVFPQBackend, RetrievalBackend)

"""Corpus sharding over a grid of devices, and its collectives.

  sharding     — ``Axes`` / ``from_mesh`` and the index placement specs
                 (``ivf_index_specs``, ``ivf_pq_index_specs``,
                 ``hnsw_index_specs``)
  collectives  — ``all_gather`` / ``psum`` over per-shard tensors, and
                 the building blocks ``sharded_corpus_topk`` /
                 ``sharded_ivf_probe``
  retrieval    — ``RetrievalMesh``, index placement, the sharded scans
                 plugged into the backends (``shard_backend``)

The reference runs every shard from one controller (``shard_map`` over
``jax.devices()`` of one process); so does the port: a mesh is a grid
of ``torch.device``s in one process, and a collective is an explicit
function over the shards' tensors.

  fault        — ``FailureInjector`` and ``run_with_restarts``, the
                 training launcher's restart drill

The multi-process parts of the reference's package (the parameter
specs, ``elastic``) come with ``torch.distributed`` (ROADMAP Queue 1,
item 7, part 3).
"""
from repro_torch.distributed import (collectives, fault,  # noqa: F401
                                     retrieval, sharding)

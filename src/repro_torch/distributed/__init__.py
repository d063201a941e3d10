"""Corpus sharding over a grid of devices, and its collectives.

  sharding     — ``Axes`` / ``from_mesh``, the model specs (LM, GIN,
                 recsys, encoder, optimizer; ``module_specs``) and the
                 index placement specs (``ivf_index_specs``,
                 ``ivf_pq_index_specs``, ``hnsw_index_specs``)
  elastic      — ``choose_mesh_shape``, ``make_elastic_mesh`` and
                 ``replace_on_mesh`` (a host tree placed by its specs)
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

Training across a process group (``torch.distributed``) is not ported
yet (ROADMAP Queue 1, item 7).
"""
from repro_torch.distributed import (collectives, elastic,  # noqa: F401
                                     fault, retrieval, sharding)

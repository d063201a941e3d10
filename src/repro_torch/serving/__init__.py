"""Conversational serving: the sequential and batched engines, the
session store, the micro-batching scheduler, the result cache and the
replica router (``ReplicatedSearchEngine``).
"""
from repro_torch.serving import (  # noqa: F401
    engine, result_cache, router, scheduler, sessions)
from repro_torch.serving.engine import (  # noqa: F401
    BatchedConversationalSearchEngine, ConversationalSearchEngine,
    ServingConfig, TurnRecord)
from repro_torch.serving.result_cache import CacheEntry, ResultCache  # noqa: F401
from repro_torch.serving.router import ReplicatedSearchEngine  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    HedgedExecutor, MicroBatcher, Request)
from repro_torch.serving.sessions import (  # noqa: F401
    SessionStore, hnsw_session_store, ivf_pq_session_store,
    ivf_session_store, store_for_backend)

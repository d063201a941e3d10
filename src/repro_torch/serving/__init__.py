"""Conversational serving: the sequential ``ConversationalSearchEngine``."""
from repro_torch.serving import engine  # noqa: F401
from repro_torch.serving.engine import (  # noqa: F401
    ConversationalSearchEngine, ServingConfig, TurnRecord)

"""Inference entry points of the port: the predictor with its dense KV
cache and chunked decode, and the paged serving engine."""
from .llm import LLMPredictor, init_cache
from .serving import (BlockManager, Completion, DeadlineExceededError,
                      PagedServingEngine, RejectedError, TokenEvent)

__all__ = ["LLMPredictor", "init_cache", "PagedServingEngine", "TokenEvent",
           "Completion", "BlockManager", "RejectedError",
           "DeadlineExceededError"]

"""Inference entry points of the port: the predictor with its dense KV
cache and chunked decode, the paged serving engine, and the serving
names the reference's `paddle_tpu/inference/__init__.py:24-35`
re-exports. The reference's `Config`, `Predictor`, `create_predictor`,
`PrecisionType` and `PlaceType` load `jit.save`'s programs and come with
`jit` (ROADMAP item 9)."""
from .llm import LLMPredictor, init_cache
from .serving import (BlockManager, Completion, DeadlineExceededError,
                      FailoverMismatchError, PagedServingEngine,
                      RejectedError, Request, ServingEngine, ServingRouter,
                      TokenEvent)

__all__ = ["LLMPredictor", "init_cache", "ServingEngine", "Request",
           "Completion", "PagedServingEngine", "TokenEvent", "BlockManager",
           "RejectedError", "DeadlineExceededError", "ServingRouter",
           "FailoverMismatchError"]

from .batching import PagedKVCache, Request, RequestQueue, Slot
from .engine import Engine, ServeConfig, sample_tokens
from .server import BatchConfig, BatchServer, ServeReport

__all__ = ["BatchConfig", "BatchServer", "Engine", "PagedKVCache", "Request",
           "RequestQueue", "ServeConfig", "ServeReport", "Slot",
           "sample_tokens"]

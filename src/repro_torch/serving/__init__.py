"""Greedy continuous-batching serving over the paged KV cache."""

from .config import DATAPATHS, EngineConfig
from .engine import Request, ServeEngine, sequential_generate
from .paging import PageAllocator, PageTable, pad_pow2, pages_needed

__all__ = ["DATAPATHS", "EngineConfig", "Request", "ServeEngine",
           "sequential_generate", "PageAllocator", "PageTable", "pad_pow2",
           "pages_needed"]

"""Continuous-batching serving over the paged KV cache: greedy and seeded
sampling, logprobs, speculative decoding."""

from .config import DATAPATHS, EngineConfig
from .engine import Request, ServeEngine, sequential_generate
from .paging import PageAllocator, PageTable, pad_pow2, pages_needed
from .sampling import SamplingParams

__all__ = ["DATAPATHS", "EngineConfig", "Request", "SamplingParams",
           "ServeEngine", "sequential_generate", "PageAllocator",
           "PageTable", "pad_pow2", "pages_needed"]

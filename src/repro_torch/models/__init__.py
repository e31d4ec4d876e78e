"""The decoder LM on the paged serving cache (attention + dense FFN)."""

from .transformer import (init_paged_cache, init_params, paged_decode_step,
                          paged_prefill)

__all__ = ["init_params", "init_paged_cache", "paged_decode_step",
           "paged_prefill"]

"""The decoder LM (attention + dense FFN or MoE): training forward and
loss, and serving on the paged cache."""

from .transformer import (forward, init_paged_cache, init_params, loss_fn,
                          paged_decode_step, paged_prefill)

__all__ = ["init_params", "forward", "loss_fn", "init_paged_cache",
           "paged_decode_step", "paged_prefill"]

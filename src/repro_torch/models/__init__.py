"""The decoder LM (attention, mamba or rwkv6 mixers; dense FFN, MoE or
the rwkv channel mix): training forward and loss, and serving on the
paged cache."""

from .transformer import (forward, gather_state_rows, init_paged_cache,
                          init_params, loss_fn, paged_decode_step,
                          paged_prefill, scatter_state_rows)

__all__ = ["init_params", "forward", "loss_fn", "init_paged_cache",
           "paged_decode_step", "paged_prefill", "gather_state_rows",
           "scatter_state_rows"]

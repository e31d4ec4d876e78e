"""The decoder LM (attention, mamba or rwkv6 mixers; dense FFN, MoE or
the rwkv channel mix), the encoder and the front-end stubs: training
forward and loss, serving on the dense cache and on the paged cache, and
the serving and training meshes' layouts."""

from .transformer import (batch_specs, cache_specs, decode_step, forward,
                          gather_state_rows, init_cache, init_paged_cache,
                          init_params, loss_fn, make_dummy_batch,
                          paged_cache_specs, paged_decode_step, paged_prefill,
                          paged_verify_step, param_specs, prefill,
                          scatter_state_rows, select_state_snapshot,
                          supports_paged_prefill)

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "decode_step",
           "prefill", "init_paged_cache", "paged_decode_step",
           "paged_prefill", "paged_verify_step", "gather_state_rows",
           "scatter_state_rows", "select_state_snapshot", "param_specs",
           "paged_cache_specs", "cache_specs", "supports_paged_prefill",
           "batch_specs",
           "make_dummy_batch"]

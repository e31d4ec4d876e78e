"""stablelm-2-1.6b [dense]: LayerNorm + 25% partial rotary, MHA (kv=32).

[hf:stabilityai/stablelm-2-1_6b] 24L d=2048 32H d_ff=5632 vocab=100352,
as the reference's config.
"""

from ._default_quant import DEFAULT_SC
from .base import LayerSpec, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab_size=100352,
    period=(LayerSpec("attn", "dense"),),
    norm="layernorm", ffn_act="silu", ffn_gated=True,
    rope_fraction=0.25,
    quant=DEFAULT_SC,
))

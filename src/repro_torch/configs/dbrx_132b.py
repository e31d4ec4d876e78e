"""dbrx-132b [moe]: 16 experts top-4, fine-grained, LayerNorm.

[hf:databricks/dbrx-base] 40L d=6144 48H (kv=8) expert d_ff=10752
vocab=100352, as the reference's config.
"""

from ._default_quant import DEFAULT_SC
from .base import LayerSpec, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    period=(LayerSpec("attn", "moe"),),
    norm="layernorm", ffn_act="silu", ffn_gated=True,
    rope_theta=500_000.0,
    n_experts=16, n_experts_per_tok=4,
    quant=DEFAULT_SC,
))

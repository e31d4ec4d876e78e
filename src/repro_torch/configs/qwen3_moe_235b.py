"""qwen3-moe-235b-a22b [moe]: 128 experts top-8, QK-norm, GQA kv=4.

[hf:Qwen/Qwen3-30B-A3B scaled per assignment] 94L d=4096 64H (kv=4)
expert d_ff=1536 vocab=151936, as the reference's config.  Expert
weights are ~87% of the active parameters: the largest SC-quantization
target of the model zoo.
"""

from ._default_quant import DEFAULT_SC
from .base import LayerSpec, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab_size=151936,
    period=(LayerSpec("attn", "moe"),),
    norm="rmsnorm", ffn_act="silu", ffn_gated=True, qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128, n_experts_per_tok=8,
    quant=DEFAULT_SC,
))

"""granite-3.0-2b [dense]: GQA kv=8, SwiGLU, RMSNorm.

[hf:ibm-granite/granite-3.0-2b-base] 40L d=2048 32H (kv=8) d_ff=8192
vocab=49155 (padded to 49408), as the reference's config.
"""

from ._default_quant import DEFAULT_SC
from .base import LayerSpec, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=49155,
    period=(LayerSpec("attn", "dense"),),
    norm="rmsnorm", ffn_act="silu", ffn_gated=True,
    quant=DEFAULT_SC,
))

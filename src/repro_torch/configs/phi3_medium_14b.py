"""phi3-medium-14b [dense]: RoPE, SwiGLU, GQA kv=10.

[arXiv:2404.14219] 40L d=5120 40H (kv=10) d_ff=17920 vocab=100352, as
the reference's config.
"""

from ._default_quant import DEFAULT_SC
from .base import LayerSpec, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab_size=100352,
    period=(LayerSpec("attn", "dense"),),
    norm="rmsnorm", ffn_act="silu", ffn_gated=True,
    quant=DEFAULT_SC,
))

"""nemotron-4-15b [dense]: squared-ReLU FFN (ungated), partial rotary,
GQA kv=8, LayerNorm.

[arXiv:2402.16819] 32L d=6144 48H (kv=8) d_ff=24576 vocab=256000, as the
reference's config.  Squared ReLU is monotone, so the paper's BSN + SI
realizes this FFN activation exactly.
"""

from ._default_quant import DEFAULT_SC
from .base import LayerSpec, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24576, vocab_size=256000,
    period=(LayerSpec("attn", "dense"),),
    norm="layernorm", ffn_act="relu2", ffn_gated=False,
    rope_fraction=0.5,
    quant=DEFAULT_SC,
))

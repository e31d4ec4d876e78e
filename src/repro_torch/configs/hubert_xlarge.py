"""hubert-xlarge [audio]: encoder only, bidirectional, conv-stem stub.

48L d=1280 16H (head 80) d_ff=5120 vocab=504 (masked-cluster
prediction), as the reference's config.  An encoder has no decode step:
it is served whole through ``models.forward``.  The 7-layer conv stem is
the stub front end: a batch brings (B, T, 512) frame features, one
projection maps them into the model width, and the positions come from
the stubbed conv positional encoding, so ``rope_fraction=0``.
"""

from ._default_quant import DEFAULT_SC
from .base import LayerSpec, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504,
    period=(LayerSpec("attn", "dense"),),
    norm="layernorm", ffn_act="gelu", ffn_gated=False,
    causal=False, rope_fraction=0.0,
    frontend="audio_stub",
    quant=DEFAULT_SC,
))

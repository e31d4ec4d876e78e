"""rwkv6-7b "Finch" [ssm]: attention-free, data-dependent decay.

[arXiv:2404.05892; hf] 32L d=4096 d_ff=14336 vocab=65536, 64 wkv heads
of 64, as the reference's config.  Every layer is the rwkv6 time mix and
the rwkv channel mix; the serving state is O(1) in the context length.
"""

from ._default_quant import DEFAULT_SC
from .base import LayerSpec, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,  # 64 wkv heads
    d_ff=14336, vocab_size=65536,
    period=(LayerSpec("rwkv6", "rwkv_cmix"),),
    norm="layernorm", rwkv_head_dim=64,
    quant=DEFAULT_SC,
))

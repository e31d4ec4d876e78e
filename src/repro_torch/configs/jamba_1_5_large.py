"""jamba-1.5-large-398b [hybrid]: Mamba + attention 7:1, MoE 16e top-2.

[arXiv:2403.19887; hf] 72L d=8192 64H (kv=8) d_ff=24576 vocab=65536, as
the reference's config: a period of 8 layers (attention at index 4,
MoE on the odd indices) repeated 9 times.
"""

from ._default_quant import DEFAULT_SC
from .base import LayerSpec, ModelConfig, register_arch

_M, _A = "mamba", "attn"
_D, _E = "dense", "moe"
PERIOD = tuple(
    LayerSpec(_A if i == 4 else _M, _E if i % 2 == 1 else _D)
    for i in range(8))

CONFIG = register_arch(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    period=PERIOD,
    norm="rmsnorm", ffn_act="silu", ffn_gated=True,
    n_experts=16, n_experts_per_tok=2,
    mamba_expand=2, mamba_d_state=16, mamba_d_conv=4,
    opt_state_dtype="bfloat16",
    quant=DEFAULT_SC,
))

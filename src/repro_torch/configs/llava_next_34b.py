"""llava-next-34b [vlm]: a Yi-34B-class LM backbone behind an anyres
vision stub.

60L d=7168 56H (GQA kv=8, a group of 7) d_ff=20480 vocab=64000, as the
reference's config.  The front end is a stub: a batch brings precomputed
patch embeddings (B, S_img, 1024), which two projections map into the
model width ahead of the text tokens (anyres tiling: 4 tiles and the
base image, 5 x 576 = 2880 image tokens).
"""

from ._default_quant import DEFAULT_SC
from .base import LayerSpec, ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    period=(LayerSpec("attn", "dense"),),
    norm="rmsnorm", ffn_act="silu", ffn_gated=True,
    rope_theta=5_000_000.0,
    frontend="vision_stub",
    quant=DEFAULT_SC,
))

IMG_TOKENS = 2880   # 5 anyres tiles x 576

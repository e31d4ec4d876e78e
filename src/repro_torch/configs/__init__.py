"""Architecture registry: importing this package registers every
config."""

from . import (dbrx_132b, granite_3_2b, hubert_xlarge, jamba_1_5_large,
               llava_next_34b, nemotron_4_15b, paper_tnn, phi3_medium_14b,
               qwen3_moe_235b, rwkv6_7b, stablelm_1_6b)
from .base import (SHAPES, LayerSpec, ModelConfig, ShapeConfig, get_arch,
                   list_archs, register_arch, shape_by_name)

__all__ = ["LayerSpec", "ModelConfig", "ShapeConfig", "SHAPES",
           "shape_by_name", "get_arch", "list_archs", "register_arch",
           "dbrx_132b", "granite_3_2b", "hubert_xlarge", "jamba_1_5_large",
           "llava_next_34b", "nemotron_4_15b", "paper_tnn",
           "phi3_medium_14b", "qwen3_moe_235b", "rwkv6_7b",
           "stablelm_1_6b"]

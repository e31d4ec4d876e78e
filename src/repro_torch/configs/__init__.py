"""Architecture registry: importing this package registers the configs
ported so far (granite-3-2b)."""

from . import granite_3_2b
from .base import LayerSpec, ModelConfig, get_arch, register_arch

__all__ = ["LayerSpec", "ModelConfig", "get_arch", "register_arch",
           "granite_3_2b"]

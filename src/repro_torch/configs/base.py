"""Model configuration: ``ModelConfig``, ``LayerSpec`` and the registry.

Port of ``repro.configs.base`` with the fields the serving and training
paths read, or check to refuse what is not ported yet.  An architecture
is a *period* of layers repeated ``n_periods`` times; the port keeps one
parameter dict per layer.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace

from ..core.sc_layers import SC_OFF, SCQuantConfig

__all__ = ["LayerSpec", "ModelConfig", "ShapeConfig", "SHAPES",
           "shape_by_name", "register_arch", "get_arch", "list_archs"]


@dataclass(frozen=True)
class LayerSpec:
    """One layer within the repeating period."""
    mixer: str = "attn"        # attn | mamba | rwkv6
    ffn: str = "dense"         # dense | moe | rwkv_cmix


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0             # 0 -> d_model // n_heads
    period: tuple[LayerSpec, ...] = (LayerSpec(),)
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    ffn_act: str = "silu"       # silu | gelu | relu | relu2
    ffn_gated: bool = True
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    causal: bool = True
    qk_norm: bool = False       # per-head q / k RMSNorm (qwen3)
    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 1024  # tokens per dispatch group (GShard-style)
    # SSM (mamba)
    mamba_expand: int = 2
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_dt_rank: int = 0      # 0 -> ceil(d_model / 16)
    mamba_chunk: int = 64       # the reference's training-scan chunk
    # RWKV
    rwkv_head_dim: int = 64
    rwkv_lora_w: int = 0        # 0 -> max(64, d_model // 32) (decay lora)
    rwkv_wkv_impl: str = "scan" # scan | chunked (training only; serving
                                # prefill runs the token recurrence)
    rwkv_chunk: int = 32
    # front-end stub (vlm / audio): inputs arrive as embeddings
    frontend: str = "none"      # none | vision_stub | audio_stub
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    quant: SCQuantConfig = SC_OFF
    dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"   # AdamW m / v
    remat: str = "full"         # full | none  (per-layer recompute)
    # the reference's flash-scan block sizes, kept so configs carry over;
    # the port's flash kernel tiles on its own and reads neither
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    ce_chunks: int = 0          # >1: chunked cross-entropy (the (B, S, V)
                                # logits are never all alive at once)
    vocab_pad_multiple: int = 256

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        if self.n_layers % len(self.period):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} is not "
                             f"a multiple of the period {len(self.period)}")
        return self.n_layers // len(self.period)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    def has_mixer(self, kind: str) -> bool:
        return any(spec.mixer == kind for spec in self.period)

    def has_ffn(self, kind: str) -> bool:
        return any(spec.ffn == kind for spec in self.period)

    @property
    def sub_quadratic(self) -> bool:
        """Can the arch run 500k contexts?  True when a recurrent mixer
        (mamba or rwkv6) carries the context, as the reference's rule."""
        return self.has_mixer("mamba") or self.has_mixer("rwkv6")

    def with_quant(self, mode: str, **kw) -> "ModelConfig":
        return replace(self, quant=dataclasses.replace(
            self.quant if self.quant.enabled else SCQuantConfig(),
            mode=mode, **kw))

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced copy for smoke tests."""
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One step's input shape: a sequence length, the global batch, and
    its kind (train | prefill | decode)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_by_name(name: str) -> ShapeConfig:
    return SHAPES[name]


_ARCH_REGISTRY: dict[str, ModelConfig] = {}


def register_arch(cfg: ModelConfig) -> ModelConfig:
    _ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    if name not in _ARCH_REGISTRY:
        # importing the configs package populates the registry
        from .. import configs  # noqa: F401
    return _ARCH_REGISTRY[name]


def list_archs() -> list[str]:
    from .. import configs  # noqa: F401
    return sorted(_ARCH_REGISTRY)

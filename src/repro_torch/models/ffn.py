"""Dense FFN, SC-quantized: gated (SwiGLU / GeGLU) or plain ``act(x w_up)
w_down`` (nemotron's squared ReLU).  Port of ``repro.models.ffn``: the
projections go through ``dense_apply``; the gate multiply stays in the
residual (high-precision) domain."""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .common import ACT_FNS, dense_apply, dense_init

__all__ = ["ffn_init", "ffn_apply"]


def ffn_init(cfg: ModelConfig, *, generator: torch.Generator,
             device: torch.device) -> dict:
    dt = getattr(torch, cfg.dtype)
    kw = dict(generator=generator, device=device, dtype=dt)
    p = {}
    if cfg.ffn_gated:
        p["w_gate"] = dense_init(cfg.d_model, cfg.d_ff, cfg.quant, **kw)
    p["w_up"] = dense_init(cfg.d_model, cfg.d_ff, cfg.quant, **kw)
    p["w_down"] = dense_init(cfg.d_ff, cfg.d_model, cfg.quant, **kw)
    return p


def ffn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              batch_invariant: bool = True) -> torch.Tensor:
    act = ACT_FNS[cfg.ffn_act]
    kw = dict(batch_invariant=batch_invariant)
    if cfg.ffn_gated:
        h = act(dense_apply(p["w_gate"], x, cfg.quant, **kw)) \
            * dense_apply(p["w_up"], x, cfg.quant, **kw)
    else:
        h = act(dense_apply(p["w_up"], x, cfg.quant, **kw))
    return dense_apply(p["w_down"], h, cfg.quant, **kw)

"""Dense FFN, SC-quantized: gated (SwiGLU / GeGLU) or plain ``act(x w_up)
w_down`` (nemotron's squared ReLU).  Port of ``repro.models.ffn``: the
projections go through ``dense_apply``; the gate multiply stays in the
residual (high-precision) domain.  Under a serving mesh (:func:`ffn_spec`)
a rank computes its block of ``d_ff`` and gathers the hidden layer
before ``w_down``, whose contraction is never split."""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import MODEL, gather, splits
from .common import ACT_FNS, dense_apply, dense_init, dense_spec

__all__ = ["ffn_init", "ffn_apply", "ffn_spec"]


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


def ffn_spec(cfg: ModelConfig) -> dict:
    """The serving layout: all three projections column-parallel over
    "model" (the reference's ``ffn_spec(serving=True)``)."""
    names = ("w_gate", "w_up", "w_down") if cfg.ffn_gated \
        else ("w_up", "w_down")
    return {k: dense_spec(None, MODEL, cfg.quant) for k in names}


def ffn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              batch_invariant: bool = True) -> torch.Tensor:
    act = ACT_FNS[cfg.ffn_act]
    local = splits(cfg.d_ff)
    kw = dict(batch_invariant=batch_invariant, local=local)
    if cfg.ffn_gated:
        h = act(dense_apply(p["w_gate"], x, cfg.quant, **kw)) \
            * dense_apply(p["w_up"], x, cfg.quant, **kw)
    else:
        h = act(dense_apply(p["w_up"], x, cfg.quant, **kw))
    if local:
        h = gather(h, MODEL, -1)
    return dense_apply(p["w_down"], h, cfg.quant,
                       batch_invariant=batch_invariant)

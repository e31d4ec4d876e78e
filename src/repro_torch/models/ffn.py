"""Dense FFN, SC-quantized: gated (SwiGLU / GeGLU) or plain ``act(x w_up)
w_down`` (nemotron's squared ReLU).  Port of ``repro.models.ffn``: the
projections go through ``dense_apply``; the gate multiply stays in the
residual (high-precision) domain.  Under a serving mesh (:func:`ffn_spec`)
a rank computes its block of ``d_ff`` and gathers the hidden layer
before ``w_down``, whose contraction is never split.  Under a training
mesh (``serving=False``) ``w_down`` is row-parallel: it takes the rank's
block of the hidden layer and sums the ranks' products."""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import (DATA, MODEL, fsdp_active, gather,
                                    is_sharded, splits, sum_grads)
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


def ffn_spec(cfg: ModelConfig, serving: bool = True) -> dict:
    """The serving layout (default): all three projections column-parallel
    over "model" (the reference's ``ffn_spec(serving=True)``).  The
    training layout: ``w_gate`` / ``w_up`` (data, model), ``w_down``
    (model, data)."""
    names = ("w_gate", "w_up", "w_down") if cfg.ffn_gated \
        else ("w_up", "w_down")
    if serving:
        return {k: dense_spec(None, MODEL, cfg.quant) for k in names}
    return {k: dense_spec(MODEL, DATA, cfg.quant) if k == "w_down"
            else dense_spec(DATA, MODEL, cfg.quant) for k in names}


def ffn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              batch_invariant: bool = True) -> torch.Tensor:
    act = ACT_FNS[cfg.ffn_act]
    mesh = fsdp_active()
    # a training mesh keeps the hidden layer's block when w_down is
    # row-parallel; otherwise w_down contracts the whole hidden layer
    local = is_sharded(p["w_down"]["w"], 0) if mesh else splits(cfg.d_ff)
    kw = dict(batch_invariant=batch_invariant, local=local)
    if mesh and is_sharded(p["w_up"]["w"], 1):
        x = sum_grads(x)        # the column-parallel products' input
    if cfg.ffn_gated:
        h = act(dense_apply(p["w_gate"], x, cfg.quant, **kw)) \
            * dense_apply(p["w_up"], x, cfg.quant, **kw)
    else:
        h = act(dense_apply(p["w_up"], x, cfg.quant, **kw))
    if local and not mesh:
        h = gather(h, MODEL, -1)
    return dense_apply(p["w_down"], h, cfg.quant,
                       batch_invariant=batch_invariant)

"""RWKV-6 "Finch" time mix and channel mix, for serving.

Port of ``repro.models.rwkv6``'s serving half.  The time mix carries a
per-head (Dh x Dh) state through the recurrence

    S_t = diag(w_t) S_{t-1} + k_t^T v_t,   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with the data-dependent decay ``w_t = exp(-exp(w0 + lora(x_t)))``, and
both mixes carry a one-token shift; so decode state is O(1) in the
context length.  ``*_prefill_chunk`` runs a chunk of the prompt token by
token from the carried state, so every split of a prompt into chunks
gives the same bits; a ``valid`` mask freezes right-padded lanes (the
state by an exact select, the shift at the last real token).  The
R / K / V / G / O projections and the channel mix's go through
``dense_apply`` (SC-quantized); the recurrence stays float32.

Batch invariance.  The LoRA products of the token shift and the decay
(``tm_w1``, ``tm_w2``, ``dw1``, ``dw2``; plain products in the reference)
go through ``common.matmul_rows``, as the dense products do, and the wkv
readout ``r_t . (...)`` (a sum over the key axis) through
:func:`~.common.sum_fixed`, whose order ignores the other lanes.  The
training forms (``_wkv_chunked``, ``rwkv_*_train``) are not ported yet
(ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .common import (ACT_FNS, dense_apply, dense_init, matmul_rows,
                     norm_apply, norm_init, sum_fixed)

__all__ = ["rwkv_tmix_init", "rwkv_tmix_decode", "rwkv_tmix_prefill_chunk",
           "rwkv_cmix_init", "rwkv_cmix_decode", "rwkv_cmix_prefill_chunk",
           "rwkv_state_init"]

_silu = ACT_FNS["silu"]


def _n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def rwkv_tmix_init(cfg: ModelConfig, *, generator: torch.Generator,
                   device: torch.device) -> dict:
    """Parameters in the reference's shapes and initialisation: zero
    ``maa_x`` / ``maa`` (5, d) / ``u``, ``w0`` -6, the LoRA factors
    ``N(0, 1e-4)`` (token-shift rank ``max(32, d / 64)``, decay rank
    ``rwkv_lora_w`` or ``max(64, d / 32)``), and ``ln_x`` a LayerNorm."""
    d = cfg.d_model
    h, dh = _n_heads(cfg), cfg.rwkv_head_dim
    lora = max(32, d // 64)
    lora_w = cfg.rwkv_lora_w or max(64, d // 32)
    dt = getattr(torch, cfg.dtype)
    kw = dict(generator=generator, device=device)
    q = cfg.quant

    def small(*shape):
        return (torch.randn(shape, **kw) * 1e-2).to(dt)
    return {
        "maa_x": torch.zeros((d,), device=device),
        "maa": torch.zeros((5, d), device=device),        # w, k, v, r, g
        "tm_w1": small(d, 5 * lora),
        "tm_w2": small(5, lora, d),
        "w0": torch.full((d,), -6.0, device=device),
        "dw1": small(d, lora_w),
        "dw2": small(lora_w, d),
        "u": torch.zeros((h, dh), device=device),
        "wr": dense_init(d, d, q, dtype=dt, **kw),
        "wk": dense_init(d, d, q, dtype=dt, **kw),
        "wv": dense_init(d, d, q, dtype=dt, **kw),
        "wg": dense_init(d, d, q, dtype=dt, **kw),
        "wo": dense_init(d, d, q, dtype=dt, **kw),
        "ln_x": norm_init(d, "layernorm", device),
    }


def rwkv_cmix_init(cfg: ModelConfig, *, generator: torch.Generator,
                   device: torch.device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = getattr(torch, cfg.dtype)
    kw = dict(generator=generator, device=device, dtype=dt)
    q = cfg.quant
    return {"mk": torch.zeros((d,), device=device),
            "mr": torch.zeros((d,), device=device),
            "wk": dense_init(d, f, q, **kw),
            "wv": dense_init(f, d, q, **kw),
            "wr": dense_init(d, d, q, **kw)}


def rwkv_state_init(cfg: ModelConfig, batch: int,
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | None = None) -> dict:
    """Zero time-mix state: ``s`` (batch, H, Dh, Dh) float32 and the token
    shift ``shift`` (batch, d) in ``dtype``."""
    h, dh, d = _n_heads(cfg), cfg.rwkv_head_dim, cfg.d_model
    return {"s": torch.zeros((batch, h, dh, dh), device=device),
            "shift": torch.zeros((batch, d), dtype=dtype, device=device)}


def _ddlerp(p: dict, x: torch.Tensor, sx: torch.Tensor):
    """The data-dependent token-shift interpolation: x + sx * (maa_i +
    lora_i(x + sx * maa_x)) for i in w, k, v, r, g.  As in the reference,
    the LoRA runs in float32 (the float32 ``maa_x`` promotes it)."""
    B, S, d = x.shape
    xxx = x + sx * p["maa_x"]
    lora = torch.tanh(matmul_rows(xxx, p["tm_w1"]))            # (B,S,5L)
    lora = lora.reshape(B * S, 5, -1).transpose(0, 1)          # (5,BS,L)
    adj = matmul_rows(lora, p["tm_w2"])                        # (5,BS,d)
    return [x + sx * (p["maa"][i] + adj[i].reshape(B, S, d)
                      .to(torch.float32)).to(x.dtype)
            for i in range(5)]                                 # w k v r g


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    ww = matmul_rows(torch.tanh(matmul_rows(xw, p["dw1"])), p["dw2"])
    return torch.exp(-torch.exp(p["w0"] + ww.to(torch.float32)))


def _wkv_scan(r, k, v, w, u, s0, valid=None):
    """r, k, v: (B, S, H, Dh); w float32 decay (B, S, H, Dh); s0: (B, H,
    Dh, Dh) float32.  Returns (y (B, S, H, Dh) float32, the final state).

    The loop carries only the state; every token's k^T v outer product is
    taken for the chunk at once (elementwise), and the readout of all
    tokens runs after the loop on the stacked pre-token states with
    :func:`~.common.sum_fixed` over the key axis."""
    B, S = r.shape[:2]
    r, k, v = (t.to(torch.float32) for t in (r, k, v))
    kv = k[..., :, None] * v[..., None, :]                     # (B,S,H,K,V)
    if valid is None:
        valid = torch.ones((B, S), dtype=torch.bool, device=r.device)
    s = s0
    prev = []
    for t in range(S):
        prev.append(s)
        s = torch.where(valid[:, t, None, None, None],
                        w[:, t, :, :, None] * s + kv[:, t], s)
    att = torch.stack(prev, dim=1) + u[:, :, None] * kv        # (B,S,H,K,V)
    return sum_fixed(r[..., :, None] * att, -2), s


def _tmix_core(p: dict, x: torch.Tensor, sx: torch.Tensor, cfg: ModelConfig,
               s0: torch.Tensor, valid: torch.Tensor | None = None):
    B, S, d = x.shape
    h, dh = _n_heads(cfg), cfg.rwkv_head_dim
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx)
    w = _decay(p, xw).reshape(B, S, h, dh)
    r = dense_apply(p["wr"], xr, cfg.quant).reshape(B, S, h, dh)
    k = dense_apply(p["wk"], xk, cfg.quant).reshape(B, S, h, dh)
    v = dense_apply(p["wv"], xv, cfg.quant).reshape(B, S, h, dh)
    g = _silu(dense_apply(p["wg"], xg, cfg.quant))
    y, sT = _wkv_scan(r, k, v, w, p["u"], s0, valid)
    y = norm_apply(p["ln_x"], y.reshape(B, S, d), "layernorm", eps=1e-5,
                   groups=h)
    return dense_apply(p["wo"], (y * g).to(x.dtype), cfg.quant), sT


def _last_valid(x: torch.Tensor, valid: torch.Tensor | None,
                fallback: torch.Tensor) -> torch.Tensor:
    """Each lane's last valid row of x (the carried token shift); a lane
    with no valid token in the chunk keeps ``fallback``."""
    if valid is None:
        return x[:, -1, :]
    nv = valid.sum(dim=1)                                      # (B,)
    idx = torch.clamp(nv - 1, 0, x.shape[1] - 1)
    rows = torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))
    return torch.where((nv > 0)[:, None], rows[:, 0],
                       fallback.to(x.dtype))


def _shifted(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The previous token of every position: the carried shift, then x."""
    return torch.cat([shift[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def rwkv_tmix_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     state: dict):
    """x: (B, 1, D); state ``{"s": (B, H, Dh, Dh), "shift": (B, D)}``."""
    sx = state["shift"][:, None, :].to(x.dtype) - x
    out, sT = _tmix_core(p, x, sx, cfg, state["s"])
    return out, {"s": sT, "shift": x[:, 0, :]}


def rwkv_tmix_prefill_chunk(p: dict, x: torch.Tensor, cfg: ModelConfig,
                            state: dict, valid: torch.Tensor | None = None):
    """One chunk of the prompt from the carried decode state (zeros at the
    start of a sequence): the token recurrence, with ``valid`` (B, C)
    freezing the wkv state and the shift at each lane's last real
    token."""
    out, sT = _tmix_core(p, x, _shifted(x, state["shift"]) - x, cfg,
                         state["s"], valid)
    return out, {"s": sT, "shift": _last_valid(x, valid, state["shift"])}


def _cmix_core(p: dict, x: torch.Tensor, sx: torch.Tensor, cfg: ModelConfig):
    xk = x + sx * p["mk"].to(x.dtype)
    xr = x + sx * p["mr"].to(x.dtype)
    k = torch.square(torch.relu(dense_apply(p["wk"], xk, cfg.quant)))
    kv = dense_apply(p["wv"], k, cfg.quant)
    return torch.sigmoid(dense_apply(p["wr"], xr, cfg.quant)) * kv


def rwkv_cmix_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     state: dict):
    sx = state["shift"][:, None, :].to(x.dtype) - x
    return _cmix_core(p, x, sx, cfg), {"shift": x[:, 0, :]}


def rwkv_cmix_prefill_chunk(p: dict, x: torch.Tensor, cfg: ModelConfig,
                            state: dict, valid: torch.Tensor | None = None):
    """The channel mix couples tokens only through the one-token shift, so
    carrying ``{"shift": (B, D)}`` makes every chunk split exact."""
    return (_cmix_core(p, x, _shifted(x, state["shift"]) - x, cfg),
            {"shift": _last_valid(x, valid, state["shift"])})

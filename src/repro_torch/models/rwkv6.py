"""RWKV-6 "Finch" time mix and channel mix.

Port of ``repro.models.rwkv6``.  The time mix carries a
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
:func:`~.common.sum_fixed`, whose order ignores the other lanes.

Training (``rwkv_tmix_train``, ``rwkv_cmix_train``) runs the whole
sequence from zero state with plain products.  The wkv is the token
recurrence, or with ``cfg.rwkv_wkv_impl == "chunked"`` the GLA-style
chunked form :func:`_wkv_chunked` (the same recurrence, S / C steps of
dense products in log-space decays); serving prefill always takes the
token recurrence, the only form whose bits ignore where chunks split.

Under a serving mesh (:func:`rwkv_tmix_spec`) the wkv heads shard over
"model", when it splits them: a rank's r / k / v / g and decay are its
heads' channels (column-parallel products), its state rows hold its
heads, ``ln_x`` normalizes its heads, and the output is gathered before
``wo``.  The token-shift LoRA's ``tm_w2`` is column-parallel and
gathered; the other LoRA factors stay whole, as in the reference.  The
channel mix gathers its hidden layer before ``wv``.

Under the training layout (``serving=False``, the reference's) the time
mix runs the same heads a rank, with ``wo`` row-parallel (the partial
products summed over "model") and ``ln_x`` whole, each rank reading its
heads' slice; the channel mix takes ``wk`` column-parallel, ``wv``
row-parallel and ``wr`` whole (FSDP only), so every rank computes all of
r.  A gradient that reaches a replicated value from a rank's own heads or
hidden block is that rank's share, and is summed over "model"
(``sum_grads``): the time mix's input and ``maa_x`` / ``maa`` /
``tm_w1`` / ``dw1`` (they feed column-parallel products and the rank's
decays), ``ln_x``'s slice, and the channel mix's key branch (``mk``, the
input of ``wk``).  Its receptance branch (``mr``, ``wr``) is computed
whole on every rank, so its gradient is whole already.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import (DATA, MODEL, axis_size, cols,
                                    fsdp_active, gather, is_sharded, splits,
                                    sum_grads)
from .common import (ACT_FNS, dense_apply, dense_init, dense_spec,
                     matmul_rows, norm_apply, norm_init, norm_spec, sum_fixed)

__all__ = ["rwkv_tmix_init", "rwkv_tmix_train", "rwkv_tmix_decode",
           "rwkv_tmix_prefill_chunk", "rwkv_cmix_init", "rwkv_cmix_train",
           "rwkv_cmix_decode", "rwkv_cmix_prefill_chunk", "rwkv_state_init",
           "rwkv_tmix_spec", "rwkv_cmix_spec", "rwkv_state_spec"]

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


def rwkv_tmix_spec(cfg: ModelConfig, serving: bool = True) -> dict:
    """The serving layout (default): the projections column-parallel, the
    per-head leaves (``w0``, ``u``, ``ln_x``) and ``dw2`` / ``tm_w2``'s
    outputs over "model"; ``maa*``, ``tm_w1`` and ``dw1`` whole, as the
    reference's.  The reference's ``wo`` splits its contraction; the
    port serves it column-parallel.  The training layout
    (``serving=False``) is the reference's."""
    q = cfg.quant
    s = {"maa_x": (None,), "maa": (None, None), "tm_w1": (None, None),
         "tm_w2": (None, None, MODEL), "w0": (MODEL,), "dw1": (None, None),
         "dw2": (None, MODEL), "u": (MODEL, None),
         "ln_x": norm_spec("layernorm", MODEL if serving else None)}
    s.update({k: dense_spec(DATA if not serving else None, MODEL, q)
              for k in ("wr", "wk", "wv", "wg")})
    s["wo"] = dense_spec(None, MODEL, q) if serving \
        else dense_spec(MODEL, DATA, q)
    return s


def rwkv_cmix_spec(cfg: ModelConfig, serving: bool = True) -> dict:
    """The serving layout (default): every projection column-parallel.
    The training layout is the reference's: ``wk`` (data, model), ``wv``
    (model, data), ``wr`` (data, None)."""
    q = cfg.quant
    if not serving:
        return {"mk": (None,), "mr": (None,),
                "wk": dense_spec(DATA, MODEL, q),
                "wv": dense_spec(MODEL, DATA, q),
                "wr": dense_spec(DATA, None, q)}
    return {"mk": (None,), "mr": (None,), "wk": dense_spec(None, MODEL, q),
            "wv": dense_spec(None, MODEL, q), "wr": dense_spec(None, MODEL, q)}


def rwkv_state_spec() -> dict:
    """Logical axes of the time mix's state rows: ``s`` over its heads,
    the token shift whole."""
    return {"s": (None, "model", None, None), "shift": (None, None)}


def rwkv_state_init(cfg: ModelConfig, batch: int,
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | None = None) -> dict:
    """Zero time-mix state: ``s`` (batch, H, Dh, Dh) float32 and the token
    shift ``shift`` (batch, d) in ``dtype``."""
    h, dh, d = _n_heads(cfg), cfg.rwkv_head_dim, cfg.d_model
    return {"s": torch.zeros((batch, h, dh, dh), device=device),
            "shift": torch.zeros((batch, d), dtype=dtype, device=device)}


def _mm(x: torch.Tensor, w: torch.Tensor,
        batch_invariant: bool) -> torch.Tensor:
    """A LoRA product in ``x``'s dtype: ``matmul_rows`` for serving, a
    plain product for training."""
    if batch_invariant:
        return matmul_rows(x, w)
    return torch.matmul(x, w.to(x.dtype))


def _ddlerp(p: dict, x: torch.Tensor, sx: torch.Tensor,
            batch_invariant: bool = True):
    """The data-dependent token-shift interpolation: x + sx * (maa_i +
    lora_i(x + sx * maa_x)) for i in w, k, v, r, g.  As in the reference,
    the LoRA runs in float32 (the float32 ``maa_x`` promotes it)."""
    B, S, d = x.shape
    xxx = x + sx * p["maa_x"]
    lora = torch.tanh(_mm(xxx, p["tm_w1"], batch_invariant))   # (B,S,5L)
    lora = lora.reshape(B * S, 5, -1).transpose(0, 1)          # (5,BS,L)
    adj = cols(_mm(lora, p["tm_w2"], batch_invariant), p["tm_w2"],
               False)                                          # (5,BS,d)
    return [x + sx * (p["maa"][i] + adj[i].reshape(B, S, d)
                      .to(torch.float32)).to(x.dtype)
            for i in range(5)]                                 # w k v r g


def _decay(p: dict, xw: torch.Tensor, batch_invariant: bool = True,
           local: bool = False) -> torch.Tensor:
    ww = cols(_mm(torch.tanh(_mm(xw, p["dw1"], batch_invariant)), p["dw2"],
                  batch_invariant), p["dw2"], local)
    w0 = cols(p["w0"], p["w0"], local)
    return torch.exp(-torch.exp(w0 + ww.to(torch.float32)))


def _wkv_scan(r, k, v, w, u, s0, valid=None):
    """r, k, v: (B, S, H, Dh); w float32 decay (B, S, H, Dh); s0: (B, H,
    Dh, Dh) float32.  Returns (y (B, S, H, Dh) float32, the final state).

    The loop carries only the state; every token's k^T v outer product is
    taken for the chunk at once (elementwise), and the readout of all
    tokens runs after the loop on the stacked pre-token states with
    :func:`~.common.sum_fixed` over the key axis.  Without ``valid`` every
    step updates (the select of an all-true mask, left out).  The per-token
    operands come from ``unbind``, whose backward stacks the tokens'
    gradients once (an indexed ``kv[:, t]`` would give each token a
    zero-filled gradient of all of ``kv``)."""
    r, k, v = (t.to(torch.float32) for t in (r, k, v))
    kv = k[..., :, None] * v[..., None, :]                     # (B,S,H,K,V)
    s = s0
    prev = []
    ws, kvs = torch.unbind(w[..., None], 1), torch.unbind(kv, 1)
    masks = [None] * len(ws) if valid is None \
        else torch.unbind(valid[:, :, None, None, None], 1)
    for wt, kvt, mt in zip(ws, kvs, masks):
        prev.append(s)
        sn = wt * s + kvt
        s = sn if mt is None else torch.where(mt, sn, s)
    att = torch.stack(prev, dim=1) + u[:, :, None] * kv        # (B,S,H,K,V)
    return sum_fixed(r[..., :, None] * att, -2), s


def _wkv_chunked(r, k, v, w, u, s0, chunk: int):
    """The GLA-style chunked wkv: the token recurrence's result, computed
    per chunk of C tokens (the largest divisor of S not above ``chunk``)
    from log-space decays whose every exponent difference is <= 0, so
    no decay strength overflows::

        y_t = (r_t . e^{L_{t-1}}) @ S_0                        (inter)
            + sum_{s<t} [sum_k r_t k_s e^{L_{t-1}-L_s}]_k v_s  (intra)
            + ((r_t . u) @ k_t) v_t                            (bonus)
        S_C = e^{L_C} . S_0 + sum_s (k_s . e^{L_C - L_s}) v_s^T

    Same arguments and result as :func:`_wkv_scan` (no ``valid``)."""
    B, S, H, D = r.shape
    C = min(chunk, S)
    while S % C:
        C -= 1
    r, k, v = (t.to(torch.float32) for t in (r, k, v))
    logw = torch.log(torch.clamp(w.to(torch.float32), 1e-30, 1.0))
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)                              # s < t
    eye = torch.eye(C, device=r.device)
    s, ys = s0, []
    for rc, kc, vc, lw in zip(*(torch.split(t, C, dim=1)
                                for t in (r, k, v, logw))):
        L = torch.cumsum(lw, dim=1)                            # L_t
        Lprev = L - lw                                         # L_{t-1}
        y = torch.einsum("bchk,bhkv->bchv", rc * torch.exp(Lprev), s)
        diff = Lprev[:, :, None] - L[:, None]                  # (B,t,s,H,K)
        diff = torch.where(tri[None, :, :, None, None], diff, -1e30)
        a = torch.einsum("bthk,bshk,btshk->bths", rc, kc, torch.exp(diff))
        bonus = torch.einsum("bthk,bthk->bth", rc * u, kc)
        a = a + bonus[..., None] * eye[None, :, None, :]
        ys.append(y + torch.einsum("bths,bshv->bthv", a, vc))
        L_C = L[:, -1]                                         # (B,H,K)
        k_w = kc * torch.exp(L_C[:, None] - L)
        s = s * torch.exp(L_C)[..., None] \
            + torch.einsum("bshk,bshv->bhkv", k_w, vc)
    return torch.cat(ys, dim=1), s


def _tmix_core(p: dict, x: torch.Tensor, sx: torch.Tensor, cfg: ModelConfig,
               s0: torch.Tensor, valid: torch.Tensor | None = None,
               force_scan: bool = False, batch_invariant: bool = True):
    """The time mix from the shift difference ``sx`` and the state ``s0``.
    The wkv is :func:`_wkv_chunked` when ``cfg.rwkv_wkv_impl`` says
    "chunked" and S > 1, unless ``force_scan`` (serving prefill, whose
    chunk splits must not move a bit); else the token recurrence."""
    B, S, d = x.shape
    h, dh = _n_heads(cfg), cfg.rwkv_head_dim
    local = splits(h)                 # this rank's heads under a mesh
    if local:
        h, d = h // axis_size(), d // axis_size()
    if local and fsdp_active():
        # replicated leaves read by this rank's heads only
        p = dict(p, **{k: sum_grads(p[k])
                       for k in ("maa_x", "maa", "tm_w1", "dw1")})
        if not is_sharded(p["ln_x"]["scale"], 0):
            p["ln_x"] = {n: sum_grads(t) for n, t in p["ln_x"].items()}
    kw = dict(batch_invariant=batch_invariant)
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx, batch_invariant)
    w = _decay(p, xw, batch_invariant, local).reshape(B, S, h, dh)
    r = dense_apply(p["wr"], xr, cfg.quant, local=local, **kw) \
        .reshape(B, S, h, dh)
    k = dense_apply(p["wk"], xk, cfg.quant, local=local, **kw) \
        .reshape(B, S, h, dh)
    v = dense_apply(p["wv"], xv, cfg.quant, local=local, **kw) \
        .reshape(B, S, h, dh)
    g = _silu(dense_apply(p["wg"], xg, cfg.quant, local=local, **kw))
    u = cols(p["u"], p["u"], local, w_dim=0, y_dim=0)
    if cfg.rwkv_wkv_impl == "chunked" and S > 1 and not force_scan:
        y, sT = _wkv_chunked(r, k, v, w, u, s0, cfg.rwkv_chunk)
    else:
        y, sT = _wkv_scan(r, k, v, w, u, s0, valid)
    ln = {n: cols(t, t, local) for n, t in p["ln_x"].items()}
    y = norm_apply(ln, y.reshape(B, S, d), "layernorm", eps=1e-5, groups=h)
    y = (y * g).to(x.dtype)
    if local and not is_sharded(p["wo"]["w"], 0):
        y = gather(y, MODEL, -1)
    return dense_apply(p["wo"], y, cfg.quant, **kw), sT


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


def _prev_zero(x: torch.Tensor) -> torch.Tensor:
    """The previous token of every position, zeros before the first."""
    return torch.nn.functional.pad(x[:, :-1], (0, 0, 1, 0))


def rwkv_tmix_train(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The training time mix over the whole sequence from zero state, with
    plain products.  Returns (out, (state_T, x_last)), as the
    reference."""
    B = x.shape[0]
    h, dh = _n_heads(cfg), cfg.rwkv_head_dim
    if splits(h):
        # under a training mesh every path from x ends in this rank's heads
        h = h // axis_size()
        x = sum_grads(x)
    s0 = torch.zeros((B, h, dh, dh), device=x.device)
    out, sT = _tmix_core(p, x, _prev_zero(x) - x, cfg, s0,
                         batch_invariant=False)
    return out, (sT, x[:, -1])


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
                         state["s"], valid, force_scan=True)
    return out, {"s": sT, "shift": _last_valid(x, valid, state["shift"])}


def _cmix_core(p: dict, x: torch.Tensor, sx: torch.Tensor, cfg: ModelConfig,
               batch_invariant: bool = True):
    kw = dict(batch_invariant=batch_invariant)
    xk = x + sx * p["mk"].to(x.dtype)
    xr = x + sx * p["mr"].to(x.dtype)
    local = splits(cfg.d_ff)
    if local and fsdp_active():
        xk = sum_grads(xk)        # the column-parallel product's input
    k = torch.square(torch.relu(dense_apply(p["wk"], xk, cfg.quant,
                                            local=local, **kw)))
    if local and not is_sharded(p["wv"]["w"], 0):
        k = gather(k, MODEL, -1)
    kv = dense_apply(p["wv"], k, cfg.quant, **kw)
    return torch.sigmoid(dense_apply(p["wr"], xr, cfg.quant, **kw)) * kv


def rwkv_cmix_train(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The training channel mix, plain products.  Returns (out, x_last)."""
    return (_cmix_core(p, x, _prev_zero(x) - x, cfg, batch_invariant=False),
            x[:, -1])


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

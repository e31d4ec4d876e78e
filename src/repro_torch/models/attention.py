"""GQA attention: full-sequence flash attention (training and the dense
prefill), the dense cache's one-token decode, and the paged KV cache
(serving decode + chunked prefill).

Port of ``repro.models.attention`` for attention layers.  ``attn_train``
runs the differentiable flash attention over the whole sequence;
``attn_decode`` appends one token to a dense (B, T, Hkv, Dh) cache and
attends over it in float32 PyTorch ops, as the reference's einsums.  With
``cfg.qk_norm`` (qwen3) q and k are RMS-normalized per head, after the
projection and before RoPE, on every path.

In the paged cache, slot ``s``'s position ``t`` lives at physical page
``page_tables[s, t // page]``, offset ``t % page``; padded table lanes
point at the trash page 0, where writes land harmlessly and reads are
masked by length or causality.  Both paged layers take the engine's pool
dict (``k_pages``/``v_pages``/``page_tables`` plus, for compressed
caches, ``k_scale``/``v_scale`` and the sc ``k_resid``/``v_resid``; the
keys are the format).  New K/V
quantize on scatter: only the just-written positions are encoded.  The
port writes the pools in place (the reference returns new arrays) and
returns the same dict.  Attention itself goes through
``kernels/dispatch.py``: the CUDA kernels on the card, their plain
versions on the CPU.
"""

from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from ..core.kv_quant import kv_format_of, kv_quant
from ..kernels import dispatch
from .common import apply_rope, dense_apply, dense_init, norm_apply, norm_init

__all__ = ["attn_init", "attn_train", "attn_decode", "attn_decode_paged",
           "attn_prefill_paged", "flash_attention"]

_AUX_KEYS = ("k_scale", "v_scale", "k_resid", "v_resid")


def attn_init(cfg: ModelConfig, *, generator: torch.Generator,
              device: torch.device) -> dict:
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    kw = dict(generator=generator, device=device,
              dtype=getattr(torch, cfg.dtype))
    p = {"wq": dense_init(cfg.d_model, hq * dh, cfg.quant, **kw),
         "wk": dense_init(cfg.d_model, hkv * dh, cfg.quant, **kw),
         "wv": dense_init(cfg.d_model, hkv * dh, cfg.quant, **kw),
         "wo": dense_init(hq * dh, cfg.d_model, cfg.quant, **kw)}
    if cfg.qk_norm:
        p["q_norm"] = norm_init(dh, "rmsnorm", device)
        p["k_norm"] = norm_init(dh, "rmsnorm", device)
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, batch_invariant: bool = True):
    B, S, _ = x.shape
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    kw = dict(batch_invariant=batch_invariant)
    q = dense_apply(p["wq"], x, cfg.quant, **kw).reshape(B, S, hq, dh)
    k = dense_apply(p["wk"], x, cfg.quant, **kw).reshape(B, S, hkv, dh)
    v = dense_apply(p["wv"], x, cfg.quant, **kw).reshape(B, S, hkv, dh)
    if "q_norm" in p:
        q = norm_apply(p["q_norm"], q, "rmsnorm")
        k = norm_apply(p["k_norm"], k, "rmsnorm")
    q = apply_rope(q, positions, dh, cfg.rope_fraction, cfg.rope_theta)
    k = apply_rope(k, positions, dh, cfg.rope_fraction, cfg.rope_theta)
    return q, k, v


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> torch.Tensor:
    """q: (B, S, Hkv, G, Dh); k, v: (B, S, Hkv, Dh) -> (B, S, Hkv, G, Dh).

    The model path's op order: q is scaled by ``1/sqrt(Dh)`` in q's own
    dtype and then attended in float32 (the reference's scan,
    ``attention.py:100``), so the kernel runs with ``scale=1``; the
    Pallas kernel and ``flash_attention_cuda``'s default cast first and
    scale in float32 instead.  For a power-of-two ``sqrt(Dh)`` (granite's
    Dh = 64) the two orders agree exactly.  The reference's scan block
    (``chunk``) has no counterpart: the kernel tiles on its own.
    """
    B, S, H, G, D = q.shape
    qs = q * (1.0 / math.sqrt(D))
    o = dispatch.flash_attention(qs.reshape(B, S, H * G, D), k, v,
                                 causal=causal, scale=1.0)
    return o.reshape(B, S, H, G, D)


def attn_train(p: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, batch_invariant: bool = False):
    """Full-sequence attention, x (B, S, D) -> (y, (k, v)): the training
    forward (plain products) and, with ``batch_invariant``, the dense
    prefill (the serving products)."""
    B, S, _ = x.shape
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q, k, v = _project_qkv(p, x, cfg, positions,
                           batch_invariant=batch_invariant)
    o = flash_attention(q.reshape(B, S, hkv, hq // hkv, dh), k, v,
                        cfg.causal)
    y = dense_apply(p["wo"], o.reshape(B, S, hq * dh), cfg.quant,
                    batch_invariant=batch_invariant)
    return y, (k, v)


def attn_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos: torch.Tensor):
    """One-token decode on the dense cache.  x: (B, 1, D); caches (B, T,
    Hkv, Dh); ``pos`` a 0-d int tensor, the new token's position.

    The new K/V are written at ``pos`` (in place), then the query attends
    over the whole cache in float32 with positions above ``pos`` masked
    to -1e30, the logits divided by ``sqrt(Dh)`` after the product (the
    reference's order).  Returns (y (B, 1, D), k_cache, v_cache)."""
    B = x.shape[0]
    T = k_cache.shape[1]
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    positions = pos.to(torch.int32).expand(B, 1)
    q, k, v = _project_qkv(p, x, cfg, positions)
    idx = pos.reshape(1).long()
    k_cache.index_copy_(1, idx, k.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v.to(v_cache.dtype))
    qg = q.reshape(B, hkv, hq // hkv, dh)
    logits = torch.einsum("bhgd,bthd->bhgt", qg.to(torch.float32),
                          k_cache.to(torch.float32)) / math.sqrt(dh)
    valid = torch.arange(T, device=x.device) <= pos
    logits = torch.where(valid, logits,
                         torch.tensor(-1e30, device=x.device))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgt,bthd->bhgd", w, v_cache.to(torch.float32))
    o = o.reshape(B, 1, hq * dh).to(x.dtype)
    return dense_apply(p["wo"], o, cfg.quant), k_cache, v_cache


def _scatter_pools(pools: dict, fmt: str, k_new: torch.Tensor,
                   v_new: torch.Tensor, put) -> None:
    """Quantize-on-scatter: encode the new K/V rows and write every pool
    leaf through ``put(pool, values)`` (codes, scales and residuals share
    indices: the pools are position-parallel)."""
    for name, val in (("k", k_new), ("v", v_new)):
        qd = kv_quant(val, fmt)
        put(pools[f"{name}_pages"], qd["q"])
        if "scale" in qd:
            put(pools[f"{name}_scale"], qd["scale"])
        if "resid" in qd:
            put(pools[f"{name}_resid"], qd["resid"])


def _kv_aux(pools: dict) -> dict:
    return {k: pools[k] for k in _AUX_KEYS if k in pools}


def attn_decode_paged(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      pools: dict, lengths: torch.Tensor):
    """Batched one-token decode.  x: (S, 1, D), one token per lane;
    lengths: (S,) int32 tokens already cached (== the new token's
    position).  Returns (y (S, 1, D), pools)."""
    page_tables = pools["page_tables"]
    page = pools["k_pages"].shape[1]
    fmt = kv_format_of(pools)
    S = x.shape[0]
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q, k, v = _project_qkv(p, x, cfg, lengths[:, None])
    # one (page, offset) per lane; distinct live lanes own distinct pages,
    # padded lanes all hit the trash page
    phys = torch.gather(page_tables, 1,
                        (lengths // page)[:, None].long())[:, 0].long()
    off = (lengths % page).long()

    def put(pool, val):
        pool[phys, off] = val.to(pool.dtype)

    _scatter_pools(pools, fmt, k[:, 0], v[:, 0], put)
    o = dispatch.paged_attn_decode(
        q.reshape(S, hkv, hq // hkv, dh), pools["k_pages"], pools["v_pages"],
        page_tables, lengths, kv_format=fmt, kv_aux=_kv_aux(pools))
    o = o.reshape(S, 1, hq * dh).to(x.dtype)
    return dense_apply(p["wo"], o, cfg.quant), pools


def attn_prefill_paged(p: dict, x: torch.Tensor, cfg: ModelConfig,
                       pools: dict, start: int):
    """One prefill chunk written straight into the decode page layout.

    x: (G, C, D), chunk ``[start, start + C)`` of each request, C a
    multiple of the page size and ``start`` chunk-aligned.  The chunk's
    K/V are scattered as whole pages, then its queries attend over every
    page written so far under the causal mask.  Returns (y (G, C, D),
    pools).
    """
    page_tables = pools["page_tables"]
    page = pools["k_pages"].shape[1]
    fmt = kv_format_of(pools)
    G, C, _ = x.shape
    if C % page or start % page:
        raise ValueError(f"chunk {C} / start {start} not page-aligned "
                         f"(page={page})")
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    positions = start + torch.arange(C, dtype=torch.int32,
                                     device=x.device).expand(G, C)
    q, k, v = _project_qkv(p, x, cfg, positions)            # (G, C, H, Dh)
    p0, npg = start // page, C // page
    phys = page_tables[:, p0:p0 + npg].reshape(-1).long()   # (G*npg,)

    def put(pool, val):
        pool[phys] = val.reshape(G * npg, page, *val.shape[2:]).to(pool.dtype)

    _scatter_pools(pools, fmt, k, v, put)
    o = dispatch.paged_attn_prefill(
        q.reshape(G, C, hkv, hq // hkv, dh), pools["k_pages"],
        pools["v_pages"], page_tables, start, kv_format=fmt,
        kv_aux=_kv_aux(pools))
    o = o.reshape(G, C, hq * dh).to(x.dtype)
    return dense_apply(p["wo"], o, cfg.quant), pools

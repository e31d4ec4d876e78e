"""GQA attention: full-sequence flash attention (training and the dense
prefill), the dense cache's one-token decode, and the paged KV cache
(serving decode, the speculative verify window and chunked prefill).

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

Under a serving mesh (:func:`attn_spec`) a rank owns ``Hkv / tp`` KV
heads and their ``Hq / tp`` query heads, when "model" splits the KV
heads: its q / k / v projections keep their local columns, its pools
hold its heads, and attention runs the same kernels on them; the
context is gathered over "model" before ``wo``, whose contraction is
never split.  Otherwise every rank runs every head.  When a step's lanes
are split over "data", the new K / V rows of all lanes are gathered
before the scatter (the pools are whole on every data rank) and each
rank attends for its own lanes.

Under a training mesh (:func:`attn_spec` ``serving=False``, FSDP over
"data") q / k / v are column-parallel and ``wo`` row-parallel, as the
reference's Megatron layout: a rank attends with its own query heads
(all of them when "model" does not split the heads) against the whole
K / V heads they read (gathered over "model"; the gather's gradient
sums every rank's share back), and ``wo`` sums the ranks' partial
products (``common.dense_apply``).  The dense cache's decode takes a
cache whose time axis is cut over "model" (``cache_specs(kv_head_shard=
False)``) or over "data" (``cache_specs(seq_shard=True)``, long-context
decode at batch 1, every data rank computing the same query): each rank
attends over its block of positions and the blocks merge by their
log-sum-exp over the axes that cut them.
"""

from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from ..core.kv_quant import kv_format_of, kv_quant
from ..distributed.sharding import (DATA, MODEL, axis_index, axis_size,
                                    cut_axes, fsdp_active, gather,
                                    gather_lanes, is_sharded, lane_slice,
                                    splits, sum_grads)
from ..kernels import dispatch
from ..tree import tree_map
from .common import (apply_rope, dense_apply, dense_init, dense_spec,
                     norm_apply, norm_init, norm_spec)

__all__ = ["attn_init", "attn_spec", "attn_train", "attn_decode",
           "attn_decode_paged", "attn_verify_paged", "attn_prefill_paged",
           "flash_attention"]

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


def attn_spec(cfg: ModelConfig, serving: bool = True) -> dict:
    """The serving layout (default): every projection column-parallel
    (output channels over "model", the contraction whole on each rank),
    as the reference's ``attn_spec(serving=True)``.  The training layout
    (``serving=False``), the reference's Megatron pairs under FSDP:
    ``wq`` / ``wk`` / ``wv`` (data, model), ``wo`` (model, data)."""
    if serving:
        s = {k: dense_spec(None, MODEL, cfg.quant)
             for k in ("wq", "wk", "wv", "wo")}
    else:
        s = {k: dense_spec(DATA, MODEL, cfg.quant)
             for k in ("wq", "wk", "wv")}
        s["wo"] = dense_spec(MODEL, DATA, cfg.quant)
    if cfg.qk_norm:
        s["q_norm"] = norm_spec("rmsnorm")
        s["k_norm"] = norm_spec("rmsnorm")
    return s


def _heads(cfg: ModelConfig) -> tuple[int, int, bool]:
    """(query heads, KV heads, local): a rank's own heads when "model"
    splits the KV heads, every head otherwise."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if splits(hkv):
        tp = axis_size()
        return hq // tp, hkv // tp, True
    return hq, hkv, False


def _context(o: torch.Tensor, local: bool) -> torch.Tensor:
    """The attention context of every head (gathered over "model" from a
    rank's own heads), the input of ``wo``."""
    return gather(o, MODEL, -1) if local else o


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, batch_invariant: bool = True,
                 whole: bool = False):
    """q, k, v of a rank's own heads (:func:`_heads`), or with ``whole``
    of every head."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    hq, hkv, local = (cfg.n_heads, cfg.n_kv_heads, False) if whole \
        else _heads(cfg)
    kw = dict(batch_invariant=batch_invariant, local=local)
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


def _attn_mesh(p: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, batch_invariant: bool):
    """:func:`attn_train` under a training mesh (see the module
    docstring): x is this rank's block of the batch."""
    B, S, _ = x.shape
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    tp = axis_size(MODEL)
    kw = dict(batch_invariant=batch_invariant, local=True)
    q_cut = is_sharded(p["wq"]["w"], 1)
    if q_cut:                   # the column-parallel products' input
        x = sum_grads(x)
    q = dense_apply(p["wq"], x, cfg.quant, **kw)
    k = dense_apply(p["wk"], x, cfg.quant, **kw)
    v = dense_apply(p["wv"], x, cfg.quant, **kw)
    own = q_cut and hq % tp == 0          # whole query heads a rank
    # a rank's own query heads read its own KV heads when "model" splits
    # both; otherwise it reads them from every rank's columns
    kv_own = own and hkv % tp == 0 and is_sharded(p["wk"]["w"], 1)
    if q_cut and not own:
        q = gather(q, MODEL, -1)
    if is_sharded(p["wk"]["w"], 1) and not kv_own:
        k, v = gather(k, MODEL, -1), gather(v, MODEL, -1)
    hl = hq // tp if own else hq
    h0 = axis_index(MODEL) * hl if own else 0
    nk = hkv // tp if kv_own else hkv
    q = q.reshape(B, S, hl, dh)
    k = k.reshape(B, S, nk, dh)
    v = v.reshape(B, S, nk, dh)
    if "q_norm" in p:
        # this rank's heads only: the scales' gradients sum over "model"
        q = norm_apply(tree_map(sum_grads, p["q_norm"]), q, "rmsnorm")
        k = norm_apply(tree_map(sum_grads, p["k_norm"]), k, "rmsnorm")
    q = apply_rope(q, positions, dh, cfg.rope_fraction, cfg.rope_theta)
    k = apply_rope(k, positions, dh, cfg.rope_fraction, cfg.rope_theta)
    # the KV heads this rank's query heads read: a run of whole groups or
    # one head (a query group split unevenly over ranks: no arch has one)
    g = hq // hkv
    if kv_own:
        sel, n_kv = slice(None), nk
    elif hl % g == 0:
        sel, n_kv = slice(h0 // g, (h0 + hl) // g), hl // g
    elif g % hl == 0:
        sel, n_kv = slice(h0 // g, h0 // g + 1), 1
    else:
        raise NotImplementedError(
            f"{hl} query heads a rank split the groups of {g} unevenly "
            f"(n_heads {hq}, n_kv_heads {hkv}, model {tp})")
    o = flash_attention(q.reshape(B, S, n_kv, hl // n_kv, dh),
                        k[:, :, sel].contiguous(), v[:, :, sel].contiguous(),
                        cfg.causal)
    ctx = o.reshape(B, S, hl * dh)
    if is_sharded(p["wo"]["w"], 0) and not own:
        n = hq * dh // tp                 # wo's rows of this rank
        ctx = ctx.narrow(-1, axis_index(MODEL) * n, n)
    y = dense_apply(p["wo"], ctx, cfg.quant, batch_invariant=batch_invariant)
    return y, (k, v)


def attn_train(p: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, batch_invariant: bool = False):
    """Full-sequence attention, x (B, S, D) -> (y, (k, v)): the training
    forward (plain products) and, with ``batch_invariant``, the dense
    prefill (the serving products)."""
    if fsdp_active():
        return _attn_mesh(p, x, cfg, positions, batch_invariant)
    B, S, _ = x.shape
    dh = cfg.head_dim
    hq, hkv, local = _heads(cfg)
    q, k, v = _project_qkv(p, x, cfg, positions,
                           batch_invariant=batch_invariant)
    o = flash_attention(q.reshape(B, S, hkv, hq // hkv, dh), k, v,
                        cfg.causal)
    y = dense_apply(p["wo"], _context(o.reshape(B, S, hq * dh), local),
                    cfg.quant, batch_invariant=batch_invariant)
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
    dh = cfg.head_dim
    hq, hkv, local = _heads(cfg)
    positions = pos.to(torch.int32).expand(B, 1)
    cut = cut_axes(k_cache, 1)
    if cut:
        q, k, v = _project_qkv(p, x, cfg, positions, whole=True)
        o = _decode_time_cut(q, k, v, k_cache, v_cache, pos, cfg, cut)
        return dense_apply(p["wo"], o.reshape(B, 1, -1).to(x.dtype),
                           cfg.quant), k_cache, v_cache
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
    return dense_apply(p["wo"], _context(o, local), cfg.quant), k_cache, \
        v_cache


def _decode_time_cut(q, k, v, k_cache, v_cache, pos, cfg, axes):
    """:func:`attn_decode` on a cache whose time axis is cut over the mesh
    axes ``axes`` ("model", or "data" for long contexts; every head on
    every rank): the rank that owns ``pos`` writes the new K / V, each
    rank attends over its block of positions in float32, and the blocks
    merge by their log-sum-exp over ``axes`` (every rank the same
    result).  Returns the context (B, Hkv, G, Dh) float32."""
    B, T = k_cache.shape[:2]
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    t0 = axis_index(axes) * T
    idx = (pos - t0).clamp(0, T - 1).reshape(1).long()
    mine = (pos >= t0) & (pos < t0 + T)
    for cache, new in ((k_cache, k), (v_cache, v)):
        cache.index_copy_(1, idx, torch.where(
            mine, new.to(cache.dtype), cache.index_select(1, idx)))
    qg = q.reshape(B, hkv, hq // hkv, dh).to(torch.float32)
    logits = torch.einsum("bhgd,bthd->bhgt", qg,
                          k_cache.to(torch.float32)) / math.sqrt(dh)
    valid = t0 + torch.arange(T, device=q.device) <= pos
    logits = torch.where(valid, logits, torch.tensor(-1e30, device=q.device))
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    part = torch.cat([torch.einsum("bhgt,bthd->bhgd", e,
                                   v_cache.to(torch.float32)),
                      e.sum(-1, keepdim=True), m], dim=-1)
    every = gather(part[None], axes, 0)           # (n, B, Hkv, G, Dh + 2)
    w = torch.exp(every[..., -1:] - every[..., -1:].amax(0))
    return (w * every[..., :dh]).sum(0) / (w * every[..., dh:dh + 1]).sum(0)


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
    position), of all the step's lanes (x holds this rank's
    ``lane_slice()`` of them).  Returns (y (S, 1, D), pools)."""
    page_tables = pools["page_tables"]
    page = pools["k_pages"].shape[1]
    fmt = kv_format_of(pools)
    lanes = lane_slice()
    S = x.shape[0]
    dh = cfg.head_dim
    hq, hkv, local = _heads(cfg)
    q, k, v = _project_qkv(p, x, cfg, lengths[lanes, None])
    # one (page, offset) per lane; distinct live lanes own distinct pages,
    # padded lanes all hit the trash page
    phys = torch.gather(page_tables, 1,
                        (lengths // page)[:, None].long())[:, 0].long()
    off = (lengths % page).long()

    def put(pool, val):
        pool[phys, off] = val.to(pool.dtype)

    _scatter_pools(pools, fmt, gather_lanes(k[:, 0]), gather_lanes(v[:, 0]),
                   put)
    o = dispatch.paged_attn_decode(
        q.reshape(S, hkv, hq // hkv, dh), pools["k_pages"], pools["v_pages"],
        page_tables[lanes], lengths[lanes], kv_format=fmt,
        kv_aux=_kv_aux(pools))
    o = o.reshape(S, 1, hq * dh).to(x.dtype)
    return dense_apply(p["wo"], _context(o, local), cfg.quant), pools


def attn_verify_paged(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      pools: dict, lengths: torch.Tensor):
    """The speculative verify window.  x: (S, T, D), token t of lane s at
    cache position ``lengths[s] + t``.  All T K/V rows are scattered
    (over whatever the draft left there; a window may straddle a page
    boundary), then query t attends to positions ``<= lengths + t``
    (``dispatch.paged_attn_verify``); lanes as
    :func:`attn_decode_paged`'s.  Returns (y (S, T, D), pools)."""
    page_tables = pools["page_tables"]
    page = pools["k_pages"].shape[1]
    fmt = kv_format_of(pools)
    lanes = lane_slice()
    S, T, _ = x.shape
    dh = cfg.head_dim
    hq, hkv, local = _heads(cfg)
    positions = lengths[:, None] + torch.arange(T, dtype=torch.int32,
                                                device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions[lanes])     # (S, T, H, Dh)
    phys = torch.gather(page_tables, 1, (positions // page).long()).long()
    off = (positions % page).long()

    def put(pool, val):
        pool[phys, off] = val.to(pool.dtype)

    _scatter_pools(pools, fmt, gather_lanes(k), gather_lanes(v), put)
    o = dispatch.paged_attn_verify(
        q.reshape(S, T, hkv, hq // hkv, dh), pools["k_pages"],
        pools["v_pages"], page_tables[lanes], lengths[lanes], kv_format=fmt,
        kv_aux=_kv_aux(pools))
    o = o.reshape(S, T, hq * dh).to(x.dtype)
    return dense_apply(p["wo"], _context(o, local), cfg.quant), pools


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
    dh = cfg.head_dim
    hq, hkv, local = _heads(cfg)
    lanes = lane_slice()
    positions = start + torch.arange(C, dtype=torch.int32,
                                     device=x.device).expand(G, C)
    q, k, v = _project_qkv(p, x, cfg, positions)            # (G, C, H, Dh)
    k, v = gather_lanes(k), gather_lanes(v)
    p0, npg = start // page, C // page
    phys = page_tables[:, p0:p0 + npg].reshape(-1).long()   # (all lanes)

    def put(pool, val):
        pool[phys] = val.reshape(-1, page, *val.shape[2:]).to(pool.dtype)

    _scatter_pools(pools, fmt, k, v, put)
    o = dispatch.paged_attn_prefill(
        q.reshape(G, C, hkv, hq // hkv, dh), pools["k_pages"],
        pools["v_pages"], page_tables[lanes], start, kv_format=fmt,
        kv_aux=_kv_aux(pools))
    o = o.reshape(G, C, hq * dh).to(x.dtype)
    return dense_apply(p["wo"], _context(o, local), cfg.quant), pools

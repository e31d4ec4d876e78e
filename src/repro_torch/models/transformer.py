"""Decoder LM: training forward and loss, and serving over the paged cache.

Port of ``repro.models.transformer``: parameter init in the reference's
shapes, the training forward with per-period recomputation and the loss
(chunked cross-entropy too), the paged cache, one batched decode step and
the chunked paged prefill.  The reference stacks layers over a leading
``n_periods`` axis and scans them; the port keeps one parameter dict and
one pool dict per layer and loops over them in Python.

Each layer is the ``LayerSpec`` of its place in ``cfg.period``: a mixer
(attention, ``mamba.py`` or the rwkv6 time mix), then a dense FFN
(``ffn.py``), a mixture of experts (``moe.py``, whose balance loss is the
forward's ``aux``) or the rwkv channel mix.  Serving may cut the depth
below a whole period (layer ``i`` is ``cfg.period[i % len(period)]``).

Recurrent layers keep per-slot state rows in the paged cache (``max_slots
+ 1`` rows a leaf; the last is the scratch row that padded lanes write).
A decode step gathers each lane's rows by ``slot_ids`` and writes them
back; a prefill starts every lane from zero state, threads it chunk to
chunk with right-padded positions masked, and scatters each lane's final
carry into its slot's rows.  Training recurrent layers is not ported yet.

High-precision residual (paper §III): under ``sc_qat`` (the ``qat``
serving datapath) the residual stream re-quantizes at ``resid_bsl`` after
every add with the learned scales ``alpha_r1`` / ``alpha_r2``.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import LayerSpec, ModelConfig
from ..core.kv_quant import check_kv_format
from ..core.quant import lsq_fake_quant
from ..device import resolve_device
from ..tree import tree_map
from . import attention, ffn, mamba, moe, rwkv6
from .common import ACT_FNS, dense_apply, dense_init, norm_apply, norm_init

__all__ = ["init_params", "forward", "loss_fn", "init_paged_cache",
           "paged_decode_step", "paged_prefill", "gather_state_rows",
           "scatter_state_rows"]

_MIXER_INIT = {"attn": attention.attn_init, "mamba": mamba.mamba_init,
               "rwkv6": rwkv6.rwkv_tmix_init}
_FFN_INIT = {"dense": ffn.ffn_init, "moe": moe.moe_init,
             "rwkv_cmix": rwkv6.rwkv_cmix_init}
# a recurrent mixer's state keys, its one-token step and its prefill chunk
_RECURRENT = {"mamba": (("h", "conv"), mamba.mamba_decode,
                        mamba.mamba_prefill_chunk),
              "rwkv6": (("s", "shift"), rwkv6.rwkv_tmix_decode,
                        rwkv6.rwkv_tmix_prefill_chunk)}
# shared page-pool leaves of an attention layer's cache entry; every other
# leaf is a per-slot state row
_POOL_KEYS = ("k_pages", "v_pages", "k_scale", "v_scale", "k_resid",
              "v_resid")


def _check_ported(cfg: ModelConfig) -> None:
    for spec in cfg.period:
        if spec.mixer not in _MIXER_INIT or spec.ffn not in _FFN_INIT:
            raise NotImplementedError(
                f"{cfg.name}: layer {spec} is not ported yet")
    if cfg.is_encoder or cfg.logit_softcap or cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: not ported yet")
    if cfg.norm not in ("rmsnorm", "layernorm") \
            or cfg.ffn_act not in ACT_FNS:
        raise NotImplementedError(f"{cfg.name}: norm {cfg.norm!r} / "
                                  f"activation {cfg.ffn_act!r} not ported")


def _spec(cfg: ModelConfig, i: int) -> LayerSpec:
    return cfg.period[i % len(cfg.period)]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device | None = None) -> dict:
    """Random parameters in the reference's shapes and initialisation
    (``dense_init`` / ``embed_init``); ``generator`` must live on
    ``device`` (default ``cuda``)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    kw = dict(generator=generator, device=dev)
    table = torch.randn((cfg.padded_vocab, cfg.d_model), dtype=torch.float32,
                        **kw) * (1.0 / math.sqrt(cfg.d_model))
    layers = []
    for i in range(cfg.n_layers):
        spec = _spec(cfg, i)
        lp = {"norm1": norm_init(cfg.d_model, cfg.norm, dev),
              "mixer": _MIXER_INIT[spec.mixer](cfg, **kw),
              "norm2": norm_init(cfg.d_model, cfg.norm, dev),
              "ffn": _FFN_INIT[spec.ffn](cfg, **kw)}
        if cfg.quant.enabled:
            lp["alpha_r1"] = torch.tensor(0.05, device=dev)
            lp["alpha_r2"] = torch.tensor(0.05, device=dev)
        layers.append(lp)
    return {"embed": {"table": table.to(dt)},
            "layers": layers,
            "final_norm": norm_init(cfg.d_model, cfg.norm, dev),
            "lm_head": dense_init(cfg.d_model, cfg.padded_vocab, cfg.quant,
                                  dtype=dt, **kw)}


def _state_entry(cfg: ModelConfig, spec: LayerSpec, rows: int,
                 device: torch.device) -> dict:
    """Zero recurrent state of one layer for ``rows`` rows: the mixer's
    (mamba ``h`` / ``conv``, rwkv6 ``s`` / ``shift``) and the channel
    mix's ``{"cmix": {"shift"}}``; empty for attention + dense / MoE."""
    dt = getattr(torch, cfg.dtype)
    e = {}
    if spec.mixer == "mamba":
        e.update(mamba.mamba_state_init(cfg, rows, dt, device))
    elif spec.mixer == "rwkv6":
        e.update(rwkv6.rwkv_state_init(cfg, rows, dt, device))
    if spec.ffn == "rwkv_cmix":
        e["cmix"] = {"shift": torch.zeros((rows, cfg.d_model), dtype=dt,
                                          device=device)}
    return e


def init_paged_cache(cfg: ModelConfig, max_slots: int, num_pages: int,
                     page_size: int, kv_format: str = "fp",
                     device: str | torch.device | None = None) -> dict:
    """One entry per layer.  Attention layers get zeroed page pools:
    ``(num_pages, page, Hkv, Dh)`` in the model dtype for fp, int8 codes
    plus ``(num_pages, page, Hkv)`` f32 scales for int8, and int8 residual
    pools too for sc; all-zero pools dequantize to exact zeros in every
    format.  Recurrent layers get zeroed state rows, ``max_slots + 1`` of
    them (the last is the scratch row of padded lanes)."""
    check_kv_format(kv_format)
    _check_ported(cfg)
    dev = resolve_device(device)
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    kv_dt = getattr(torch, cfg.dtype) if kv_format == "fp" else torch.int8
    layers = []
    for i in range(cfg.n_layers):
        spec = _spec(cfg, i)
        e = _state_entry(cfg, spec, max_slots + 1, dev)
        if spec.mixer == "attn":
            e["k_pages"] = torch.zeros(shape, dtype=kv_dt, device=dev)
            e["v_pages"] = torch.zeros(shape, dtype=kv_dt, device=dev)
            if kv_format != "fp":
                e["k_scale"] = torch.zeros(shape[:3], device=dev)
                e["v_scale"] = torch.zeros(shape[:3], device=dev)
            if kv_format == "sc":
                e["k_resid"] = torch.zeros(shape, dtype=torch.int8,
                                           device=dev)
                e["v_resid"] = torch.zeros(shape, dtype=torch.int8,
                                           device=dev)
        layers.append(e)
    return {"layers": layers}


def _rows_of(entry: dict) -> dict:
    return {k: v for k, v in entry.items() if k not in _POOL_KEYS}


def _get_rows(entry: dict, idx: torch.Tensor) -> dict:
    return tree_map(lambda a: a[idx], _rows_of(entry))


def gather_state_rows(cache: dict, slot_ids: torch.Tensor) -> list[dict]:
    """Each layer's per-slot state rows at ``slot_ids`` (copies; ``{}``
    for a layer without state)."""
    return [_get_rows(e, slot_ids.long()) for e in cache["layers"]]


def _put_rows(entry: dict, rows: dict, idx: torch.Tensor) -> None:
    tree_map(lambda full, new: full.index_copy_(0, idx, new.to(full.dtype)),
             _rows_of(entry), rows)


def scatter_state_rows(cache: dict, rows: list[dict],
                       slot_ids: torch.Tensor) -> dict:
    """Write :func:`gather_state_rows`-shaped rows back into the cache at
    ``slot_ids``, in place (attention pools untouched).  Padded lanes all
    carry the scratch row; which of them lands there is unspecified, and
    no live request reads it."""
    for e, r in zip(cache["layers"], rows):
        _put_rows(e, r, slot_ids.long())
    return cache


def _residual_add(x, dx, lp, name, cfg: ModelConfig):
    y = x + dx
    if cfg.quant.enabled and cfg.quant.mode == "sc_qat":
        y = lsq_fake_quant(y, lp[name], -cfg.quant.resid_half,
                           cfg.quant.resid_half)
    return y


def _apply_layer(lp: dict, spec: LayerSpec, x: torch.Tensor,
                 cfg: ModelConfig, mixer, batch_invariant: bool = True,
                 cmix=None):
    """norm -> mixer (``mixer(h)``) -> residual -> norm -> dense FFN, MoE
    or the rwkv channel mix (``cmix(h)``) -> residual.  Returns (x, the
    layer's MoE aux loss or None)."""
    h = norm_apply(lp["norm1"], x, cfg.norm)
    x = _residual_add(x, mixer(h), lp, "alpha_r1", cfg)
    h2 = norm_apply(lp["norm2"], x, cfg.norm)
    aux = None
    if spec.ffn == "moe":
        dx, aux = moe.moe_apply(lp["ffn"], h2, cfg,
                                batch_invariant=batch_invariant)
    elif spec.ffn == "rwkv_cmix":
        dx = cmix(h2)
    else:
        dx = ffn.ffn_apply(lp["ffn"], h2, cfg,
                           batch_invariant=batch_invariant)
    return _residual_add(x, dx, lp, "alpha_r2", cfg), aux


def _vocab_bias(cfg: ModelConfig, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """-1e9 on the padded vocab slots."""
    iota = torch.arange(cfg.padded_vocab, device=device)
    return torch.where(iota < cfg.vocab_size, 0.0, -1e9).to(dtype)


def forward(params: dict, batch: dict, cfg: ModelConfig, mode: str = "train",
            return_hidden: bool = False):
    """Full-sequence training forward over ``batch["tokens"]`` (B, S).

    Returns (logits (B, S, V), aux), or with ``return_hidden`` the final
    normed hidden state (B, S, D) in place of the logits; ``aux`` is the
    sum of the MoE layers' balance losses (0 without MoE layers).  With
    ``cfg.remat == "full"`` each period of layers runs under
    ``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its
    period body: only the period's input is kept and the backward runs
    the period's forward again.  Products are plain (no batch-invariance
    casts); attention is the flash kernel on the card.
    """
    if mode != "train":
        raise NotImplementedError(f"forward mode {mode!r} is not ported "
                                  f"yet (train only)")
    _check_ported(cfg)
    if cfg.has_mixer("mamba") or cfg.has_mixer("rwkv6") \
            or cfg.has_ffn("rwkv_cmix"):
        raise NotImplementedError(
            f"{cfg.name}: training the recurrent mixers (mamba's associative "
            f"scan, rwkv6's chunked wkv) is not ported yet (ROADMAP Queue 1 "
            f"item 10); the port serves them only")
    table = params["embed"]["table"]
    tokens = batch["tokens"].to(device=table.device, dtype=torch.long)
    B, S = tokens.shape
    x = table[tokens]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)

    def period(layers, x):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for spec, lp in zip(cfg.period, layers):
            x, a = _apply_layer(
                lp, spec, x, cfg, lambda h, lp=lp: attention.attn_train(
                    lp["mixer"], h, cfg, positions)[0],
                batch_invariant=False)
            if a is not None:
                aux = aux + a
        return x, aux

    n = len(cfg.period)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, cfg.n_layers, n):
        layers = params["layers"][i:i + n]
        if cfg.remat == "full":
            x, a = checkpoint(period, layers, x, use_reentrant=False)
        else:
            x, a = period(layers, x)
        aux = aux + a
    x = norm_apply(params["final_norm"], x, cfg.norm)
    if return_hidden:
        return x, aux
    logits = dense_apply(params["lm_head"], x, cfg.quant,
                         batch_invariant=False)
    return logits + _vocab_bias(cfg, logits.dtype, logits.device), aux


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    tl = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return lse - tl


def loss_fn(params: dict, batch: dict, cfg: ModelConfig):
    """Mean next-token cross-entropy over ``batch`` (``tokens``,
    ``targets`` and an optional ``loss_mask``, all (B, S)) plus
    ``1e-2 * aux``.  Returns (loss, {"loss", "ce", "aux"}).

    ``cfg.ce_chunks > 1`` splits the sequence into that many chunks (or
    the largest count below it that divides S), each projected to the
    vocabulary and reduced under ``torch.utils.checkpoint``, so only one
    chunk's logits are alive at a time, in the forward and the backward.
    """
    dev = params["embed"]["table"].device
    targets = batch["targets"].to(dev)
    mask = batch.get("loss_mask")
    if cfg.ce_chunks > 1:
        hidden, aux = forward(params, batch, cfg, return_hidden=True)
        S = hidden.shape[1]
        nc = cfg.ce_chunks
        while S % nc:
            nc -= 1
        c = S // nc
        bias = _vocab_bias(cfg, torch.float32, dev)

        def chunk_nll(xc, tc):
            lc = dense_apply(params["lm_head"], xc, cfg.quant,
                             batch_invariant=False)
            return _nll(lc.to(torch.float32) + bias, tc)

        nll = torch.cat([checkpoint(chunk_nll, hidden[:, i:i + c],
                                    targets[:, i:i + c], use_reentrant=False)
                         for i in range(0, S, c)], dim=1)
    else:
        logits, aux = forward(params, batch, cfg)
        nll = _nll(logits, targets)
    if mask is not None:
        mask = mask.to(dev)
        ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        ce = nll.mean()
    loss = ce + 1e-2 * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = norm_apply(params["final_norm"], x, cfg.norm)
    logits = dense_apply(params["lm_head"], x, cfg.quant)
    return logits + _vocab_bias(cfg, logits.dtype, logits.device)


def _serve_layer(lp: dict, spec: LayerSpec, x: torch.Tensor,
                 cfg: ModelConfig, attn, state: dict,
                 valid: torch.Tensor | None):
    """One layer on the serving path.  ``attn(h)`` is the attention
    mixer's call on the paged pools; ``state`` the layer's recurrent state
    (gathered rows at decode, the group carry at prefill).  ``valid`` is
    None at decode (one token a lane: the recurrences' ``*_decode``) and
    the (G, C) mask of real prompt positions at prefill (``*_prefill_
    chunk``).  Returns (x, the new recurrent state)."""
    new = {}

    def mixer(h):
        if spec.mixer == "attn":
            return attn(h)
        keys, decode, prefill = _RECURRENT[spec.mixer]
        st = {k: state[k] for k in keys}
        dx, st = decode(lp["mixer"], h, cfg, st) if valid is None \
            else prefill(lp["mixer"], h, cfg, st, valid=valid)
        new.update(st)
        return dx

    def cmix(h):
        if valid is None:
            dx, new["cmix"] = rwkv6.rwkv_cmix_decode(lp["ffn"], h, cfg,
                                                     state["cmix"])
        else:
            dx, new["cmix"] = rwkv6.rwkv_cmix_prefill_chunk(
                lp["ffn"], h, cfg, state["cmix"], valid=valid)
        return dx

    x, _ = _apply_layer(lp, spec, x, cfg, mixer, cmix=cmix)
    return x, new


def paged_decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                      slot_ids: torch.Tensor, page_tables: torch.Tensor,
                      lengths: torch.Tensor, cfg: ModelConfig):
    """One batched decode step: every lane advances one token.

    tokens / slot_ids / lengths: (S,) int32; page_tables: (S, maxp) int32.
    Padded lanes carry length 0, trash-page tables and the scratch row
    ``max_slots``.  Attention layers read and write the pools; recurrent
    layers gather their state rows by ``slot_ids`` and write the new rows
    back.  The cache updates in place.  Returns (logits (S, V), cache).
    """
    x = params["embed"]["table"][tokens.long()][:, None, :]      # (S, 1, D)
    idx = slot_ids.long()
    for i, (lp, entry) in enumerate(zip(params["layers"], cache["layers"])):
        cst = dict(entry, page_tables=page_tables)
        x, new = _serve_layer(
            lp, _spec(cfg, i), x, cfg,
            lambda h, cst=cst, lp=lp: attention.attn_decode_paged(
                lp["mixer"], h, cfg, cst, lengths)[0],
            _get_rows(entry, idx), None)
        _put_rows(entry, new, idx)
    return _logits(params, x, cfg)[:, 0], cache


def paged_prefill(params: dict, cache: dict, tokens: torch.Tensor,
                  page_tables: torch.Tensor, prompt_lens: torch.Tensor,
                  cfg: ModelConfig, *, chunk: int,
                  slot_ids: torch.Tensor | None = None):
    """Batched chunked prefill into the decode cache layout.

    tokens: (G, L) right-padded prompts, L a multiple of ``chunk`` and
    ``chunk`` a multiple of the page size; page_tables: (G, width) with
    width >= L / page (padding = trash page); prompt_lens: (G,); slot_ids:
    (G,) the slot of each lane (padding = the scratch row), needed when a
    layer has recurrent state.  Each chunk runs every layer: attention
    scatters its K/V as whole pages and attends over the pages written so
    far; a recurrent layer carries each lane's state from zero, chunk to
    chunk, with the positions past the prompt masked so that the state
    freezes at the last real token (any chunk size gives the same bits).
    At the end each lane's carry goes to its slot's state rows.  Returns
    (logits of each request's last prompt token (G, V), cache).
    """
    G, L = tokens.shape
    if L % chunk:
        raise ValueError(f"prompt bucket {L} is not a multiple of the "
                         f"chunk {chunk}")
    table = params["embed"]["table"]
    specs = [_spec(cfg, i) for i in range(len(params["layers"]))]
    # prompt state starts from zero, never from a slot's previous rows
    carry = [_state_entry(cfg, spec, G, table.device) for spec in specs]
    if any(carry) and slot_ids is None:
        raise ValueError("recurrent layers need slot_ids to place their "
                         "state rows")
    h_last = torch.zeros((G, cfg.d_model), dtype=table.dtype,
                         device=table.device)
    pos = torch.arange(chunk, device=table.device)
    for c in range(L // chunk):
        start = c * chunk
        x = table[tokens[:, start:start + chunk].long()]         # (G, C, D)
        valid = (start + pos)[None, :] < prompt_lens[:, None]   # (G, C)
        for i, (lp, entry) in enumerate(zip(params["layers"],
                                            cache["layers"])):
            cst = dict(entry, page_tables=page_tables)
            x, carry[i] = _serve_layer(
                lp, specs[i], x, cfg,
                lambda h, cst=cst, lp=lp, s=start:
                attention.attn_prefill_paged(lp["mixer"], h, cfg, cst,
                                             s)[0], carry[i], valid)
        # keep the hidden state of each request's last real token
        last = prompt_lens.long() - 1 - start
        rows = torch.gather(x, 1, last.clamp(0, chunk - 1)[:, None, None]
                            .expand(G, 1, cfg.d_model))[:, 0]
        hit = ((last >= 0) & (last < chunk))[:, None]
        h_last = torch.where(hit, rows, h_last)
    if any(carry):
        scatter_state_rows(cache, carry, slot_ids)
    return _logits(params, h_last[:, None, :], cfg)[:, 0], cache

"""Decoder LM: training forward and loss, serving over the dense cache and
over the paged cache.

Port of ``repro.models.transformer``: parameter init in the reference's
shapes, the training forward with per-period recomputation and the loss
(chunked cross-entropy too), the dense cache (``init_cache``,
``prefill``, ``decode_step``: the reference's unpaged entry points and
its fp serving oracle), the paged cache, one batched decode step, the
speculative verify step and the chunked paged prefill.  The reference
stacks layers over a leading ``n_periods`` axis and scans them; the port
keeps one parameter dict and one cache dict per layer and loops over
them in Python.

Each layer is the ``LayerSpec`` of its place in ``cfg.period``: a mixer
(attention, ``mamba.py`` or the rwkv6 time mix), then a dense FFN
(``ffn.py``), a mixture of experts (``moe.py``, whose balance loss is the
forward's ``aux``) or the rwkv channel mix.  Serving may cut the depth
below a whole period (layer ``i`` is ``cfg.period[i % len(period)]``).

Training runs the recurrent mixers' training forms (mamba's chunked
associative scan, rwkv6's token or chunked wkv); every serving path runs
their per-token recurrences.  The dense prefill (``forward(mode=
"prefill")``) starts them from zero state and returns each layer's cache
entry: an attention layer's K / V, a recurrent layer's final state.
Recurrent layers keep per-slot state rows in the paged cache (``max_slots
+ 1`` rows a leaf; the last is the scratch row that padded lanes write).
A decode step gathers each lane's rows by ``slot_ids`` and writes them
back; a prefill starts every lane from zero state, threads it chunk to
chunk with right-padded positions masked, and scatters each lane's final
carry into its slot's rows.

High-precision residual (paper §III): under ``sc_qat`` (the ``qat``
serving datapath) the residual stream re-quantizes at ``resid_bsl`` after
every add with the learned scales ``alpha_r1`` / ``alpha_r2``.

Mesh serving.  Under active ``distributed.sharding`` rules every rank
holds its block of the parameters (:func:`param_specs`) and of the paged
cache (:func:`paged_cache_specs`) and runs the same steps on them: each
layer gathers what it sharded, so the residual stream and the logits are
whole on every rank (the embedding's owner rows, the lm_head's vocabulary
columns).  A step's lanes split over "data" in contiguous blocks
(``split_lanes``): each data rank embeds and runs its block, the new K /
V rows, state rows, verify snapshots and logits of all lanes are
gathered over "data", and the pools and state rows stay whole on every
data rank.  The dense entry points (``prefill``, ``decode_step``) shard
over "model" only under a serving mesh.

Under a training mesh (``sharding.fsdp_active``: the training mapping,
the layout of ``param_specs(serving=False)``) every rank runs its block
of the batch: the embedding table and every weight's "data"-cut
dimension are gathered at use (FSDP), the vocabulary-parallel embedding
sums its ranks' rows, attention / FFN / MoE run tensor- and
expert-parallel over "model", and :func:`loss_fn` takes the
vocabulary-parallel cross-entropy of the rank's lm_head columns and the
global token-weighted mean over the batch axes.  The recurrent mixers
run their heads or channels a rank (``mamba.py``, ``rwkv6.py``).  The
dense entry points run under it too, the batch cut over the batch axes
(the dry-run's prefill and decode cells), the decode's cache cut as
:func:`cache_specs` says: K / V time over "model" when the KV heads do
not split, or over "data" (long-context decode at batch 1, every data
rank holding the same recurrent state).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import LayerSpec, ModelConfig
from ..core.kv_quant import check_kv_format
from ..core.quant import lsq_fake_quant
from ..device import resolve_device
from ..distributed.sharding import (DATA, MODEL, axis_index, axis_size,
                                    batch_axes, cols, current_rules,
                                    fsdp_active, gather, gather_lanes,
                                    is_sharded, psum, shard_tree,
                                    split_lanes, sum_grads)
from ..tree import tree_map
from . import attention, ffn, mamba, moe, rwkv6
from .common import (ACT_FNS, dense_apply, dense_init, dense_spec,
                     fsdp_gather, norm_apply, norm_init, norm_spec,
                     whole_numel)

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "decode_step",
           "prefill", "init_paged_cache", "paged_decode_step",
           "paged_prefill", "paged_verify_step", "gather_state_rows",
           "scatter_state_rows", "select_state_snapshot", "param_specs",
           "paged_cache_specs", "cache_specs", "supports_paged_prefill",
           "batch_specs", "make_dummy_batch"]

_MIXER_INIT = {"attn": attention.attn_init, "mamba": mamba.mamba_init,
               "rwkv6": rwkv6.rwkv_tmix_init}
_FFN_INIT = {"dense": ffn.ffn_init, "moe": moe.moe_init,
             "rwkv_cmix": rwkv6.rwkv_cmix_init}
_MIXER_SPEC = {"attn": attention.attn_spec, "mamba": mamba.mamba_spec,
               "rwkv6": rwkv6.rwkv_tmix_spec}
_FFN_SPEC = {"dense": ffn.ffn_spec, "moe": moe.moe_spec,
             "rwkv_cmix": rwkv6.rwkv_cmix_spec}
# a recurrent mixer's state keys, its one-token step and its prefill chunk
_RECURRENT = {"mamba": (("h", "conv"), mamba.mamba_decode,
                        mamba.mamba_prefill_chunk),
              "rwkv6": (("s", "shift"), rwkv6.rwkv_tmix_decode,
                        rwkv6.rwkv_tmix_prefill_chunk)}
# a recurrent mixer's training form
_TRAIN = {"mamba": mamba.mamba_train, "rwkv6": rwkv6.rwkv_tmix_train}
# shared page-pool leaves of an attention layer's cache entry; every other
# leaf is a per-slot state row
_POOL_KEYS = ("k_pages", "v_pages", "k_scale", "v_scale", "k_resid",
              "v_resid")
# a front-end stub's input width: precomputed patch embeddings (vision) or
# conv-stem frame features (audio), projected into d_model
_FRONTEND_IN = {"vision_stub": 1024, "audio_stub": 512}


def _check_ported(cfg: ModelConfig) -> None:
    """Refuse what the port does not run.  ``logit_softcap`` and
    ``tie_embeddings`` pass: the reference's models read neither."""
    for spec in cfg.period:
        if spec.mixer not in _MIXER_INIT or spec.ffn not in _FFN_INIT:
            raise NotImplementedError(
                f"{cfg.name}: layer {spec} is not ported yet")
    if cfg.frontend != "none" and cfg.frontend not in _FRONTEND_IN:
        raise NotImplementedError(f"{cfg.name}: front end "
                                  f"{cfg.frontend!r} not ported")
    if cfg.norm not in ("rmsnorm", "layernorm") \
            or cfg.ffn_act not in ACT_FNS:
        raise NotImplementedError(f"{cfg.name}: norm {cfg.norm!r} / "
                                  f"activation {cfg.ffn_act!r} not ported")


def _check_decoder(cfg: ModelConfig) -> None:
    """An encoder (bidirectional) arch has no decode step and no cache."""
    _check_ported(cfg)
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name}: encoder archs have no decode step; "
                         "run them through forward")


def supports_paged_prefill(cfg: ModelConfig) -> bool:
    """Chunked paged prefill covers every decoder layer kind; only the
    front-end archs are left out: their inputs are not token prompts."""
    return cfg.frontend == "none"


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
    params = {"embed": {"table": table.to(dt)},
              "layers": layers,
              "final_norm": norm_init(cfg.d_model, cfg.norm, dev),
              "lm_head": dense_init(cfg.d_model, cfg.padded_vocab, cfg.quant,
                                    dtype=dt, **kw)}
    if cfg.frontend != "none":
        # the stub's projections: patch embeddings through w1, gelu and
        # w2 (vision), frame features through w1 (audio)
        fe = {"w1": dense_init(_FRONTEND_IN[cfg.frontend], cfg.d_model,
                               cfg.quant, dtype=dt, **kw)}
        if cfg.frontend == "vision_stub":
            fe["w2"] = dense_init(cfg.d_model, cfg.d_model, cfg.quant,
                                  dtype=dt, **kw)
        params["frontend"] = fe
    return params


def param_specs(cfg: ModelConfig, serving: bool = True) -> dict:
    """A layout of :func:`init_params`'s tree (physical spec tuples, for
    ``shard_tree``).  The serving layout (default): every projection
    column-parallel over "model", experts over "model", the embedding's
    vocabulary over "model" and its width over "data" (the reference's
    ``embed_spec``), the lm_head's vocabulary over "model", norms and
    scalars whole.  The training layout (``serving=False``) is the
    reference's ``param_specs(serving=False)``, a list of layers in place
    of its stacked periods: Megatron column / row pairs with the other
    dimension over "data" (FSDP), experts over "model" with ``d_model``
    over "data", the lm_head (data, model)."""
    _check_ported(cfg)

    def layer(spec: LayerSpec) -> dict:
        s = {"norm1": norm_spec(cfg.norm),
             "mixer": _MIXER_SPEC[spec.mixer](cfg, serving=serving),
             "norm2": norm_spec(cfg.norm),
             "ffn": _FFN_SPEC[spec.ffn](cfg, serving=serving)}
        if cfg.quant.enabled:
            s["alpha_r1"] = ()
            s["alpha_r2"] = ()
        return s
    specs = {"embed": {"table": (MODEL, DATA)},
             "layers": [layer(_spec(cfg, i)) for i in range(cfg.n_layers)],
             "final_norm": norm_spec(cfg.norm),
             "lm_head": dense_spec(None if serving else DATA, MODEL,
                                   cfg.quant)}
    if cfg.frontend != "none":
        # the front end's projections stay whole on every rank
        specs["frontend"] = {k: dense_spec(None, None, cfg.quant)
                             for k in ("w1", "w2")
                             if k == "w1" or cfg.frontend == "vision_stub"}
    return specs


def _state_specs(spec: LayerSpec) -> dict:
    """Logical axes of one layer's state rows (:func:`_state_entry`)."""
    e = {}
    if spec.mixer == "mamba":
        e.update(mamba.mamba_state_spec())
    elif spec.mixer == "rwkv6":
        e.update(rwkv6.rwkv_state_spec())
    if spec.ffn == "rwkv_cmix":
        e["cmix"] = {"shift": (None, None)}
    return e


def paged_cache_specs(cfg: ModelConfig, kv_format: str = "fp") -> dict:
    """Logical axes of :func:`init_paged_cache`'s tree (``shard_tree(...,
    logical=True)``): the KV pools (and their scale / residual pools)
    over their KV heads, the state rows over their channels (mamba's
    ``d_inner``, rwkv6's heads).  Page and row axes are never sharded:
    the allocator and the page tables never see the mesh."""
    check_kv_format(kv_format)
    _check_ported(cfg)
    pool = (None, None, "model", None)        # (num_pages, page, Hkv, Dh)
    layers = []
    for i in range(cfg.n_layers):
        spec = _spec(cfg, i)
        e = _state_specs(spec)
        if spec.mixer == "attn":
            e["k_pages"] = e["v_pages"] = pool
            if kv_format != "fp":
                e["k_scale"] = e["v_scale"] = pool[:3]
            if kv_format == "sc":
                e["k_resid"] = e["v_resid"] = pool
        layers.append(e)
    return {"layers": layers}


def cache_specs(cfg: ModelConfig, seq_shard: bool = False,
                kv_head_shard: bool = True) -> dict:
    """Logical axes of :func:`init_cache`'s tree (``shard_tree(...,
    logical=True)``), the reference's ``cache_specs`` without its stacked
    leading axis.  ``seq_shard``: K / V time over "seq" (long-context
    parallelism, batch 1); ``kv_head_shard=False``: the KV heads do not
    divide "model", so K / V time goes over "model" instead (the decode
    merges the blocks by their log-sum-exp)."""
    _check_ported(cfg)
    if seq_shard:
        kv = (None, "seq", None, None)
    elif kv_head_shard:
        kv = ("batch", None, "model", None)
    else:
        kv = ("batch", "model", None, None)
    layers = []
    for i in range(cfg.n_layers):
        spec = _spec(cfg, i)
        e = {}
        if spec.mixer == "attn":
            e["k"] = e["v"] = kv
        elif spec.mixer == "mamba":
            e.update(h=("batch", "model", None), conv=("batch", None, "model"))
        elif spec.mixer == "rwkv6":
            e.update(s=("batch", "model", None, None), shift=("batch", None))
        if spec.ffn == "rwkv_cmix":
            e["cmix"] = {"shift": ("batch", None)}
        layers.append(e)
    return {"pos": (), "layers": layers}


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


def _carry_entry(cfg: ModelConfig, spec: LayerSpec, rows: int,
                 device: torch.device) -> dict:
    """:func:`_state_entry`, this rank's block of it under a mesh: the
    zero state a prefill starts from."""
    e = _state_entry(cfg, spec, rows, device)
    rules = current_rules()
    if rules is None or not e:
        return e
    return shard_tree(e, _state_specs(spec), rules, logical=True)


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens`` (any shape), whole on every rank.
    Under a mesh a rank holds a block of the vocabulary (and of d_model
    over "data"): it looks up the tokens its block owns, the blocks'
    rows are gathered over "model" and each token keeps its owner's row
    (a copy), then d_model is gathered over "data"."""
    tok = tokens.long()
    if fsdp_active():
        return _embed_mesh(table, tok)
    if not is_sharded(table, 0):
        x = table[tok]
    else:
        rows = table.shape[0]
        own = tok // rows
        mine = torch.where(own == axis_index(MODEL), tok - own * rows, 0)
        every = gather(table[mine].reshape(1, tok.numel(), -1), MODEL, 0)
        x = every[own.reshape(-1), torch.arange(
            tok.numel(), device=tok.device)].reshape(*tok.shape, -1)
    return cols(x, table, False, DATA)


def _embed_mesh(table: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """:func:`_embed` under a training mesh, the tokens this rank's block
    of the batch: the table's width gathered over "data" (FSDP), each
    rank's rows of the tokens its vocabulary block owns (zeros for the
    others) summed over "model", an exact sum of one row and zeros."""
    cut = is_sharded(table, 0)
    table = fsdp_gather(table)
    if not cut:
        return table[tok]
    rows = table.shape[0]
    own = (tok // rows) == axis_index(MODEL)
    x = table[torch.where(own, tok - axis_index(MODEL) * rows, 0)]
    return psum(torch.where(own[..., None], x, torch.zeros((), dtype=x.dtype,
                                                           device=x.device)))


def _gather_rows(rows: dict, dim: int = 0) -> dict:
    """A layer's new state rows (or verify snapshots: ``dim=1``) of all
    lanes, from a data rank's block."""
    return tree_map(lambda a: gather_lanes(a, dim), rows)


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
    _check_decoder(cfg)
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
    """``x + dx``, fake-quantized under sc_qat; under a training mesh the
    LSQ gradient scale counts the whole batch, not this rank's block."""
    y = x + dx
    if cfg.quant.enabled and cfg.quant.mode == "sc_qat":
        numel = whole_numel(y, batch_cut=True) if fsdp_active() else None
        y = lsq_fake_quant(y, lp[name], -cfg.quant.resid_half,
                           cfg.quant.resid_half, numel)
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


def _train_layer(lp: dict, spec: LayerSpec, x: torch.Tensor,
                 cfg: ModelConfig, positions: torch.Tensor):
    """One layer of the training forward: attention through the flash
    kernel, a recurrent mixer through its training form, plain products.
    Returns (x, the MoE aux loss or None)."""
    def mixer(h):
        if spec.mixer == "attn":
            return attention.attn_train(lp["mixer"], h, cfg, positions)[0]
        return _TRAIN[spec.mixer](lp["mixer"], h, cfg)[0]

    return _apply_layer(
        lp, spec, x, cfg, mixer, batch_invariant=False,
        cmix=lambda h: rwkv6.rwkv_cmix_train(lp["ffn"], h, cfg)[0])


def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig,
                  batch_invariant: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The model's input rows (B, S, D) and their positions ``arange(S)``.
    Without a front end, the embedding of ``batch["tokens"]``.  A vision
    stub maps ``batch["patch_embeds"]`` (B, S_img, 1024) through ``w1``,
    gelu and ``w2``, and its rows go first, then the text tokens' (S =
    S_img + S_txt); an audio stub maps ``batch["frames"]`` (B, T, 512)
    through ``w1``.  Embeddings are cast to the table's dtype first, as
    the reference's."""
    table = params["embed"]["table"]
    kw = dict(batch_invariant=batch_invariant)

    def tokens():
        return _embed(table, batch["tokens"].to(device=table.device,
                                                dtype=torch.long))

    def stub_input(name):
        return batch[name].to(device=table.device, dtype=table.dtype)
    if cfg.frontend == "vision_stub":
        fe = params["frontend"]
        img = ACT_FNS["gelu"](dense_apply(fe["w1"], stub_input(
            "patch_embeds"), cfg.quant, **kw))
        img = dense_apply(fe["w2"], img, cfg.quant, **kw)
        x = torch.cat([img, tokens()], dim=1)
    elif cfg.frontend == "audio_stub":
        x = dense_apply(params["frontend"]["w1"], stub_input("frames"),
                        cfg.quant, **kw)
    else:
        x = tokens()
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return x, positions


def forward(params: dict, batch: dict, cfg: ModelConfig, mode: str = "train",
            return_hidden: bool = False):
    """Full-sequence forward over the batch's inputs: ``batch["tokens"]``
    (B, S), or a front-end arch's embeddings (:func:`_embed_inputs`).

    ``mode="train"`` returns (logits (B, S, V), aux), or with
    ``return_hidden`` the final normed hidden state (B, S, D) in place of
    the logits; ``aux`` is the sum of the MoE layers' balance losses (0
    without MoE layers).  With ``cfg.remat == "full"`` each period of
    layers runs under ``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint`` of its period body: only the period's input is
    kept and the backward runs the period's forward again.  Products are
    plain (no batch-invariance casts); attention is the flash kernel on
    the card; recurrent mixers run their training forms.

    ``mode="prefill"`` is the dense prefill: the serving products, the
    recurrences' per-token prefill from zero state, and a third result,
    one cache entry a layer (an attention layer's ``k`` / ``v`` (B, S,
    Hkv, Dh), a recurrent layer's final state, as ``init_cache``'s).
    """
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward mode must be 'train' or 'prefill', "
                         f"got {mode!r}")
    _check_ported(cfg)
    x, positions = _embed_inputs(params, batch, cfg,
                                 batch_invariant=mode == "prefill")
    if mode == "prefill":
        return _prefill_forward(params, x, positions, cfg, return_hidden)

    def period(layers, x):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for spec, lp in zip(cfg.period, layers):
            x, a = _train_layer(lp, spec, x, cfg, positions)
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


def _local_logits(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  dtype: torch.dtype | None = None) -> torch.Tensor:
    """The lm_head's logits of this rank's vocabulary block (all of them
    when "model" does not cut it), with the padding bias."""
    lm = params["lm_head"]
    if is_sharded(lm["w"], 1):           # a column-parallel product's input
        x = sum_grads(x)
    logits = dense_apply(lm, x, cfg.quant, batch_invariant=False, local=True)
    dt = dtype or logits.dtype
    bias = _vocab_bias(cfg, dt, logits.device)
    if is_sharded(lm["w"], 1):
        n = logits.shape[-1]
        bias = bias.narrow(0, axis_index(MODEL) * n, n)
    return logits.to(dt) + bias


def _nll_mesh(logits: torch.Tensor, targets: torch.Tensor,
              vocab_cut: bool) -> torch.Tensor:
    """The cross-entropy of logits over this rank's vocabulary block: the
    log-sum-exp and the target's logit summed over "model"."""
    if not vocab_cut:
        return _nll(logits, targets)
    lf = logits.to(torch.float32)
    n = lf.shape[-1]
    m = gather(lf.detach().amax(-1, keepdim=True), MODEL, -1).amax(
        -1, keepdim=True)
    lse = torch.log(psum(torch.exp(lf - m).sum(-1))) + m[..., 0]
    t = targets.long() - axis_index(MODEL) * n
    here = (t >= 0) & (t < n)
    tl = torch.gather(lf, -1, t.clamp(0, n - 1)[..., None])[..., 0]
    return lse - psum(torch.where(here, tl, torch.zeros((), device=lf.device)))


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

    Under a training mesh ``batch`` is this rank's block: the
    cross-entropy is taken over the rank's vocabulary block of the logits
    (:func:`_nll_mesh`), and the token-weighted mean and the MoE loss's
    mean over every rank of the batch axes, so every rank holds the
    unsharded loss.
    """
    dev = params["embed"]["table"].device
    targets = batch["targets"].to(dev)
    mask = batch.get("loss_mask")
    hidden, aux = forward(params, batch, cfg, return_hidden=True)
    cut = fsdp_active() and is_sharded(params["lm_head"]["w"], 1)
    if cfg.ce_chunks > 1:
        S = hidden.shape[1]
        c = _chunks(S, cfg.ce_chunks)

        def chunk_nll(xc, tc):
            return _nll_mesh(_local_logits(params, xc, cfg, torch.float32),
                             tc, cut)
        nll = torch.cat([checkpoint(chunk_nll, hidden[:, i:i + c],
                                    targets[:, i:i + c], use_reentrant=False)
                         for i in range(0, S, c)], dim=1)
    else:
        nll = _nll_mesh(_local_logits(params, hidden, cfg), targets, cut)
    axes = batch_axes()
    if mask is not None:
        mask = mask.to(dev)
        ce = psum((nll * mask).sum(), axes) \
            / torch.clamp(psum(mask.sum(), axes), min=1.0)
    else:
        ce = psum(nll.sum(), axes) / (nll.numel() * axis_size(axes))
    aux = psum(aux, axes) / axis_size(axes)
    loss = ce + 1e-2 * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def _chunks(S: int, ce_chunks: int) -> int:
    """The chunk length of the chunked cross-entropy: S over ``ce_chunks``
    or the largest count below it that divides S."""
    nc = ce_chunks
    while S % nc:
        nc -= 1
    return S // nc


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = norm_apply(params["final_norm"], x, cfg.norm)
    logits = dense_apply(params["lm_head"], x, cfg.quant)
    return logits + _vocab_bias(cfg, logits.dtype, logits.device)


def _verify_scan(step, x: torch.Tensor, state: dict):
    """A one-token recurrent ``step(x_t, state) -> (dx_t, state)`` over the
    (S, T, D) verify window, token by token, so that the window's hidden
    states are bit for bit those of T decode steps.  Returns (dx (S, T,
    D), the state after each token, leaves stacked (T, S, ...))."""
    dxs, snaps = [], []
    for t in range(x.shape[1]):
        dx, state = step(x[:, t:t + 1], state)
        dxs.append(dx)
        snaps.append(state)
    return torch.cat(dxs, dim=1), tree_map(lambda *a: torch.stack(a),
                                           *snaps)


def _serve_layer(lp: dict, spec: LayerSpec, x: torch.Tensor,
                 cfg: ModelConfig, attn, state: dict, *,
                 mode: str = "prefill", valid: torch.Tensor | None = None):
    """One layer on a serving path (serving products).  ``attn(h)`` is
    the attention mixer's call on the cache; ``state`` the layer's
    recurrent state (gathered rows or the dense cache's at decode and
    verify, the carry at prefill).  ``mode="decode"`` takes one token a
    lane through the recurrences' ``*_decode``; ``"verify"`` a window of
    T tokens through the same steps one token at a time, the new state
    then holding each token's snapshot (leaves (T, S, ...)); ``"prefill"``
    a chunk through ``*_prefill_chunk`` with ``valid`` the (G, C) mask of
    real prompt positions (None: all).  Returns (x, the new recurrent
    state, the MoE aux loss or None)."""
    new = {}

    def recur(step, x_, st):
        if mode == "verify":
            return _verify_scan(step, x_, st)
        return step(x_, st)

    def mixer(h):
        if spec.mixer == "attn":
            return attn(h)
        keys, step, chunk = _RECURRENT[spec.mixer]
        st = {k: state[k] for k in keys}
        if mode == "prefill":
            dx, st = chunk(lp["mixer"], h, cfg, st, valid=valid)
        else:
            dx, st = recur(lambda xt, s: step(lp["mixer"], xt, cfg, s), h,
                           st)
        new.update(st)
        return dx

    def cmix(h):
        if mode == "prefill":
            dx, new["cmix"] = rwkv6.rwkv_cmix_prefill_chunk(
                lp["ffn"], h, cfg, state["cmix"], valid=valid)
        else:
            dx, new["cmix"] = recur(
                lambda xt, s: rwkv6.rwkv_cmix_decode(lp["ffn"], xt, cfg, s),
                h, state["cmix"])
        return dx

    x, aux = _apply_layer(lp, spec, x, cfg, mixer, cmix=cmix)
    return x, new, aux


def _prefill_forward(params: dict, x: torch.Tensor, positions: torch.Tensor,
                     cfg: ModelConfig, return_hidden: bool):
    """``forward(mode="prefill")`` from the embedded tokens x (B, S, D)."""
    B = x.shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    entries = []
    for i, lp in enumerate(params["layers"]):
        spec = _spec(cfg, i)
        kv = {}

        def attn(h, lp=lp, kv=kv):
            y, (kv["k"], kv["v"]) = attention.attn_train(
                lp["mixer"], h, cfg, positions, batch_invariant=True)
            return y
        x, new, a = _serve_layer(lp, spec, x, cfg, attn,
                                 _carry_entry(cfg, spec, B, x.device))
        if a is not None:
            aux = aux + a
        entries.append(dict(kv, **new))
    if return_hidden:
        return norm_apply(params["final_norm"], x, cfg.norm), aux, entries
    return _logits(params, x, cfg), aux, entries


def _cache_entry_shapes(cfg: ModelConfig, spec: LayerSpec, batch: int,
                        max_len: int, device: torch.device) -> dict:
    """One layer's zero dense-cache entry: ``k`` / ``v`` (batch, max_len,
    Hkv, Dh) in the model dtype for attention, the recurrent state of
    ``batch`` rows otherwise."""
    e = _state_entry(cfg, spec, batch, device)
    if spec.mixer == "attn":
        shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        dt = getattr(torch, cfg.dtype)
        e["k"] = torch.zeros(shape, dtype=dt, device=device)
        e["v"] = torch.zeros(shape, dtype=dt, device=device)
    return e


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device | None = None) -> dict:
    """The dense (unpaged) decode cache: ``pos`` (a 0-d int32 tensor, the
    next token's position) and one zero entry a layer."""
    _check_decoder(cfg)
    dev = resolve_device(device)
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "layers": [_cache_entry_shapes(cfg, _spec(cfg, i), batch,
                                           max_len, dev)
                       for i in range(cfg.n_layers)]}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One token for each of the B rows on the dense cache.  tokens: (B,
    1) int.  Attention layers write their K / V at ``cache["pos"]`` in
    place and attend over the cache (``attention.attn_decode``);
    recurrent layers take one step of their recurrence.  Returns (logits
    (B, 1, V), the cache with ``pos`` advanced and the new states)."""
    _check_decoder(cfg)
    pos = cache["pos"]
    x = _embed(params["embed"]["table"], tokens)               # (B, 1, D)
    layers = []
    for i, (lp, entry) in enumerate(zip(params["layers"], cache["layers"])):
        x, new, _ = _serve_layer(
            lp, _spec(cfg, i), x, cfg,
            lambda h, lp=lp, e=entry: attention.attn_decode(
                lp["mixer"], h, cfg, e["k"], e["v"], pos)[0],
            entry, mode="decode")
        layers.append(dict(entry, **new))
    return _logits(params, x, cfg), {"pos": pos + 1, "layers": layers}


def prefill(params: dict, batch: dict, cfg: ModelConfig):
    """The dense prefill over ``batch["tokens"]`` (B, S): (logits (B, S,
    V), the dense cache holding the S positions, ``pos`` = S).  Pad the
    ``k`` / ``v`` to the decode horizon before ``decode_step``."""
    logits, _, entries = forward(params, batch, cfg, mode="prefill")
    return logits, {"pos": torch.tensor(logits.shape[1], dtype=torch.int32,
                                        device=logits.device),
                    "layers": entries}


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
    _check_decoder(cfg)
    idx = slot_ids.long()
    with split_lanes(tokens.shape[0]) as lanes:
        x = _embed(params["embed"]["table"], tokens)[lanes][:, None, :]
        for i, (lp, entry) in enumerate(zip(params["layers"],
                                            cache["layers"])):
            cst = dict(entry, page_tables=page_tables)
            x, new, _ = _serve_layer(
                lp, _spec(cfg, i), x, cfg,
                lambda h, cst=cst, lp=lp: attention.attn_decode_paged(
                    lp["mixer"], h, cfg, cst, lengths)[0],
                _get_rows(entry, idx[lanes]), mode="decode")
            _put_rows(entry, _gather_rows(new), idx)
        return gather_lanes(_logits(params, x, cfg)[:, 0]), cache


def paged_verify_step(params: dict, cache: dict, tokens: torch.Tensor,
                      slot_ids: torch.Tensor, page_tables: torch.Tensor,
                      lengths: torch.Tensor, cfg: ModelConfig):
    """The speculative verify step: a window of T tokens a lane in one
    forward.

    tokens: (S, T) int32, a lane's last committed token and its T - 1
    drafts, at cache positions ``lengths .. lengths + T - 1``; the other
    arguments as :func:`paged_decode_step`'s.  Attention layers scatter
    the window's K / V and score row t at length ``lengths + t``
    (``attention.attn_verify_paged``); recurrent layers run their decode
    step once a token (:func:`_verify_scan`); the products and norms run
    over all S x T rows.  So logits row t is the logits of the decode
    step after window tokens ``0..t``.

    Returns (logits (S, T, V), cache, snaps).  The cache holds the
    window's K / V (past the accepted prefix they are dead: later reads
    mask them and later writes overwrite them); the state rows are left
    as they were.  ``snaps`` is one dict a layer, each recurrent leaf
    (T, S, ...) the state after each window token: the engine commits one
    a lane with :func:`select_state_snapshot` and
    :func:`scatter_state_rows`.
    """
    _check_decoder(cfg)
    idx = slot_ids.long()
    snaps = []
    with split_lanes(tokens.shape[0]) as lanes:
        x = _embed(params["embed"]["table"], tokens)[lanes]    # (S, T, D)
        for i, (lp, entry) in enumerate(zip(params["layers"],
                                            cache["layers"])):
            cst = dict(entry, page_tables=page_tables)
            x, new, _ = _serve_layer(
                lp, _spec(cfg, i), x, cfg,
                lambda h, cst=cst, lp=lp: attention.attn_verify_paged(
                    lp["mixer"], h, cfg, cst, lengths)[0],
                _get_rows(entry, idx[lanes]), mode="verify")
            snaps.append(_gather_rows(new, dim=1))
        return gather_lanes(_logits(params, x, cfg)), cache, snaps


def select_state_snapshot(snaps: list[dict], m: torch.Tensor) -> list[dict]:
    """Lane s's state after window tokens ``0..m[s]``: from
    :func:`paged_verify_step`'s ``snaps`` (leaves (T, S, ...)) and ``m``
    (S,) in ``[0, T - 1]``, rows shaped for :func:`scatter_state_rows`
    (leaves (S, ...))."""
    m = m.long()
    return [tree_map(lambda a: a[m, torch.arange(a.shape[1],
                                                 device=a.device)], e)
            for e in snaps]


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
    if not supports_paged_prefill(cfg):
        raise ValueError(f"{cfg.name}: a {cfg.frontend} arch's inputs are "
                         "not token prompts; it has no paged prefill")
    G, L = tokens.shape
    if L % chunk:
        raise ValueError(f"prompt bucket {L} is not a multiple of the "
                         f"chunk {chunk}")
    table = params["embed"]["table"]
    specs = [_spec(cfg, i) for i in range(len(params["layers"]))]
    with split_lanes(G) as lanes:
        plens = prompt_lens[lanes]
        Gl = plens.shape[0]
        # prompt state starts from zero, never from a slot's previous rows
        carry = [_carry_entry(cfg, spec, Gl, table.device) for spec in specs]
        if any(carry) and slot_ids is None:
            raise ValueError("recurrent layers need slot_ids to place their "
                             "state rows")
        h_last = torch.zeros((Gl, cfg.d_model), dtype=table.dtype,
                             device=table.device)
        pos = torch.arange(chunk, device=table.device)
        for c in range(L // chunk):
            start = c * chunk
            x = _embed(table, tokens[:, start:start + chunk])[lanes]
            valid = (start + pos)[None, :] < plens[:, None]     # (G, C)
            for i, (lp, entry) in enumerate(zip(params["layers"],
                                                cache["layers"])):
                cst = dict(entry, page_tables=page_tables)
                x, carry[i], _ = _serve_layer(
                    lp, specs[i], x, cfg,
                    lambda h, cst=cst, lp=lp, s=start:
                    attention.attn_prefill_paged(lp["mixer"], h, cfg, cst,
                                                 s)[0], carry[i],
                    valid=valid)
            # keep the hidden state of each request's last real token
            last = plens.long() - 1 - start
            rows = torch.gather(x, 1, last.clamp(0, chunk - 1)[:, None, None]
                                .expand(Gl, 1, cfg.d_model))[:, 0]
            hit = ((last >= 0) & (last < chunk))[:, None]
            h_last = torch.where(hit, rows, h_last)
        if any(carry):
            scatter_state_rows(cache, [_gather_rows(e) for e in carry],
                               slot_ids)
        return gather_lanes(_logits(params, h_last[:, None, :], cfg)[:, 0]), \
            cache


def batch_specs(cfg: ModelConfig, kind: str) -> dict:
    """Logical axes of each field of a batch (``make_dummy_batch``'s
    structure): the front end's inputs (or the tokens), and for
    ``kind="train"`` the targets and the loss mask."""
    if cfg.frontend == "vision_stub":
        d = {"patch_embeds": ("batch", None, None), "tokens": ("batch", None)}
    elif cfg.frontend == "audio_stub":
        d = {"frames": ("batch", None, None)}
    else:
        d = {"tokens": ("batch", None)}
    if kind == "train":
        d["targets"] = ("batch", None)
        d["loss_mask"] = ("batch", None)
    return d


def make_dummy_batch(cfg: ModelConfig, batch: int, seq: int, kind: str,
                     img_tokens: int = 0,
                     device: str | torch.device | None = None) -> dict:
    """A zero batch of ``seq`` positions in :func:`batch_specs`'
    structure: a vision stub's ``img_tokens`` (default ``max(seq // 4,
    1)``) bf16 patch embeddings and the rest text tokens, an audio stub's
    ``seq`` bf16 frames, otherwise ``seq`` tokens; ``kind="train"`` adds
    zero targets and a loss mask of ones."""
    dev = resolve_device(device)
    out = {}
    if cfg.frontend == "vision_stub":
        img = img_tokens or max(seq // 4, 1)
        out["patch_embeds"] = torch.zeros((batch, img, 1024),
                                          dtype=torch.bfloat16, device=dev)
        out["tokens"] = torch.zeros((batch, seq - img), dtype=torch.int32,
                                    device=dev)
    elif cfg.frontend == "audio_stub":
        out["frames"] = torch.zeros((batch, seq, 512), dtype=torch.bfloat16,
                                    device=dev)
    else:
        out["tokens"] = torch.zeros((batch, seq), dtype=torch.int32,
                                    device=dev)
    if kind == "train":
        out["targets"] = torch.zeros((batch, seq), dtype=torch.int32,
                                     device=dev)
        out["loss_mask"] = torch.ones((batch, seq), device=dev)
    return out

"""Mixture-of-Experts with GShard-style grouped dispatch, SC-quantized.

Port of ``repro.models.moe``.  Tokens are split into groups of
``sg = min(moe_group_size, B * S)``; each expert takes at most ``cap =
max(4, ceil4(ceil(k * sg * cf / E)))`` tokens of a group, in token-major
order of the (token, slot) pairs routed to it, and a token past its
expert's capacity drops to the residual path.  The router runs in
float32 (softmax, top-k, renormalised weights); the experts' FFN goes
through :func:`_expert_matmul` under the same SC quantization as the
dense layers; the output is the router-weighted sum of each token's
expert outputs.  The aux loss is the Switch load-balance loss plus
``1e-3 x`` the router z-loss.

Where the reference contracts dense one-hot tensors (``gsec,gsd->egcd``
and ``gsec,egcd->gsd``), the port moves rows by index: dispatch copies a
token's row into its (expert, group, slot) row, which is what the
one-hot product gives exactly, and the combine gathers each token's k
expert rows back.

Ties and batch invariance.  ``jax.lax.top_k`` takes the lower expert
index first on equal probabilities; ``torch.topk`` promises no order on
the card, so the port sorts descending with a stable sort and keeps the
first k.  The serving engine needs a token's output to ignore the other
tokens of the call (see ``common``): with ``batch_invariant`` the router
product and softmax run in float64 (rounded once to float32), the expert
products are exact integers (``sc_int``) or float64 (``sc_qat``, off),
and each token's k weighted terms are summed one after another, in slot
order, in float64.  Tokens do share capacity: at ``cf >= E / k`` no
token can drop and a token's output is its own (the serving convention,
``tests/test_paged_kv.py``); below it drops depend on the group's other
tokens, as in the reference.

Under a serving mesh (:func:`moe_spec`) experts are whole on one rank:
a rank runs the experts of its "model" block (one batched
``ternary_matmul`` launch over them under ``sc_int``), on every token of
the step (the lanes of all data ranks are gathered first, so the groups
and capacities are those of the unsharded call), and ``d_ff`` is split
over "data" with the hidden layer gathered before ``w_down``, so no
expert's sum is ever split.  The expert outputs are gathered over
"model" and combined in the unsharded order; routing is replicated.

Under a training mesh (:func:`moe_spec` ``serving=False``: experts over
"model", ``d_model`` over "data", gathered at use) the layer is
expert-parallel over its data block: each rank routes the tokens of its
block of the batch (replicated over "model"), in the groups the
unsharded call forms (a group may not straddle two data ranks' blocks),
with the unsharded call's capacity; it runs its own experts on their
rows and weights their outputs, and the ranks' partial combines add over
"model" (``psum``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.quant import ternary_weight_quant, thermometer_act_quant
from ..core.sc_layers import SCQuantConfig
from ..distributed.sharding import (DATA, MODEL, axis_index, axis_size,
                                    batch_axes, block, cols, fsdp_active,
                                    gather, gather_lanes,
                                    is_sharded, lane_slice, psum, sum_grads)
from ..kernels.ops import ternary_matmul
from .common import ACT_FNS, fsdp_gather, matmul_rows, whole_numel

__all__ = ["moe_init", "moe_apply", "moe_spec", "route"]

# experts are quantized and multiplied in chunks whose float64 weight copy
# stays below this many bytes (experts are independent: chunking changes
# no bit, and keeps a full-width layer's temporaries to about a GiB)
CHUNK_BYTES = 1 << 30


def _expert_dense_init(e: int, d_in: int, d_out: int, quant: SCQuantConfig,
                       *, generator: torch.Generator, device: torch.device,
                       dtype: torch.dtype) -> dict:
    std = 1.0 / math.sqrt(d_in)
    w = torch.randn((e, d_in, d_out), generator=generator, device=device,
                    dtype=torch.float32) * std
    p = {"w": w.to(dtype)}
    if quant.enabled:
        shape = (e, 1, d_out) if quant.per_channel else (e,)
        p["alpha_w"] = torch.full(shape, 1.4 * std * 0.8,
                                  dtype=torch.float32, device=device)
        p["alpha_a"] = torch.tensor(
            2.0 / math.sqrt(max(quant.act_half, 1)), dtype=torch.float32,
            device=device)
    return p


def moe_init(cfg: ModelConfig, *, generator: torch.Generator,
             device: torch.device) -> dict:
    """``router`` (D, E) float32 ~ N(0, 0.02^2) and the experts' ``w_up``,
    ``w_down`` (and ``w_gate``), ``w`` (E, d_in, d_out), in the
    reference's shapes and initialisation."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    kw = dict(generator=generator, device=device,
              dtype=getattr(torch, cfg.dtype))
    p = {"router": torch.randn((d, e), generator=generator, device=device,
                               dtype=torch.float32) * 0.02,
         "w_up": _expert_dense_init(e, d, f, cfg.quant, **kw),
         "w_down": _expert_dense_init(e, f, d, cfg.quant, **kw)}
    if cfg.ffn_gated:
        p["w_gate"] = _expert_dense_init(e, d, f, cfg.quant, **kw)
    return p


def _expert_dense_spec(quant: SCQuantConfig, spec: tuple) -> dict:
    s = {"w": spec}
    if quant.enabled:
        s["alpha_w"] = (spec[0], None, spec[2]) if quant.per_channel \
            else (spec[0],)
        s["alpha_a"] = ()
    return s


def moe_spec(cfg: ModelConfig, serving: bool = True) -> dict:
    """The serving layout (default): experts over "model", each expert's
    output channels over "data" (``w_gate`` / ``w_up``: ``d_ff``;
    ``w_down``: ``d_model``), the router whole.  The reference's
    ``moe_spec(serving=True)`` puts ``w_down``'s ``d_ff`` (its
    contraction) over "data" and all-reduces partial sums; the port
    gathers the hidden layer instead, by the reference's own rule that no
    contraction is split.  The training layout is the reference's:
    experts over "model" and ``d_model`` over "data", the contraction of
    ``w_gate`` / ``w_up`` and the output of ``w_down`` (ZeRO over
    ``d_model``, gathered at use)."""
    if serving:
        up = down = (MODEL, None, DATA)
    else:
        up, down = (MODEL, DATA, None), (MODEL, None, DATA)
    s = {"router": (None, None),
         "w_up": _expert_dense_spec(cfg.quant, up),
         "w_down": _expert_dense_spec(cfg.quant, down)}
    if cfg.ffn_gated:
        s["w_gate"] = _expert_dense_spec(cfg.quant, up)
    return s


def _chunks(w: torch.Tensor) -> list[slice]:
    """Slices of the expert axis, each under ``CHUNK_BYTES`` in float64."""
    per = max(1, w[0].numel() * 8)
    n = max(1, CHUNK_BYTES // per)
    return [slice(e, e + n) for e in range(0, w.shape[0], n)]


def _expert_matmul(p: dict, x: torch.Tensor, quant: SCQuantConfig, *,
                   batch_invariant: bool = True) -> torch.Tensor:
    """``x (E, T, d_in)`` @ each expert's ``w (E, d_in, d_out)`` under the
    dense layers' SC discipline (``common.dense_apply``):

    * ``sc_int`` (and ``sc_int_approx``, whose experts keep the exact
      accumulator, as the reference's): int8 levels ``round(x / alpha_a)``
      in ``x.dtype`` x ternary ``round(w / alpha_w)`` in float32 -> int32
      sums, one ``ternary_matmul`` launch for all E products, rescaled by
      ``alpha_a * alpha_w`` in float32 and rounded to ``x.dtype``;
    * ``sc_qat``: fake-quantized x and w, then a float product;
    * off: the float product.

    Float products are float64 rounded once (``matmul_rows``) when
    ``batch_invariant``, else ``torch.matmul`` in ``x.dtype`` (training).
    """
    w = p["w"]
    if fsdp_active():
        return _expert_matmul_mesh(p, x, quant, batch_invariant)
    if quant.enabled and quant.mode == "sc_int":
        half = quant.act_half
        aa = p["alpha_a"].to(x.dtype)
        aw = p["alpha_w"].to(torch.float32)
        aw_b = aw if aw.ndim > 1 else aw[:, None, None]
        x_q = torch.clamp(torch.round(x / aa), -half, half).to(torch.int8)
        w_int = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        for sl in _chunks(w):
            w_int[sl] = torch.clamp(torch.round(w[sl].to(torch.float32)
                                                / aw_b[sl]), -1, 1)
        sum_q = ternary_matmul(x_q, w_int)                # (E, T, d_out)
        scale = aa.to(torch.float32) * aw        # (E, 1, d_out) or (E,)
        if scale.ndim == 1:
            scale = scale[:, None, None]
        return (sum_q.to(torch.float32) * scale).to(x.dtype)
    qat = quant.enabled and quant.mode == "sc_qat"
    if qat:
        x = thermometer_act_quant(x, p["alpha_a"], quant.act_bsl)
    if not batch_invariant:
        if qat:
            w = ternary_weight_quant(w, p["alpha_w"])
        return torch.matmul(x, w.to(x.dtype))
    out = torch.empty((*x.shape[:-1], w.shape[-1]), dtype=x.dtype,
                      device=x.device)
    for sl in _chunks(w):
        wc = ternary_weight_quant(w[sl], p["alpha_w"][sl]) if qat else w[sl]
        out[sl] = matmul_rows(x[sl], wc.to(x.dtype))
    return out


def _expert_matmul_mesh(p: dict, x: torch.Tensor, quant: SCQuantConfig,
                        batch_invariant: bool) -> torch.Tensor:
    """:func:`_expert_matmul` under a training mesh: this rank's experts
    (``x`` their rows of its block of the batch) with ``d_model``
    gathered over "data"; the replicated ``alpha_a``'s gradient summed
    over "model", the LSQ scales sized by the whole tensors."""
    if quant.enabled and quant.mode == "sc_int":
        raise NotImplementedError("the training mesh runs quantization "
                                  "off or sc_qat, not the integer "
                                  "datapath")
    cut = is_sharded(p["w"], 0)
    w = fsdp_gather(p["w"])
    if quant.enabled and quant.mode == "sc_qat":
        x = thermometer_act_quant(x, sum_grads(p["alpha_a"]), quant.act_bsl,
                                  numel=whole_numel(x, cut, True))
        w = ternary_weight_quant(w, fsdp_gather(p["alpha_w"]),
                                 numel=whole_numel(w, cut))
    if batch_invariant:
        return matmul_rows(x, w.to(x.dtype))
    return torch.matmul(x, w.to(x.dtype))


def route(router: torch.Tensor, xt: torch.Tensor, k: int, *,
          batch_invariant: bool = True):
    """Router logits (float32), softmax probabilities, and each token's top
    k (weights renormalised to sum 1, expert ids), ties to the lower id.
    xt: (G, sg, D) -> logits, probs (G, sg, E); top_w, top_i (G, sg, k)."""
    if batch_invariant:
        logits64 = torch.matmul(xt.to(torch.float64),
                                router.to(torch.float64))
        logits = logits64.to(torch.float32)
        probs = torch.softmax(logits.to(torch.float64), dim=-1) \
            .to(torch.float32)
    else:
        logits = torch.matmul(xt.to(torch.float32), router)
        probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = srt.values[..., :k], srt.indices[..., :k]
    total = top_w[..., 0]
    for j in range(1, k):                 # in slot order, on every device
        total = total + top_w[..., j]
    top_w = top_w / torch.clamp(total, min=1e-9)[..., None]
    return logits, probs, top_w, top_i


class _Routed(NamedTuple):
    """A call's routing and this rank's expert rows (:func:`_dispatch`)."""
    logits: torch.Tensor        # (G, sg, E) float32
    probs: torch.Tensor
    onehot: torch.Tensor        # (G, sg, k, E)
    top_w: torch.Tensor         # (G, sg, k)
    keep: torch.Tensor          # kept (token, slot) pairs
    dest: torch.Tensor          # each pair's row of every expert's slots
    ours: torch.Tensor          # kept pairs routed to this rank's experts
    dest_l: torch.Tensor        # their rows of this rank's slots
    ein: torch.Tensor           # (El, G * cap, D) this rank's experts' rows


def _dispatch(p: dict, xt: torch.Tensor, cfg: ModelConfig, cap: int,
              batch_invariant: bool, rows_from=None) -> _Routed:
    """Route the tokens ``xt`` (G, sg, D) and copy each kept (token, slot)
    pair's row (of ``rows_from``, default ``xt``) into its (expert, group,
    slot) row of this rank's experts (all of them without a mesh);
    dropped pairs go to one spare row past the end, which is cut off."""
    G, sg, D = xt.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    logits, probs, top_w, top_i = route(p["router"], xt, k,
                                        batch_invariant=batch_invariant)
    # position of each (token, slot) in its expert's queue, token-major
    onehot = F.one_hot(top_i, E)                                # (G,sg,k,E)
    queue = torch.cumsum(onehot.reshape(G, sg * k, E), dim=1) - 1
    pos = torch.gather(queue, 2, top_i.reshape(G, sg * k, 1)) \
        .reshape(G, sg, k)
    keep = (pos < cap) & (top_w > 0)
    g_idx = torch.arange(G, device=xt.device)[:, None, None]
    dest = torch.where(keep, (top_i * G + g_idx) * cap + pos,
                       E * G * cap).reshape(-1)
    mine = block(E) if is_sharded(p["w_up"]["w"], 0) else slice(0, E)
    e0 = mine.start or 0
    El = (mine.stop or E) - e0
    ours = keep & (top_i >= e0) & (top_i < e0 + El)
    dest_l = torch.where(ours, ((top_i - e0) * G + g_idx) * cap + pos,
                         El * G * cap).reshape(-1)
    src = (xt if rows_from is None else rows_from)[:, :, None, :] \
        .expand(G, sg, k, D).reshape(-1, D)
    rows = xt.new_zeros((El * G * cap + 1, D)).index_put((dest_l,), src)
    return _Routed(logits, probs, onehot, top_w, keep, dest, ours, dest_l,
                   rows[:-1].reshape(El, G * cap, D))


def _ffn(p: dict, ein: torch.Tensor, cfg: ModelConfig, batch_invariant: bool,
         hidden=lambda h: h) -> torch.Tensor:
    """The experts' FFN on their rows, ``hidden`` applied to the hidden
    layer before ``w_down``."""
    act = ACT_FNS[cfg.ffn_act]
    kw = dict(batch_invariant=batch_invariant)
    if cfg.ffn_gated:
        h = act(_expert_matmul(p["w_gate"], ein, cfg.quant, **kw)) \
            * _expert_matmul(p["w_up"], ein, cfg.quant, **kw)
    else:
        h = act(_expert_matmul(p["w_up"], ein, cfg.quant, **kw))
    return _expert_matmul(p["w_down"], hidden(h), cfg.quant, **kw)


def _combine(eout: torch.Tensor, dest: torch.Tensor, wts: torch.Tensor,
             acc_dt: torch.dtype) -> torch.Tensor:
    """Each token's k expert rows (``dest`` into ``eout``'s rows, the spare
    row past the end a zero), weighted by ``wts`` (G, sg, k) and summed in
    slot order in ``acc_dt``: (G, sg, D)."""
    G, sg, k = wts.shape
    D = eout.shape[-1]
    eflat = torch.cat([eout.reshape(-1, D), eout.new_zeros((1, D))])
    picked = eflat[dest].reshape(G, sg, k, D)
    y = wts[..., 0, None].to(acc_dt) * picked[:, :, 0].to(acc_dt)
    for j in range(1, k):
        y = y + wts[..., j, None].to(acc_dt) * picked[:, :, j].to(acc_dt)
    return y


def _aux(r: _Routed, E: int) -> torch.Tensor:
    """Switch-style load-balance loss + 1e-3 x the router z-loss."""
    density = r.onehot.sum(2).to(torch.float32).mean(1)        # (G, E)
    aux = E * torch.mean(torch.sum(density * r.probs.mean(1), dim=-1))
    return aux + 1e-3 * torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              batch_invariant: bool = True):
    """x: (B, S, D) -> (y (B, S, D), aux loss); see the module docstring.
    The serving engine calls it on (S, 1, D) decode lanes and (G, C, D)
    prefill chunks (a data rank's block of the lanes under a mesh);
    training passes ``batch_invariant=False``."""
    if fsdp_active():
        return _moe_mesh(p, x, cfg, batch_invariant)
    x = gather_lanes(x)
    B, S, D = x.shape
    G, sg, cap = _groups(cfg, B * S, B * S)
    r = _dispatch(p, x.reshape(G, sg, D), cfg, cap, batch_invariant)
    w_up = p["w_up"]["w"]
    # d_ff whole before w_down (the contraction), then every expert's rows
    eout = _ffn(p, r.ein, cfg, batch_invariant,
                hidden=lambda h: cols(h, w_up, False, DATA))
    eout = cols(eout, p["w_down"]["w"], False, DATA)
    eout = cols(eout, w_up, False, MODEL, w_dim=0, y_dim=0)
    # the weights rounded to x.dtype, as the reference's combine tensor
    y = _combine(eout, r.dest, torch.where(r.keep, r.top_w, 0.0)
                 .to(x.dtype), torch.float64 if batch_invariant
                 else torch.float32)
    return (y.to(x.dtype).reshape(B, S, D)[lane_slice()],
            _aux(r, cfg.n_experts))


def _groups(cfg: ModelConfig, T: int, whole: int) -> tuple[int, int, int]:
    """(groups, group size, capacity) of ``T`` tokens, the group size and
    capacity those of a call on ``whole`` tokens."""
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    sg = min(cfg.moe_group_size, whole)
    if T % sg:
        raise ValueError(f"{T} tokens do not split into groups of {sg}")
    cap = int(-(-k * sg * cfg.moe_capacity_factor // E))
    return T // sg, sg, max(4, -(-cap // 4) * 4)   # a multiple of 4


def _moe_mesh(p: dict, x: torch.Tensor, cfg: ModelConfig,
              batch_invariant: bool):
    """:func:`moe_apply` under a training mesh (see the module docstring):
    x (B, S, D) is this rank's block of the batch."""
    axes = batch_axes()
    own = x.shape[0]
    # a group of the unsharded call that straddles data ranks' blocks (a
    # decode step's few tokens): every rank routes all the tokens, as the
    # serving engine does, and keeps its rows of the output
    straddle = (x.shape[0] * x.shape[1]) % min(
        cfg.moe_group_size, x.shape[0] * x.shape[1] * axis_size(axes))
    if straddle:
        x = gather(x, axes, 0)
    B, S, D = x.shape
    G, sg, cap = _groups(cfg, B * S, B * S * (1 if straddle
                                              else axis_size(axes)))
    xt = x.reshape(G, sg, D)
    # the rows of this rank's experts collect their gradient from every
    # rank of "model"
    r = _dispatch(p, xt, cfg, cap, batch_invariant, rows_from=sum_grads(xt))
    eout = _ffn(p, r.ein, cfg, batch_invariant)
    # this rank's share of the weights' gradient, summed over "model"
    wts = torch.where(r.ours, sum_grads(r.top_w), 0.0).to(x.dtype)
    y = _combine(eout, r.dest_l, wts, torch.float64 if batch_invariant
                 else torch.float32)
    y = psum(y).to(x.dtype).reshape(B, S, D)
    if straddle:
        y = y.narrow(0, axis_index(axes) * own, own)
    return y, _aux(r, cfg.n_experts)

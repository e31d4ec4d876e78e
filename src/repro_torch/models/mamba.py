"""Mamba (S6) selective-state-space mixer: Jamba's dominant layer type.

Port of ``repro.models.mamba``.  Training runs ``mamba_train``: the
causal conv over the whole sequence (``_conv_full``), then the
recurrence as a chunked associative scan: within a chunk of
``cfg.mamba_chunk`` tokens the pairs ``(exp(dt A), dt x B)`` combine by
``_assoc_combine`` in the recursive odd / even order of
``jax.lax.associative_scan`` (:func:`_assoc_scan`), so the products
happen in the reference's order, in log-depth launches; the chunks are
threaded by a loop carrying the boundary state ``h``.

Serving runs ``mamba_prefill_chunk``
runs a chunk of the prompt through the per-token recurrence
``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``, ``y_t = C_t . h_t``,
consuming and emitting the decode state (the SSM state ``h`` and the
conv tail, the last ``k - 1`` pre-conv inputs); ``mamba_decode`` takes
one token.  The recurrence is kept token by token, as in the reference,
so that every split of a prompt into chunks gives the same bits; a
``valid`` mask freezes right-padded lanes by an exact select.  The four
projections go through ``dense_apply`` (SC-quantized); the scan itself
stays float32.

Batch invariance.  Everything in the recurrence is elementwise except
the readout ``C_t . h_t`` (a sum over the ``d_state`` axis), which runs
as :func:`~.common.sum_fixed`: elementwise adds in one fixed order, so a
lane's output never depends on the other lanes of the call.  The
training forms take plain products (``batch_invariant=False``), as the
rest of the training forward.

Under a serving mesh (:func:`mamba_spec`) the state rows, the conv taps
and the per-channel leaves shard over ``d_inner`` ("model"), when it
splits: a rank runs the conv and the recurrence on its block of channels
and gathers the channels before each contraction over them (``x_proj``,
``out_proj``).  Every projection is column-parallel, so ``dt_proj``
gives a rank its own channels directly.

Under the training layout (``mamba_spec(serving=False)``, the
reference's) ``x_proj`` and ``out_proj`` contract a rank's channels
(row-parallel, the partial sums added over "model").  ``in_proj``'s
columns are cut over "model" in one run of ``2 d_inner``, so a rank's x
and z channels sit on two other ranks' blocks: it computes just their
columns from the weight gathered whole (``dense_apply(take=)``), whose
gradient comes back summed into the blocks.  The layer's input feeds
only products of a rank's own columns and the summed ``x_proj`` output
(dt's rank, B and C) only a rank's channels, so both gradients are
summed over "model" (``sum_grads``); the per-channel leaves are the
rank's own.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.sharding import (DATA, MODEL, axis_size, block, gather,
                                    is_sharded, splits, sum_grads)
from .common import ACT_FNS, dense_apply, dense_init, dense_spec, sum_fixed

__all__ = ["mamba_init", "mamba_spec", "mamba_train", "mamba_prefill_chunk",
           "mamba_decode", "mamba_state_init", "mamba_state_spec"]

_silu = ACT_FNS["silu"]


def mamba_init(cfg: ModelConfig, *, generator: torch.Generator,
               device: torch.device) -> dict:
    """Parameters in the reference's shapes and initialisation: the S4D-
    real ``a_log`` (``log(1..d_state)`` on every channel), ``dt_bias`` the
    inverse softplus of ``U(0, 0.1)`` clipped at 1e-3, conv weights
    ``N(0, 0.01)``, ``d_skip`` ones."""
    d, din, n, r = (cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state,
                    cfg.dt_rank)
    dt = getattr(torch, cfg.dtype)
    kw = dict(generator=generator, device=device)
    q = cfg.quant
    a = torch.arange(1, n + 1, dtype=torch.float32,
                     device=device)[None, :].expand(din, n)
    u = torch.rand((din,), **kw) * 0.1
    return {
        "in_proj": dense_init(d, 2 * din, q, dtype=dt, **kw),
        "conv_w": (torch.randn((din, cfg.mamba_d_conv), **kw) * 0.1).to(dt),
        "conv_b": torch.zeros((din,), device=device),
        "x_proj": dense_init(din, r + 2 * n, q, dtype=dt, **kw),
        "dt_proj": dense_init(r, din, q, dtype=dt, **kw),
        "dt_bias": torch.log(torch.expm1(torch.clamp(u, min=1e-3))),
        "a_log": torch.log(a).contiguous(),
        "d_skip": torch.ones((din,), device=device),
        "out_proj": dense_init(din, d, q, dtype=dt, **kw),
    }


def mamba_spec(cfg: ModelConfig, serving: bool = True) -> dict:
    """The serving layout (default): the projections column-parallel, the
    per-channel leaves over ``d_inner`` ("model").  The reference's
    ``mamba_spec`` splits ``x_proj``'s and ``out_proj``'s contraction
    over "model"; the port serves every contraction whole.  The training
    layout (``serving=False``) is the reference's."""
    q = cfg.quant
    if not serving:
        return {"in_proj": dense_spec(DATA, MODEL, q),
                "conv_w": (MODEL, None), "conv_b": (MODEL,),
                "x_proj": dense_spec(MODEL, None, q),
                "dt_proj": dense_spec(None, MODEL, q),
                "dt_bias": (MODEL,), "a_log": (MODEL, None),
                "d_skip": (MODEL,), "out_proj": dense_spec(MODEL, DATA, q)}
    return {"in_proj": dense_spec(None, MODEL, q),
            "conv_w": (MODEL, None), "conv_b": (MODEL,),
            "x_proj": dense_spec(None, MODEL, q),
            "dt_proj": dense_spec(None, MODEL, q),
            "dt_bias": (MODEL,), "a_log": (MODEL, None), "d_skip": (MODEL,),
            "out_proj": dense_spec(None, MODEL, q)}


def mamba_state_spec() -> dict:
    """Logical axes of the state rows: ``h`` (rows, d_inner, n) and the
    conv tail (rows, k-1, d_inner) over their channels."""
    return {"h": (None, "model", None), "conv": (None, None, "model")}


def mamba_state_init(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device: torch.device | None = None) -> dict:
    """Zero decode state: ``h`` (batch, d_inner, d_state) float32 and the
    conv tail ``conv`` (batch, d_conv - 1, d_inner) in ``dtype``."""
    din, n, k = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {"h": torch.zeros((batch, din, n), device=device),
            "conv": torch.zeros((batch, k - 1, din), dtype=dtype,
                                device=device)}


def _channels(cfg: ModelConfig) -> slice:
    """This rank's block of ``d_inner`` (all of it without a mesh)."""
    return block(cfg.mamba_d_inner)


def _whole(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Every channel of a (..., d_inner) activation, from a rank's block."""
    return gather(x, MODEL, -1) if splits(cfg.mamba_d_inner) else x


def _row_parallel(p: dict) -> bool:
    """The training layout under a mesh: ``x_proj`` and ``out_proj``
    contract a rank's block of the channels."""
    return is_sharded(p["x_proj"]["w"], 0)


def _split_xz(p: dict, u: torch.Tensor, cfg: ModelConfig,
              batch_invariant: bool = True):
    """The pre-conv x and the gate z, this rank's channels of each."""
    din = cfg.mamba_d_inner
    ch = _channels(cfg)
    if _row_parallel(p):
        n = din // axis_size()
        xz = dense_apply(p["in_proj"], sum_grads(u), cfg.quant,
                         batch_invariant=batch_invariant,
                         take=((ch.start, n), (din + ch.start, n)))
        return xz[..., :n], xz[..., n:]
    xz = dense_apply(p["in_proj"], u, cfg.quant,
                     batch_invariant=batch_invariant)
    return xz[..., :din][..., ch], xz[..., din:][..., ch]


def _out_proj(p: dict, y: torch.Tensor, cfg: ModelConfig,
              batch_invariant: bool = True) -> torch.Tensor:
    """``out_proj`` of a rank's channels of y: their partial products
    summed (row-parallel), or the product of every channel gathered."""
    return dense_apply(p["out_proj"], y if _row_parallel(p)
                       else _whole(y, cfg), cfg.quant,
                       batch_invariant=batch_invariant)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_params(p: dict, x: torch.Tensor, cfg: ModelConfig,
                batch_invariant: bool = True):
    """x: (..., din) -> dt (..., din), B (..., N), C (..., N), float32
    (x and dt: this rank's channels under a mesh)."""
    n, r = cfg.mamba_d_state, cfg.dt_rank
    kw = dict(batch_invariant=batch_invariant)
    if _row_parallel(p):
        # the summed output feeds only this rank's channels of dt, B and C
        dbc = sum_grads(dense_apply(p["x_proj"], x, cfg.quant, **kw))
    else:
        dbc = dense_apply(p["x_proj"], _whole(x, cfg), cfg.quant, **kw)
    dt_r, bm, cm = dbc[..., :r], dbc[..., r:r + n], dbc[..., r + n:]
    dt = _softplus(dense_apply(p["dt_proj"], dt_r, cfg.quant,
                               local=splits(cfg.mamba_d_inner), **kw)
                   .to(torch.float32) + p["dt_bias"])
    return dt, bm.to(torch.float32), cm.to(torch.float32)


def _conv_full(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Causal depthwise conv over the whole (B, S, din) sequence as k
    weighted shifts (zeros before the first token), the taps summed
    newest first and the bias last.  Returns (B, S, din) in ``x.dtype``."""
    k = cfg.mamba_d_conv
    w = p["conv_w"].to(torch.float32)
    xf = x.to(torch.float32)
    S = xf.shape[1]
    out = xf * w[:, k - 1]
    for i in range(1, k):
        # pad then crop keeps the shape when S < i
        shifted = torch.nn.functional.pad(xf, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[:, k - 1 - i]
    return (out + p["conv_b"]).to(x.dtype)


def _conv_window(p: dict, xcat: torch.Tensor, cfg: ModelConfig):
    """Causal depthwise conv over a chunk with its left context.

    xcat: (B, (k-1) + C, din), the carried conv tail before the chunk's
    pre-conv inputs.  Returns (B, C, din) in ``xcat.dtype``, summing the
    taps in :func:`_conv_full`'s order, so that a zero tail gives its
    output bit for bit."""
    k = cfg.mamba_d_conv
    w = p["conv_w"].to(torch.float32)
    xf = xcat.to(torch.float32)
    C = xf.shape[1] - (k - 1)
    out = xf[:, k - 1:] * w[:, k - 1]
    for i in range(1, k):
        out = out + xf[:, k - 1 - i:k - 1 - i + C] * w[:, k - 1 - i]
    return (out + p["conv_b"]).to(xcat.dtype)


def _assoc_combine(left, right):
    """The scan's operator on (decay, input) pairs: applying ``left`` then
    ``right`` to a state is ``(a1 a2, b1 a2 + b2)``."""
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, b1 * a2 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int):
    """``even[0], odd[0], even[1], ...`` along ``dim``; ``even`` may be one
    longer."""
    n = odd.shape[dim]
    pairs = torch.stack([even.narrow(dim, 0, n), odd], dim=dim + 1)
    out = pairs.flatten(dim, dim + 1)
    if even.shape[dim] > n:
        out = torch.cat([out, even.narrow(dim, n, 1)], dim=dim)
    return out


def _assoc_scan(elems: tuple, dim: int) -> tuple:
    """Inclusive scan of ``elems`` (a tuple of tensors) by
    :func:`_assoc_combine` along ``dim``, in ``jax.lax.associative_scan``'s
    recursion: combine adjacent pairs, scan those, then fill in the even
    positions from the scanned odd ones.  Every output is the same
    product tree as the reference's."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def every_other(t, start, stop=None):
        return t[(slice(None),) * dim + (slice(start, stop, 2),)]
    reduced = _assoc_combine(tuple(every_other(e, 0, n - 1) for e in elems),
                             tuple(every_other(e, 1) for e in elems))
    odd = _assoc_scan(reduced, dim)
    rest = tuple(every_other(e, 2) for e in elems)
    if n % 2 == 0:
        even = _assoc_combine(tuple(o.narrow(dim, 0, o.shape[dim] - 1)
                                    for o in odd), rest)
    else:
        even = _assoc_combine(odd, rest)
    even = tuple(torch.cat([e.narrow(dim, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _scan_chunk(xc, dtc, bc, cc, a, h0):
    """One chunk of the training scan: (y (B, c, din), the chunk's last
    state)."""
    da = torch.exp(dtc[..., None] * a)                        # (B,c,din,n)
    dbx = (dtc * xc)[..., None] * bc[:, :, None, :]           # (B,c,din,n)
    pa, hs = _assoc_scan((da, dbx), 1)
    hs = hs + pa * h0[:, None]                                # carry in
    return torch.einsum("bcdn,bcn->bcd", hs, cc), hs[:, -1]


def mamba_train(p: dict, u: torch.Tensor, cfg: ModelConfig):
    """The training forward.  u: (B, S, D) -> (out (B, S, D), (h_final
    (B, din, n) float32, conv_tail (B, k-1, din))), as the reference.

    The sequence runs in chunks of ``c``, the largest divisor of S not
    above ``cfg.mamba_chunk``; inside a chunk the associative scan gives
    every prefix state from zero, and ``h_t = pa_t h0 + hs_t`` adds the
    carried state.  Plain products (``batch_invariant=False``).  Under
    autograd each chunk runs under ``torch.utils.checkpoint``: at jamba's
    width a chunk's scan intermediates are ~0.7 GB, which every chunk of
    a 4096-token sequence would otherwise keep for the backward."""
    B, S, _ = u.shape
    c = min(cfg.mamba_chunk, S)
    while S % c:
        c -= 1
    x_raw, z = _split_xz(p, u, cfg, batch_invariant=False)
    x = _silu(_conv_full(p, x_raw, cfg))
    dt, bm, cm = _ssm_params(p, x, cfg, batch_invariant=False)
    a = -torch.exp(p["a_log"])                                # (din, n)
    xf = x.to(torch.float32)
    h = torch.zeros((B, xf.shape[-1], cfg.mamba_d_state), device=u.device)
    ys = []
    for xc, dtc, bc, cc in zip(*(torch.split(t, c, dim=1)
                                 for t in (xf, dt, bm, cm))):
        # under autograd a chunk keeps only its inputs and recomputes its
        # (B, c, din, n) scan in the backward
        args = (xc, dtc, bc, cc, a, h)
        yc, h = checkpoint(_scan_chunk, *args, use_reentrant=False) \
            if torch.is_grad_enabled() else _scan_chunk(*args)
        ys.append(yc)
    y = torch.cat(ys, dim=1) + xf * p["d_skip"]
    y = (y * _silu(z.to(torch.float32))).to(u.dtype)
    out = _out_proj(p, y, cfg, batch_invariant=False)
    # decode cache: the last k - 1 pre-conv inputs, left-padded with zeros
    # when the sequence is shorter
    kc = cfg.mamba_d_conv - 1
    tail = torch.nn.functional.pad(x_raw[:, max(S - kc, 0):],
                                   (0, 0, max(kc - S, 0), 0))
    return out, (h, tail)


def mamba_prefill_chunk(p: dict, u: torch.Tensor, cfg: ModelConfig,
                        state: dict, valid: torch.Tensor | None = None):
    """One chunk of the prompt through the per-token recurrence.

    u: (B, C, D); state: ``{"h": (B, din, n) f32, "conv": (B, k-1, din)}``
    (zeros at the start of a sequence); ``valid``: optional (B, C) bool,
    True on real prompt tokens.  A masked position leaves ``h`` as it was
    (an exact select), and the new conv tail is the ``k - 1`` pre-conv
    inputs ending at each lane's last valid token.  Returns (out (B, C,
    D), new state).

    The decay and the input term of every token are computed for the
    whole chunk at once (elementwise, so each token's bits are those of
    a one-token call); the loop carries only ``h``; the readout sums the
    stacked states with :func:`~.common.sum_fixed`.
    """
    B, C, _ = u.shape
    k = cfg.mamba_d_conv
    x_raw, z = _split_xz(p, u, cfg)
    xcat = torch.cat([state["conv"].to(x_raw.dtype), x_raw], dim=1)
    x = _silu(_conv_window(p, xcat, cfg))
    dt, bm, cm = _ssm_params(p, x, cfg)
    a = -torch.exp(p["a_log"])                                # (din, n)
    xf = x.to(torch.float32)
    da = torch.exp(dt[..., None] * a)                         # (B,C,din,n)
    dbx = (dt * xf)[..., None] * bm[:, :, None, :]            # (B,C,din,n)
    # without ``valid`` every step updates (the select of an all-true
    # mask, left out)
    vmask = None if valid is None else valid.to(torch.bool)
    h = state["h"]
    hs = []
    for t in range(C):
        hn = h * da[:, t] + dbx[:, t]
        h = hn if vmask is None else torch.where(vmask[:, t, None, None],
                                                 hn, h)
        hs.append(h)
    y = sum_fixed(torch.stack(hs, dim=1) * cm[:, :, None, :], -1)
    y = y + xf * p["d_skip"]
    y = (y * _silu(z.to(torch.float32))).to(u.dtype)
    out = _out_proj(p, y, cfg)
    nvalid = torch.full((B,), C, device=u.device) if vmask is None \
        else vmask.sum(dim=1)                                 # (B,)
    idx = nvalid[:, None] + torch.arange(k - 1, device=u.device)[None, :]
    tail = torch.gather(xcat, 1, idx[:, :, None].expand(B, k - 1,
                                                        xcat.shape[-1]))
    return out, {"h": h, "conv": tail.to(state["conv"].dtype)}


def mamba_decode(p: dict, u: torch.Tensor, cfg: ModelConfig, state: dict):
    """One token a lane.  u: (B, 1, D); state as
    :func:`mamba_prefill_chunk`'s.  The conv runs bias first and stays
    float32 into the recurrence, as the reference's decode."""
    k = cfg.mamba_d_conv
    x, z = _split_xz(p, u, cfg)                               # (B,1,din)
    w = p["conv_w"].to(torch.float32)
    conv = state["conv"].to(torch.float32)
    xc = x[:, 0].to(torch.float32) * w[:, k - 1] + p["conv_b"]
    for i in range(1, k):
        xc = xc + conv[:, k - 1 - i] * w[:, k - 1 - i]
    xc = _silu(xc)
    dt, bm, cm = _ssm_params(p, xc.to(u.dtype)[:, None, :], cfg)
    dt, bm, cm = dt[:, 0], bm[:, 0], cm[:, 0]
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt[..., None] * a)                         # (B,din,n)
    h = state["h"] * da + (dt * xc)[..., None] * bm[:, None, :]
    y = sum_fixed(h * cm[:, None, :], -1) + xc * p["d_skip"]
    y = (y * _silu(z[:, 0].to(torch.float32))).to(u.dtype)
    out = _out_proj(p, y[:, None, :], cfg)
    new_conv = torch.cat([state["conv"][:, 1:], x.to(state["conv"].dtype)],
                         dim=1)
    return out, {"h": h, "conv": new_conv}


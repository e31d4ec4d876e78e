"""Mamba (S6) selective-state-space mixer, for serving: Jamba's dominant
layer type.

Port of ``repro.models.mamba``'s serving half: ``mamba_prefill_chunk``
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
reference's training scan (``mamba_train``, a chunked associative scan)
is not ported yet (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .common import ACT_FNS, dense_apply, dense_init, sum_fixed

__all__ = ["mamba_init", "mamba_prefill_chunk", "mamba_decode",
           "mamba_state_init"]

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


def mamba_state_init(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device: torch.device | None = None) -> dict:
    """Zero decode state: ``h`` (batch, d_inner, d_state) float32 and the
    conv tail ``conv`` (batch, d_conv - 1, d_inner) in ``dtype``."""
    din, n, k = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {"h": torch.zeros((batch, din, n), device=device),
            "conv": torch.zeros((batch, k - 1, din), dtype=dtype,
                                device=device)}


def _split_xz(p: dict, u: torch.Tensor, cfg: ModelConfig):
    xz = dense_apply(p["in_proj"], u, cfg.quant)
    din = cfg.mamba_d_inner
    return xz[..., :din], xz[..., din:]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_params(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (..., din) -> dt (..., din), B (..., N), C (..., N), float32."""
    n, r = cfg.mamba_d_state, cfg.dt_rank
    dbc = dense_apply(p["x_proj"], x, cfg.quant)
    dt_r, bm, cm = dbc[..., :r], dbc[..., r:r + n], dbc[..., r + n:]
    dt = _softplus(dense_apply(p["dt_proj"], dt_r, cfg.quant)
                   .to(torch.float32) + p["dt_bias"])
    return dt, bm.to(torch.float32), cm.to(torch.float32)


def _conv_window(p: dict, xcat: torch.Tensor, cfg: ModelConfig):
    """Causal depthwise conv over a chunk with its left context.

    xcat: (B, (k-1) + C, din), the carried conv tail before the chunk's
    pre-conv inputs.  Returns (B, C, din) in ``xcat.dtype``, summing the
    taps in the reference's order (newest first, the bias last)."""
    k = cfg.mamba_d_conv
    w = p["conv_w"].to(torch.float32)
    xf = xcat.to(torch.float32)
    C = xf.shape[1] - (k - 1)
    out = xf[:, k - 1:] * w[:, k - 1]
    for i in range(1, k):
        out = out + xf[:, k - 1 - i:k - 1 - i + C] * w[:, k - 1 - i]
    return (out + p["conv_b"]).to(xcat.dtype)


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
    vmask = torch.ones((B, C), dtype=torch.bool, device=u.device) \
        if valid is None else valid.to(torch.bool)
    h = state["h"]
    hs = []
    for t in range(C):
        hn = h * da[:, t] + dbx[:, t]
        h = torch.where(vmask[:, t, None, None], hn, h)
        hs.append(h)
    y = sum_fixed(torch.stack(hs, dim=1) * cm[:, :, None, :], -1)
    y = y + xf * p["d_skip"]
    y = (y * _silu(z.to(torch.float32))).to(u.dtype)
    out = dense_apply(p["out_proj"], y, cfg.quant)
    nvalid = vmask.sum(dim=1)                                 # (B,)
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
    out = dense_apply(p["out_proj"], y[:, None, :], cfg.quant)
    new_conv = torch.cat([state["conv"][:, 1:], x.to(state["conv"].dtype)],
                         dim=1)
    return out, {"h": h, "conv": new_conv}


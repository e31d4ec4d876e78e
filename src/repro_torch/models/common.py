"""Shared building blocks: SC-aware dense, RMSNorm / LayerNorm, RoPE,
activations.

Port of ``repro.models.common``.  Every projection routes through
:func:`dense_apply`: a plain product with quantization off, the
fake-quant QAT product under ``sc_qat`` (with the LSQ gradient), and the
integer SC datapath under ``sc_int`` (``sc_linear_int_from_qat``).

Batch invariance.  The serving engine's batched decode must give each
request the tokens it gets alone (``sequential_generate``), so a row's
result may not depend on how many rows share a call.  The integer
datapaths are exact; the float row reductions here (the QAT/plain
product and the norms' statistics) accumulate in float64 and round once
to the working dtype.  That makes the result very likely, not certain,
to be independent of the batch: the library may still sum in another
order for another row count, and a float64 difference flips the rounding
of a value that sits on a rounding tie.  It costs bandwidth as well:
every call writes and re-reads a float64 copy of the weight.  Training
has no such contract, so the train forward passes
``batch_invariant=False`` and its products are the reference's plain
``x @ w`` in the working dtype (a bf16 ``torch.matmul`` on the card).

Mesh serving.  The serving layout shards every projection's output
channels over "model" (:func:`dense_spec` ``(None, MODEL)``), never a
contraction, so each output channel's sum, exact or through the
approximate BSN adder, stays whole on one rank.  :func:`dense_apply`
computes the rank's columns through the same products and then gathers
them (``distributed.sharding.cols``), or keeps them (``local=True``) for
a layer that runs its own heads or channels.

Training mesh.  Under a training mapping (``sharding.fsdp_active``) a
weight's dimensions cut over "data" (FSDP) are gathered at use, and the
product follows the weight's "model" cut: column-parallel (output
channels) on the replicated input, whose gradient the caller sums over
"model" once for every product that reads it (``sum_grads``: the q / k /
v projections share one, the gate and up projections one); row-parallel
(the contraction) on the rank's block of the input, the partial sums
added over "model" (``psum``).  A replicated scale read by a rank's block
of the computation has its gradient summed over "model" here.  The LSQ
gradient scale counts the whole tensors, as unsharded.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..core.quant import ternary_weight_quant, thermometer_act_quant
from ..core.sc_layers import SCQuantConfig, sc_linear_int_from_qat
from ..distributed.sharding import (DATA, MODEL, _names, axis_size,
                                    batch_axes, cols, fsdp_active, gather,
                                    is_sharded, psum, spec_of, sum_grads)

__all__ = ["dense_init", "dense_apply", "dense_spec", "fsdp_gather",
           "whole_numel", "matmul_rows",
           "sum_fixed", "norm_init", "norm_apply", "norm_spec", "rope_freqs",
           "apply_rope", "ACT_FNS", "big_neg", "softcap"]


def big_neg(dtype: torch.dtype) -> float:
    return float(torch.finfo(dtype).min) * 0.5


def dense_init(d_in: int, d_out: int, quant: SCQuantConfig, *,
               generator: torch.Generator, device: torch.device,
               dtype: torch.dtype = torch.bfloat16,
               scale: float | None = None) -> dict:
    """``w`` (d_in, d_out) ~ N(0, 1/d_in) plus the LSQ scales, initialised
    as the reference's ``dense_init``."""
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, device=device,
                    dtype=torch.float32) * std
    p = {"w": w.to(dtype)}
    if quant.enabled:
        shape = (d_out,) if quant.per_channel else ()
        p["alpha_w"] = torch.full(shape, 1.4 * std * 0.8,
                                  dtype=torch.float32, device=device)
        p["alpha_a"] = torch.tensor(
            2.0 / math.sqrt(max(quant.act_half, 1)), dtype=torch.float32,
            device=device)
    return p


def matmul_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated in float64, rounded once to ``x.dtype``, so
    that a row's result almost always ignores the other rows in the call
    (see the module docstring)."""
    return torch.matmul(x.to(torch.float64), w.to(torch.float64)).to(x.dtype)


def sum_fixed(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` by elementwise adds in one fixed order (halve the
    axis and add the halves until one entry is left; an odd entry out
    rides along to the next round).  Unlike a reduction kernel, whose
    order may follow the tensor's other dimensions, a row's sum never
    depends on how many rows share the call: the recurrences' small
    contractions use it so that batched serving equals sequential."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        half = x.narrow(dim, 0, n // 2) + x.narrow(dim, n // 2, n // 2)
        if n % 2:
            half = torch.cat([half, x.narrow(dim, n - 1, 1)], dim=dim)
        x = half
    return x.squeeze(dim)


def dense_spec(in_axis: str | None, out_axis: str | None,
               quant: SCQuantConfig) -> dict:
    """The specs of one dense layer's leaves: ``w`` (in, out), a
    per-channel ``alpha_w`` with its column, ``alpha_a`` whole."""
    s = {"w": (in_axis, out_axis)}
    if quant.enabled:
        s["alpha_w"] = (out_axis,) if quant.per_channel else ()
        s["alpha_a"] = ()
    return s


def dense_apply(p: dict, x: torch.Tensor, quant: SCQuantConfig, *,
                batch_invariant: bool = True, local: bool = False,
                take: tuple | None = None) -> torch.Tensor:
    """The SC integration point (see the module docstring).  Float
    products go through :func:`matmul_rows` when ``batch_invariant`` (the
    serving engine), else through a plain ``x @ w`` (training).  Under a
    mesh the output is this rank's block of columns with ``local``, all
    of them otherwise; under a training mesh a row-parallel weight takes
    this rank's block of the contraction and returns the summed output,
    and ``take`` (``(start, length)`` runs of the whole weight's columns)
    computes just those columns from the weight gathered whole."""
    if fsdp_active():
        return _dense_mesh(p, x, quant, batch_invariant, local, take)
    if quant.enabled and quant.mode == "sc_int":
        y = sc_linear_int_from_qat(p, x, quant)
    else:
        product = matmul_rows if batch_invariant else torch.matmul
        if not quant.enabled or quant.mode != "sc_qat":
            y = product(x, p["w"])
        else:
            x_fq = thermometer_act_quant(x, p["alpha_a"], quant.act_bsl)
            w_fq = ternary_weight_quant(p["w"], p["alpha_w"])
            y = product(x_fq, w_fq.to(x_fq.dtype))
    return cols(y, p["w"], local, MODEL)


def fsdp_gather(t: torch.Tensor) -> torch.Tensor:
    """A leaf with its "data"-cut dimensions gathered (FSDP; the gradient
    comes back reduce-scattered), its "model" cut kept."""
    for dim, ax in enumerate(spec_of(t)):
        if DATA in _names(ax) and axis_size(DATA) > 1:
            t = gather(t, DATA, dim)
    return t


def whole_numel(t: torch.Tensor, model_cut: bool = False,
                batch_cut: bool = False) -> int:
    """The element count of the whole tensor a rank holds a block of: its
    "model" block (``model_cut``) and its block of the batch
    (``batch_cut``) scaled back up."""
    n = t.numel()
    if model_cut:
        n *= axis_size(MODEL)
    if batch_cut:
        n *= axis_size(batch_axes())
    return n


def _take(t: torch.Tensor, runs: tuple, dim: int) -> torch.Tensor:
    """The ``(start, length)`` runs of ``t`` along ``dim``, concatenated."""
    return torch.cat([t.narrow(dim, a, n) for a, n in runs], dim=dim)


def _dense_mesh(p: dict, x: torch.Tensor, quant: SCQuantConfig,
                batch_invariant: bool, local: bool,
                take: tuple | None = None) -> torch.Tensor:
    """:func:`dense_apply` under a training mapping (see the module
    docstring).  ``x`` is this rank's block of the batch, whole in its
    last dimension for a column-parallel or whole weight (its gradient
    summed over "model" by the caller: ``sum_grads``), this rank's block
    of it for a row-parallel one.  With ``take`` a column-parallel weight
    is gathered whole over "model" too and only the named columns are
    computed: the gather's backward sums each rank's gradient of its own
    columns into the blocks."""
    w = p["w"]
    row, col = is_sharded(w, 0, MODEL), is_sharded(w, 1, MODEL)
    w = fsdp_gather(w)
    numel = whole_numel(w, row or col)
    if take is not None:
        w = _take(gather(w, MODEL, 1) if col else w, take, 1)
    product = matmul_rows if batch_invariant else torch.matmul
    if quant.enabled and quant.mode == "sc_int":
        raise NotImplementedError("the training mesh runs quantization "
                                  "off or sc_qat, not the integer "
                                  "datapath")
    if quant.enabled and quant.mode == "sc_qat":
        # replicated scales that read this rank's block of the product
        split = row or col or take is not None
        alpha_a = sum_grads(p["alpha_a"]) if split else p["alpha_a"]
        alpha_w = fsdp_gather(p["alpha_w"])
        if take is not None and alpha_w.ndim:
            if is_sharded(p["alpha_w"], 0, MODEL):
                alpha_w = gather(alpha_w, MODEL, 0)
            alpha_w = _take(alpha_w, take, 0)
        elif row or take is not None:
            alpha_w = sum_grads(alpha_w)
        x = thermometer_act_quant(x, alpha_a, quant.act_bsl,
                                  numel=whole_numel(x, row, True))
        w = ternary_weight_quant(w, alpha_w, numel=numel)
    y = product(x, w.to(x.dtype))
    if take is not None:
        return y
    if row:
        return psum(y)
    return gather(y, MODEL, -1) if col and not local else y


def norm_init(d: int, kind: str, device: torch.device) -> dict:
    """``scale`` ones, plus a ``bias`` of zeros for LayerNorm (float32)."""
    p = {"scale": torch.ones(d, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d, device=device)
    return p


def norm_spec(kind: str, axis: str | None = None) -> dict:
    s = {"scale": (axis,)}
    if kind == "layernorm":
        s["bias"] = (axis,)
    return s


def _mean64(x: torch.Tensor, square: bool = False) -> torch.Tensor:
    """Mean (of squares) over the last axis, taken in float64 (a float32
    square is exact there), as float32."""
    x64 = x.to(torch.float64)
    return torch.mean(x64 * x64 if square else x64, dim=-1,
                      keepdim=True).to(torch.float32)


def norm_apply(p: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6, groups: int = 0) -> torch.Tensor:
    """RMSNorm or LayerNorm in float32 (the statistics accumulated in
    float64), output in ``x.dtype``.  ``groups > 0`` is the grouped
    LayerNorm of RWKV's ``ln_x``: each of ``groups`` equal slices of the
    last axis normalized on its own, then one ``scale`` / ``bias`` (if
    present) over the whole axis, whatever ``kind`` says."""
    xf = x.to(torch.float32)
    if groups:
        xg = xf.reshape(*xf.shape[:-1], groups, xf.shape[-1] // groups)
        xc = xg - _mean64(xg)
        xn = (xc * torch.rsqrt(_mean64(xc, square=True) + eps)) \
            .reshape(xf.shape)
        out = xn * p["scale"]
        if "bias" in p:
            out = out + p["bias"]
        return out.to(x.dtype)
    if kind == "rmsnorm":
        out = xf * torch.rsqrt(_mean64(xf, square=True) + eps) * p["scale"]
    elif kind == "layernorm":
        xc = xf - _mean64(xf)
        out = xc * torch.rsqrt(_mean64(xc, square=True) + eps) \
            * p["scale"] + p["bias"]
    else:
        raise ValueError(f"unknown norm {kind!r}")
    return out.to(x.dtype)


def rope_freqs(head_dim: int, fraction: float, theta: float,
               device: torch.device) -> tuple[int, torch.Tensor]:
    rot_dim = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                        device=device) / rot_dim))
    return rot_dim, inv                      # (rot_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, head_dim: int,
               fraction: float, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S).  Interleaved pairs, as the
    reference."""
    rot_dim, inv = rope_freqs(head_dim, fraction, theta, x.device)
    if rot_dim == 0:
        return x
    ang = positions[..., None].to(torch.float32) * inv      # (B, S, R/2)
    cos = torch.cos(ang)[..., None, :]                      # (B, S, 1, R/2)
    sin = torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``tanh(x / cap) * cap``, or x for ``cap`` 0 (the reference's helper
    for ``logit_softcap``, which none of its models calls)."""
    return torch.tanh(x / cap) * cap if cap else x


# jax.nn.gelu defaults to the tanh approximation
ACT_FNS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": lambda x: x * torch.sigmoid(x),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": torch.relu,
    "relu2": lambda x: torch.square(torch.relu(x)),
}

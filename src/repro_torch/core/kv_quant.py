"""Compressed storage formats for the paged KV cache.

Port of ``repro.core.kv_quant``.  Three pool formats:

* ``"fp"``   pages in the model dtype;
* ``"int8"`` int8 levels with one f32 scale per cached position per KV
  head (``amax / 127``);
* ``"sc"``   the paper's coding: a BSL-16 coarse code at
  ``alpha_c = amax / 8`` plus a BSL-16 residual code at
  ``alpha_c * 2**-SC_SHIFT``, re-joined by the pow2 re-scaling block.

Scales are per position, so quantize-on-scatter never touches positions
written earlier, and all-zero pools (the trash page, unwritten tails)
dequantize to exact zeros.
"""

from __future__ import annotations

import torch

from .coding import quantize_levels
from .residual import residual_add_q

__all__ = ["KV_FORMATS", "INT8_BSL", "SC_COARSE_BSL", "SC_RESID_BSL",
           "SC_SHIFT", "check_kv_format", "kv_format_of", "kv_quant",
           "kv_dequant", "kv_error_bound"]

KV_FORMATS = ("fp", "int8", "sc")

INT8_BSL = 254                # levels -127..+127 fill the int8 range
SC_COARSE_BSL = 16            # levels -8..+8
SC_RESID_BSL = 16
SC_SHIFT = 4                  # alpha_resid = alpha_coarse * 2**-SC_SHIFT


def check_kv_format(fmt: str) -> str:
    if fmt not in KV_FORMATS:
        raise ValueError(f"kv_format must be one of {KV_FORMATS}, "
                         f"got {fmt!r}")
    return fmt


def kv_format_of(entry: dict) -> str:
    """The storage format of a pool dict: its scale / residual leaves are
    the format, so no config has to travel with the pools."""
    if "k_resid" in entry:
        return "sc"
    if "k_scale" in entry:
        return "int8"
    return "fp"


def _amax_scale(x: torch.Tensor, half: int) -> torch.Tensor:
    """Per-(..., head) scale over the trailing Dh axis: amax / half, floored
    away from zero so all-zero vectors quantize to exact zeros."""
    amax = torch.amax(torch.abs(x.to(torch.float32)), dim=-1)
    return torch.clamp(amax / half, min=torch.finfo(torch.float32).tiny)


def kv_quant(x: torch.Tensor, fmt: str) -> dict:
    """Quantize K or V ``(..., H, Dh)`` for pool storage.

    Returns ``{"q": x}`` for fp, ``{"q": int8, "scale": f32 (..., H)}``
    for int8, plus ``"resid"`` (int8) for sc.
    """
    check_kv_format(fmt)
    if fmt == "fp":
        return {"q": x}
    if fmt == "int8":
        scale = _amax_scale(x, INT8_BSL // 2)
        q = quantize_levels(x.to(torch.float32), scale[..., None], INT8_BSL)
        return {"q": q.to(torch.int8), "scale": scale}
    scale = _amax_scale(x, SC_COARSE_BSL // 2)          # alpha_c
    xf = x.to(torch.float32)
    code = quantize_levels(xf, scale[..., None], SC_COARSE_BSL)
    alpha_r = scale * (2.0 ** -SC_SHIFT)
    r = xf - scale[..., None] * code.to(torch.float32)
    resid = quantize_levels(r, alpha_r[..., None], SC_RESID_BSL)
    return {"q": code.to(torch.int8), "scale": scale,
            "resid": resid.to(torch.int8)}


def kv_dequant(q: torch.Tensor, scale: torch.Tensor | None = None,
               resid: torch.Tensor | None = None, *, fmt: str,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Pool storage -> float; ``scale`` broadcasts over the trailing Dh."""
    check_kv_format(fmt)
    if fmt == "fp":
        return q.to(dtype)
    if fmt == "int8":
        return (q.to(torch.float32) * scale[..., None]).to(dtype)
    fused = residual_add_q(resid, q, SC_SHIFT)          # q*2^s + resid
    alpha_r = scale * (2.0 ** -SC_SHIFT)
    return (fused.to(torch.float32) * alpha_r[..., None]).to(dtype)


def kv_error_bound(scale: torch.Tensor, fmt: str) -> torch.Tensor:
    """Elementwise absolute round-trip error bound of a stored value: 0
    for fp, half a level for int8 and half a residual level for sc."""
    check_kv_format(fmt)
    if fmt == "fp":
        return torch.zeros_like(scale)
    if fmt == "int8":
        return scale * 0.5
    return scale * (2.0 ** -SC_SHIFT) * 0.5

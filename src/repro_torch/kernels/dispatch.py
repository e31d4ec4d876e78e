"""Kernel dispatch: the tensor's device picks the kernel or its plain version.

Port of ``repro.kernels.dispatch`` with one rule in place of backend
knobs: a CUDA tensor goes to the hand-written CUDA kernel (which launches
or raises), a CPU tensor goes to the kernel's plain PyTorch version.
There is no scope, no environment variable and no row threshold that
would send a CUDA tensor to the plain version.
"""

from __future__ import annotations

import functools
import math

import torch

from ..core.bsn import ApproxBSNSpec, spec_stages
from . import ref
from .approx_bsn import (approx_bsn_cuda, approx_bsn_plain,
                         approx_bsn_temporal_cuda, approx_bsn_temporal_plain)
from .flash_attention import FlashAttention, flash_attention_cuda
from .paged_attention import paged_attn_decode_cuda, paged_attn_prefill_cuda

__all__ = ["approx_bsn", "paged_attn_decode", "paged_attn_verify",
           "paged_attn_prefill", "flash_attention"]

_flash_plain = functools.partial(ref.flash_attention_ref, return_lse=True)


def approx_bsn(counts: torch.Tensor, spec: ApproxBSNSpec, *,
               cycles: int = 1) -> torch.Tensor:
    """Approximate-BSN accumulation of ``(..., cycles * width)`` popcounts
    -> ``(...,)`` int32 output popcounts; the represented value is
    ``spec.scale * (out - cycles * spec.out_bsl // 2)``.  ``cycles > 1``
    is the Fig 12 temporal adder (its own kernel)."""
    total = cycles * spec.width
    if counts.shape[-1] != total:
        raise ValueError(f"expected trailing dim {total} (cycles={cycles} "
                         f"x width={spec.width}), got {tuple(counts.shape)}")
    batch = counts.shape[:-1]
    rows = math.prod(batch)
    x2 = counts.reshape(rows, total).to(torch.int32)
    kw = dict(in_bsl=spec.in_bsl, stages=spec_stages(spec))
    if cycles > 1:
        kw["cycles"] = cycles
        run = (approx_bsn_temporal_cuda if counts.is_cuda
               else approx_bsn_temporal_plain)
    else:
        run = approx_bsn_cuda if counts.is_cuda else approx_bsn_plain
    if counts.is_cuda:
        x2 = x2.contiguous()
    return run(x2, **kw).reshape(batch)


def paged_attn_decode(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, page_tables: torch.Tensor,
                      lengths: torch.Tensor, *, kv_format: str = "fp",
                      kv_aux: dict | None = None) -> torch.Tensor:
    """Batched one-token paged decode, (S, Hkv, G, D) -> (S, Hkv, G, D);
    compressed pools pass ``k_scale``/``v_scale`` (+ sc ``k_resid``/
    ``v_resid``) in ``kv_aux``."""
    aux = kv_aux or {}
    if q.is_cuda:
        return paged_attn_decode_cuda(q, k_pages, v_pages, page_tables,
                                      lengths, kv_format=kv_format, **aux)
    return ref.paged_attn_decode_ref(q, k_pages, v_pages, page_tables,
                                     lengths, kv_format=kv_format,
                                     kv_aux=aux)


def paged_attn_verify(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, page_tables: torch.Tensor,
                      lengths: torch.Tensor, *, kv_format: str = "fp",
                      kv_aux: dict | None = None) -> torch.Tensor:
    """The speculative verify window, (S, T, Hkv, G, D) queries at
    positions ``lengths + t`` -> (S, T, Hkv, G, D).  Row t is
    :func:`paged_attn_decode` at length ``lengths + t`` (on the card one
    launch of the decode kernel), so each row equals plain decode's bit
    for bit on either device."""
    return torch.stack(
        [paged_attn_decode(q[:, t].contiguous(), k_pages, v_pages,
                           page_tables, lengths + t, kv_format=kv_format,
                           kv_aux=kv_aux)
         for t in range(q.shape[1])], dim=1)


def paged_attn_prefill(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_tables: torch.Tensor,
                       start: int, *, kv_format: str = "fp",
                       kv_aux: dict | None = None) -> torch.Tensor:
    """One chunk of paged prefill, (G, C, Hkv, Gq, D) at positions
    ``[start, start + C)`` against every page written so far, causal."""
    aux = kv_aux or {}
    if q.is_cuda:
        return paged_attn_prefill_cuda(q, k_pages, v_pages, page_tables,
                                       start=start, kv_format=kv_format,
                                       **aux)
    return ref.paged_attn_prefill_ref(q, k_pages, v_pages, page_tables,
                                      start, kv_format=kv_format,
                                      kv_aux=aux)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Differentiable flash attention, q (B, S, Hq, D) and k / v
    (B, S, Hkv, D) -> (B, S, Hq, D); q is multiplied by ``scale`` (default
    ``1/sqrt(D)``) in float32.  The forward is the flash kernel on CUDA
    tensors and the plain version on CPU ones; the gradient is
    ``kernels/flash_attention.flash_attention_backward`` on both."""
    run = flash_attention_cuda if q.is_cuda else _flash_plain
    return FlashAttention.apply(q, k, v, causal, scale, run)

"""Plain PyTorch versions of the kernels: the correctness ground truth.

Port of ``repro.kernels.ref``: the SC integer datapath (ternary matmul
and its SI epilogue), the exact BSN's sort, the paged attention
(gather each slot's page window, dequantize it, mask and softmax) and
plain softmax attention, the flash kernel's ground truth.  These
are what the CPU runs and what ``chip_smoke.py`` holds the CUDA kernels
against on the card.
"""

from __future__ import annotations

import math

import torch

from ..core.kv_quant import kv_dequant

__all__ = ["ternary_matmul_ref", "si_epilogue_ref", "bsn_sort_ref",
           "gather_pages", "gather_pages_dequant", "paged_attn_decode_ref",
           "paged_attn_prefill_ref", "flash_attention_ref"]


def si_epilogue_ref(sum_q: torch.Tensor,
                    thresholds_q: torch.Tensor) -> torch.Tensor:
    """SI activation on accumulated q-domain sums: ``#{j : sum_q >= t_j} -
    out_bsl // 2``; ``thresholds_q`` (N, out_bsl) int32, ascending."""
    t = thresholds_q.to(torch.int32)
    out_counts = torch.sum(sum_q[..., None] >= t, dim=-1, dtype=torch.int32)
    return out_counts - t.shape[-1] // 2


def ternary_matmul_ref(x_q: torch.Tensor, w_int: torch.Tensor,
                       thresholds_q: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """int8 activation levels ``(..., K)`` x int8 ternary weights ``(K, N)``
    -> int32 sums, then the optional SI epilogue; or, batched, ``(E, M,
    K)`` x ``(E, K, N)`` -> ``(E, M, N)`` (``torch.matmul``'s broadcast).

    The product runs in float64 on every device: CUDA ``torch.matmul`` has
    no integer product, and float64 holds every partial sum exactly
    (``|sum| <= K * 128 * 128`` is far below ``2**53``), so the result is
    the exact integer sum in any summation order.
    """
    sums = torch.matmul(x_q.to(torch.float64), w_int.to(torch.float64))
    sum_q = sums.to(torch.int32)
    if thresholds_q is None:
        return sum_q
    return si_epilogue_ref(sum_q, thresholds_q)


def bsn_sort_ref(bits: torch.Tensor) -> torch.Tensor:
    """Descending sort of the trailing axis (thermometer normal form)."""
    return torch.sort(bits, dim=-1, descending=True).values


def gather_pages(pages: torch.Tensor,
                 page_tables: torch.Tensor) -> torch.Tensor:
    """(N, page, ...) pool + (S, maxp) tables -> (S, maxp*page, ...)."""
    S, maxp = page_tables.shape
    page = pages.shape[1]
    g = pages[page_tables.reshape(-1).long()]
    return g.reshape(S, maxp * page, *pages.shape[2:])


def gather_pages_dequant(pages: torch.Tensor, page_tables: torch.Tensor, *,
                         kv_format: str = "fp",
                         scale: torch.Tensor | None = None,
                         resid: torch.Tensor | None = None) -> torch.Tensor:
    """Gather then dequantize a compressed pool window (gather commutes
    with the elementwise dequant)."""
    g = gather_pages(pages, page_tables)
    if kv_format == "fp":
        return g
    sg = gather_pages(scale, page_tables)
    rg = gather_pages(resid, page_tables) if kv_format == "sc" else None
    return kv_dequant(g, sg, rg, fmt=kv_format)


def _window(k_pages, v_pages, page_tables, kv_format, kv_aux):
    aux = kv_aux or {}
    kg = gather_pages_dequant(k_pages, page_tables, kv_format=kv_format,
                              scale=aux.get("k_scale"),
                              resid=aux.get("k_resid"))
    vg = gather_pages_dequant(v_pages, page_tables, kv_format=kv_format,
                              scale=aux.get("v_scale"),
                              resid=aux.get("v_resid"))
    return kg.to(torch.float32), vg.to(torch.float32)


def paged_attn_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_tables: torch.Tensor,
                          lengths: torch.Tensor, *, kv_format: str = "fp",
                          kv_aux: dict | None = None) -> torch.Tensor:
    """One-token paged decode.  q: (S, Hkv, G, D); pools (N, page, Hkv, D)
    already holding the new token at ``lengths``; tables (S, maxp);
    positions ``t <= lengths[s]`` are live.  Returns (S, Hkv, G, D) in
    q.dtype."""
    D = q.shape[-1]
    kg, vg = _window(k_pages, v_pages, page_tables, kv_format, kv_aux)
    T = kg.shape[1]
    logits = torch.einsum("shgd,sthd->shgt", q.to(torch.float32),
                          kg) / math.sqrt(D)
    valid = (torch.arange(T, device=q.device)[None, :]
             <= lengths[:, None])                          # (S, T)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.tensor(-1e30, device=q.device))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("shgt,sthd->shgd", w, vg)
    return o.to(q.dtype)


def paged_attn_prefill_ref(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_tables: torch.Tensor,
                           start: int, *, kv_format: str = "fp",
                           kv_aux: dict | None = None) -> torch.Tensor:
    """Chunk ``[start, start + C)`` of G requests against every page written
    so far, causal.  q: (G, C, Hkv, Gq, D); tables (G, maxp).  Returns
    (G, C, Hkv, Gq, D) in q.dtype."""
    G, C, Hkv, Gq, D = q.shape
    page = k_pages.shape[1]
    seen = page_tables[:, :(start + C) // page]
    kg, vg = _window(k_pages, v_pages, seen, kv_format, kv_aux)
    T = kg.shape[1]
    logits = torch.einsum("sqhgd,sthd->shgqt", q.to(torch.float32),
                          kg) / math.sqrt(D)
    causal = (torch.arange(T, device=q.device)[None, :]
              <= (start + torch.arange(C, device=q.device))[:, None])
    logits = torch.where(causal[None, None, None], logits,
                         torch.tensor(-1e30, device=q.device))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("shgqt,sthd->sqhgd", w, vg)
    return o.to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, *, scale: float | None = None,
                        return_lse: bool = False):
    """Plain softmax attention with GQA broadcast.  q: (B, S, Hq, D); k, v:
    (B, S, Hkv, D) -> (B, S, Hq, D) in q.dtype, and with ``return_lse``
    also the per-row log-sum-exp (B, Hq, S) in float32.

    The flash kernel's arithmetic: q is cast to float32 and multiplied by
    ``scale`` (default ``1/sqrt(D)``) before the dot, where the
    reference's ``flash_attention_ref`` divides the dot by ``sqrt(D)``;
    for a power-of-two ``sqrt(D)`` (granite's D = 64) the two are equal.
    Causal logits ``k_col > q_row`` are set to -1e30 before the softmax.
    """
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hkv, g, D).to(torch.float32) * scale
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask, logits, torch.tensor(-1e30,
                                                        device=q.device))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.to(torch.float32))
    o = o.reshape(B, S, Hq, D).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(logits, dim=-1).reshape(B, Hq, S)

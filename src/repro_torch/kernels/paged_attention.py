"""Paged-attention CUDA kernel wrappers (decode + chunked prefill).

Port of ``repro.kernels.paged_attention``.  The kernels
(``csrc/paged_attention.cu``) read K/V pages straight through the page
tables and dequantize int8 / sc pools on load; their plain versions are
``kernels/ref.py``'s ``paged_attn_decode_ref`` / ``paged_attn_prefill_ref``.
bf16 q over bf16 / int8 / sc pools runs the tensor-core kernels (the
prefill at D 64 / 128 on 16-position pages the ``wgmma`` one, elsewhere
``mma.sync``), whose positions are split by absolute position (the
splits' partials go to a scratch buffer the wrapper allocates); float32
q or pools run the CUDA-core kernels.
Layouts are the reference's: q (S, Hkv, G, D) for decode and
(G, C, Hkv, Gq, D) for prefill, pools (N, page, Hkv, D), scales
(N, page, Hkv), int32 tables and lengths.
"""

from __future__ import annotations

import torch

from ..core.kv_quant import check_kv_format
from .build import kernel_op, launch, library, on_card, stream_of

__all__ = ["paged_attn_decode_cuda", "paged_attn_prefill_cuda"]

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FP_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t is None:
        raise ValueError(f"{name} is required for this kv_format")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _pools(q, kv_format, k_pages, v_pages, k_scale, v_scale, k_resid,
           v_resid):
    """Validate the pool operands; returns the kernel's KV kind code."""
    check_kv_format(kv_format)
    if not on_card(q):
        raise ValueError("the paged-attention kernels need CUDA tensors")
    if q.dtype not in _Q_DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    N, page, Hkv, D = k_pages.shape
    dev = q.device
    if kv_format == "fp":
        if k_pages.dtype not in _FP_KINDS:
            raise ValueError(f"fp pools must be float32 or bfloat16, got "
                             f"{k_pages.dtype}")
        kind = _FP_KINDS[k_pages.dtype]
    else:
        kind = 2 if kv_format == "int8" else 3
    pool_dtype = k_pages.dtype if kv_format == "fp" else torch.int8
    _check("k_pages", k_pages, pool_dtype, (N, page, Hkv, D), dev)
    _check("v_pages", v_pages, pool_dtype, (N, page, Hkv, D), dev)
    if kv_format != "fp":
        _check("k_scale", k_scale, torch.float32, (N, page, Hkv), dev)
        _check("v_scale", v_scale, torch.float32, (N, page, Hkv), dev)
    if kv_format == "sc":
        _check("k_resid", k_resid, torch.int8, (N, page, Hkv, D), dev)
        _check("v_resid", v_resid, torch.int8, (N, page, Hkv, D), dev)
    return kind


def paged_attn_decode_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_tables: torch.Tensor,
                           lengths: torch.Tensor, *, kv_format: str = "fp",
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           k_resid: torch.Tensor | None = None,
                           v_resid: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Batched one-token paged decode on the card.

    q (S, Hkv, G, D); pools hold the new token at position ``lengths``;
    page_tables (S, maxp) int32; lengths (S,) int32.  Page-table entries
    must index the pools (the engine's padded lanes point at trash page
    0).  bf16 q over bf16 / int8 / sc pools splits each lane's positions
    by absolute position and merges the splits on the card (one count in
    ``LAUNCHES``); float32 q or pools walk each lane's pages in one
    block.  Returns (S, Hkv, G, D) in q.dtype.
    """
    kind = _pools(q, kv_format, k_pages, v_pages, k_scale, v_scale,
                  k_resid, v_resid)
    S, Hkv, G, D = q.shape
    page = k_pages.shape[1]
    if k_pages.shape[2:] != (Hkv, D):
        raise ValueError(f"pools {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_tables.ndim != 2 or page_tables.shape[0] != S:
        raise ValueError(f"page_tables must be ({S}, maxp), got "
                         f"{tuple(page_tables.shape)}")
    maxp = page_tables.shape[1]
    _check("page_tables", page_tables, torch.int32, (S, maxp), q.device)
    _check("lengths", lengths, torch.int32, (S,), q.device)
    return _decode_op(q, k_pages, v_pages, page_tables, lengths, k_scale,
                      v_scale, k_resid, v_resid, kind)


def _empty_like_q(q, *_):
    return torch.empty_like(q)


@kernel_op("paged_attn_decode", _empty_like_q)
def _decode_op(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
               page_tables: torch.Tensor, lengths: torch.Tensor,
               k_scale: torch.Tensor | None, v_scale: torch.Tensor | None,
               k_resid: torch.Tensor | None, v_resid: torch.Tensor | None,
               kind: int) -> torch.Tensor:
    S, Hkv, G, D = q.shape
    page, maxp = k_pages.shape[1], page_tables.shape[1]
    out = torch.empty_like(q)
    if S == 0 or maxp == 0:
        return out.zero_()
    # the splits' partials, when a lane can span several splits: acc
    # (.., G, D), m and l (.., G) per split
    n_split = -(-maxp * page // library().paged_attn_decode_split_tokens())
    scratch = None if n_split == 1 else torch.empty(
        S * Hkv * n_split * G * (D + 2), dtype=torch.float32,
        device=q.device)
    launch("paged_attn_decode", "paged_attn_decode_launch",
           q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
           _ptr(k_scale), _ptr(v_scale), _ptr(k_resid), _ptr(v_resid),
           page_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
           _ptr(scratch), S, Hkv, G, D, page, maxp, _Q_DTYPES[q.dtype],
           kind, stream_of(q))
    return out


def paged_attn_prefill_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, page_tables: torch.Tensor,
                            *, start: int, block_q: int = 32,
                            kv_format: str = "fp",
                            k_scale: torch.Tensor | None = None,
                            v_scale: torch.Tensor | None = None,
                            k_resid: torch.Tensor | None = None,
                            v_resid: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """One prefill chunk on the card.

    q (G, C, Hkv, Gq, D) holds positions ``[start, start + C)``; C and
    ``start`` are multiples of the page size; the pools already hold the
    chunk's K/V; page_tables (G, width) int32 with width >= (start+C)/page.
    Causal mask ``k_pos <= start + row``.  bf16 q over bf16 / int8 / sc
    pools runs a tensor-core kernel, chosen by head dim and page size
    only: at D 64 and 128 on 16-position pages (the engine's)
    ``paged_prefill_wgmma_kernel`` (a TMA producer warpgroup, ``wgmma``
    consumer warpgroups of 64 rows; int8 / sc codes widened on the card,
    sc's code and residual joined into one bf16 operand), at other head
    dims and pages ``paged_prefill_mma_kernel`` (``mma.sync``).  A block
    holds ``block_q`` positions (at most 128 / Gq) of all Gq heads of one
    KV head, and a row's result does not depend on ``block_q``, C,
    ``start`` or the other requests.  float32 q or pools run the CUDA-core
    ``prefill_kernel``.  Returns q's shape and dtype.
    """
    kind = _pools(q, kv_format, k_pages, v_pages, k_scale, v_scale,
                  k_resid, v_resid)
    G, C, Hkv, Gq, D = q.shape
    page = k_pages.shape[1]
    if k_pages.shape[2:] != (Hkv, D):
        raise ValueError(f"pools {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if C % page or start % page or start < 0:
        raise ValueError(f"C={C} and start={start} must be multiples of "
                         f"page={page}")
    if page_tables.ndim != 2 or page_tables.shape[0] != G:
        raise ValueError(f"page_tables must be ({G}, width), got "
                         f"{tuple(page_tables.shape)}")
    width = page_tables.shape[1]
    if width < (start + C) // page:
        raise ValueError(f"page_tables width {width} < the "
                         f"{(start + C) // page} pages seen so far")
    _check("page_tables", page_tables, torch.int32, (G, width), q.device)
    return _prefill_op(q, k_pages, v_pages, page_tables, k_scale, v_scale,
                       k_resid, v_resid, start, max(1, min(block_q, C)),
                       kind)


@kernel_op("paged_attn_prefill", _empty_like_q)
def _prefill_op(q: torch.Tensor, k_pages: torch.Tensor,
                v_pages: torch.Tensor, page_tables: torch.Tensor,
                k_scale: torch.Tensor | None, v_scale: torch.Tensor | None,
                k_resid: torch.Tensor | None, v_resid: torch.Tensor | None,
                start: int, bq: int, kind: int) -> torch.Tensor:
    G, C, Hkv, Gq, D = q.shape
    page, width = k_pages.shape[1], page_tables.shape[1]
    out = torch.empty_like(q)
    if G == 0 or C == 0:
        return out
    # the key splits' partials when the chunk's keys span several splits
    n_split = -(-(start + C) // library().paged_attn_prefill_split_tokens())
    scratch = None if n_split == 1 else torch.empty(
        G * C * Hkv * Gq * n_split * (D + 2), dtype=torch.float32,
        device=q.device)
    launch("paged_attn_prefill", "paged_attn_prefill_launch",
           q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
           _ptr(k_scale), _ptr(v_scale), _ptr(k_resid), _ptr(v_resid),
           page_tables.data_ptr(), out.data_ptr(), _ptr(scratch), G, C, Hkv,
           Gq, D, page, width, start, bq, k_pages.shape[0],
           _Q_DTYPES[q.dtype], kind, stream_of(q))
    return out

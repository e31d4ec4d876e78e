"""Flash attention: the CUDA forward kernel, its gradient and the
autograd function the training path runs.

Port of ``repro.kernels.flash_attention.flash_attention_pallas``.  The
kernel (``csrc/flash_attention.cu``) computes causal or bidirectional GQA
attention with an online softmax and also writes each row's log-sum-exp;
its plain version is ``kernels/ref.flash_attention_ref``.  Layouts are the
reference's: q (B, S, Hq, D), k / v (B, S, Hkv, D), q head ``h`` reading
KV head ``h // (Hq // Hkv)``.

The dtype and head width pick the kernel (``flash_geometry`` in the
source, reported by ``flash_attention_geometry``), never a failed launch:

- bfloat16 at D 64, 80 and 128 (granite, hubert, jamba and llava: the
  training path and the dense prefills) runs ``flash_fwd_wgmma_kernel``,
  warp-specialised for Hopper: a producer warp's TMA loads, two consumer
  warpgroups' ``wgmma`` products with float32 sums, P passed as two bf16
  terms;
- bfloat16 at D 16 and 32 runs ``flash_fwd_mma_kernel`` (``mma.sync``,
  the same numerics);
- float32 runs ``flash_fwd_kernel``, float32 FMAs on the CUDA cores,
  which the float32 card-equals-CPU checks hold to 1e-5.

A call the chosen kernel cannot take raises; no kernel stands in for
another.

The TPU kernel is forward only: the reference trains through XLA's
autodiff of its jnp scan.  Here :class:`FlashAttention` is an
``autograd.Function`` whose forward is the kernel on the card (the plain
version on the CPU) and whose backward, :func:`flash_attention_backward`,
is written in PyTorch tensor ops: it recomputes the attention weights a
block of query rows at a time from the saved log-sum-exp, so the whole
(B, Hq, S, S) matrix never exists.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from .build import kernel_op, launch, on_card, stream_of

__all__ = ["flash_attention_cuda", "flash_attention_backward",
           "FlashAttention"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# float32 elements of one (B, Hq, rows, S) weights block in the backward
_BWD_BLOCK_ELEMS = 1 << 25


def _check(name: str, t: torch.Tensor, like: torch.Tensor, shape) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"{name} must be {like.dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, scale: float | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward on the card.

    q (B, S, Hq, D); k, v (B, S, Hkv, D) with Hq a multiple of Hkv; all
    contiguous CUDA tensors of one dtype, float32 or bfloat16; D one of
    16, 32, 64, 80 (hubert's head), 128; any S.  ``scale`` multiplies q in float32 (default
    ``1/sqrt(D)``).  Returns (out (B, S, Hq, D) in q's dtype, lse
    (B, Hq, S) float32).
    """
    if not on_card(q):
        raise ValueError("the flash-attention kernel needs CUDA tensors")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q and k must be 4-d, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    _check("q", q, q, (B, S, Hq, D))
    _check("k", k, q, (B, S, Hkv, D))
    _check("v", v, q, (B, S, Hkv, D))
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    return _flash_op(q, k, v, bool(causal), float(scale))


def _flash_outputs(q, k, v, causal, scale):
    B, S, Hq, _ = q.shape
    return (torch.empty_like(q),
            torch.empty((B, Hq, S), dtype=torch.float32, device=q.device))


@kernel_op("flash_attention", _flash_outputs)
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float
              ) -> tuple[torch.Tensor, torch.Tensor]:
    B, S, Hq, D = q.shape
    out, lse = _flash_outputs(q, k, v, causal, scale)
    if q.numel() == 0:
        return out, lse
    launch("flash_attention", "flash_attention_launch", q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), B, S,
           Hq, k.shape[2], D, scale, int(causal), _DTYPES[q.dtype],
           stream_of(q))
    return out, lse


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, lse: torch.Tensor,
                             d_out: torch.Tensor, *, causal: bool,
                             scale: float | None = None):
    """Gradients (dq, dk, dv) of flash attention, in float32 tensor ops.

    For each block of query rows: recompute ``P = exp(q k^T * scale -
    lse)`` against the keys the block sees, then ``dV += P^T dO``,
    ``dP = dO V^T``, ``dS = P (dP - rowsum(P dP))``, ``dQ = dS K * scale``
    and ``dK += dS^T q * scale``, dK and dV summed over the query heads of
    each GQA group.  ``rowsum(P dP)`` equals ``rowsum(dO O)``; taking it
    from the recomputed block spares saving O.  Blocks hold at most
    ``_BWD_BLOCK_ELEMS`` weights, so no (B, Hq, S, S) tensor is built.
    """
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    kf, vf = k.to(f32), v.to(f32)
    lse_g = lse.reshape(B, Hkv, G, S)
    dq = torch.empty((B, S, Hkv, G, D), dtype=f32, device=q.device)
    dk = torch.zeros((B, S, Hkv, D), dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    rows = max(1, min(S, _BWD_BLOCK_ELEMS // max(1, B * Hq * S)))
    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        end = r1 if causal else S
        qg = q[:, r0:r1].to(f32).reshape(B, r1 - r0, Hkv, G, D) * scale
        dog = d_out[:, r0:r1].to(f32).reshape(B, r1 - r0, Hkv, G, D)
        kb, vb = kf[:, :end], vf[:, :end]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb)
        p = torch.exp(s - lse_g[..., r0:r1, None])
        if causal:
            live = (torch.arange(end, device=q.device)[None, :]
                    <= torch.arange(r0, r1, device=q.device)[:, None])
            p = torch.where(live, p, torch.zeros((), device=q.device))
        dv[:, :end] += torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vb)
        ds = p * (dp - torch.sum(p * dp, dim=-1, keepdim=True))
        dq[:, r0:r1] = torch.einsum("bhgqk,bkhd->bqhgd", ds, kb) * scale
        dk[:, :end] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return (dq.reshape(B, S, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """``forward_fn(q, k, v, causal=, scale=) -> (out, lse)`` with the
    gradient of :func:`flash_attention_backward`; ``kernels/dispatch``
    passes the kernel for CUDA tensors and the plain version for CPU
    ones."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float | None,
                forward_fn: Callable):
        out, lse = forward_fn(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, lse, d_out,
                                              causal=ctx.causal,
                                              scale=ctx.scale)
        return dq, dk, dv, None, None, None

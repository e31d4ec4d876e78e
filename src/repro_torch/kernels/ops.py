"""Front doors of the SC datapath kernels: batching, ragged shapes and the
device rule.

Port of ``repro.kernels.ops``.  A CUDA tensor goes to the hand-written
kernel (which launches or raises), a CPU tensor to its plain PyTorch
version; there is no size threshold (the reference's
``min_flops_for_kernel`` / ``min_rows_for_kernel``) and no backend knob.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import ref
from .build import on_card
from .bsn_sort import bsn_sort_cuda, bsn_sort_plain
from .ternary_matmul import operand_multiple, ternary_matmul_cuda

__all__ = ["ternary_matmul", "pad_operands", "bsn_sort", "sort_rows"]

# never-firing SI threshold of a padded output channel
_NEVER = torch.iinfo(torch.int32).max


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pad_operands(x2: torch.Tensor, w_int: torch.Tensor,
                 thresholds_q: torch.Tensor | None, multiple: int):
    """Zero-pad K and N of ``x2 (..., M, K)`` and ``w_int (..., K, N)`` to
    ``multiple``; padded output channels get a never-firing threshold.
    Operands already on the multiple come back as they are."""
    k, n = w_int.shape[-2:]
    kp, np_ = _round_up(k, multiple), _round_up(n, multiple)
    if kp != k:
        x2 = F.pad(x2, (0, kp - k))
    if (kp, np_) != (k, n):
        w_int = F.pad(w_int, (0, np_ - n, 0, kp - k))
        if thresholds_q is not None:
            thresholds_q = F.pad(thresholds_q, (0, 0, 0, np_ - n),
                                 value=_NEVER)
    return x2, w_int, thresholds_q


def ternary_matmul(x_q: torch.Tensor, w_int: torch.Tensor,
                   thresholds_q: torch.Tensor | None = None) -> torch.Tensor:
    """SC integer datapath matmul: ``(..., K)`` x ``(K, N)`` -> ``(..., N)``
    int32, then the SI epilogue when ``thresholds_q (N, out_bsl)`` (q
    domain) is given.  A 3-d ``w_int (E, K, N)`` takes ``x_q (E, M, K)``
    to ``(E, M, N)``: E independent products (the MoE experts'), one
    kernel launch on the card, no SI.

    ``x_q``: int8 activation levels; ``w_int``: int8 ternary weights.  On
    the card, K and N are zero-padded to the multiple the kernel for this
    many rows reads (4 for the dp4a kernel, 16 for the tensor-core one)
    when they are ragged (padded output channels get a never-firing
    threshold and are cropped); any M is taken as it is.
    """
    if w_int.ndim == 3:
        return _batched(x_q, w_int, thresholds_q)
    *batch, k = x_q.shape
    k2, n = w_int.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(x_q.shape)} x "
                         f"{tuple(w_int.shape)}")
    m = math.prod(batch)
    x2 = x_q.reshape(m, k)
    t2 = None if thresholds_q is None else thresholds_q.to(torch.int32)
    if not on_card(x_q):
        out = ref.ternary_matmul_ref(x2, w_int, t2)
    else:
        x2, w2, t2 = pad_operands(x2, w_int, t2, operand_multiple(m))
        out = ternary_matmul_cuda(
            x2.contiguous(), w2.contiguous(),
            None if t2 is None else t2.contiguous())
        if out.shape[1] != n:
            out = out[:, :n]
    return out.reshape(*batch, n) if batch else out[0]


def _batched(x_q: torch.Tensor, w_int: torch.Tensor,
             thresholds_q: torch.Tensor | None) -> torch.Tensor:
    """``(E, M, K)`` x ``(E, K, N)`` -> ``(E, M, N)`` int32."""
    if thresholds_q is not None:
        raise ValueError("the SI epilogue takes one product, not a batch")
    if (x_q.ndim != 3 or x_q.shape[0] != w_int.shape[0]
            or x_q.shape[2] != w_int.shape[1]):
        raise ValueError(f"expected x_q (E, M, K) and w_int (E, K, N), got "
                         f"{tuple(x_q.shape)} and {tuple(w_int.shape)}")
    if not on_card(x_q):
        return ref.ternary_matmul_ref(x_q, w_int)
    n = w_int.shape[2]
    x2, w2, _ = pad_operands(x_q, w_int, None, operand_multiple(x_q.shape[1]))
    out = ternary_matmul_cuda(x2.contiguous(), w2.contiguous())
    return out if out.shape[2] == n else out[..., :n]


def sort_rows(x: torch.Tensor, *, descending: bool = True) -> torch.Tensor:
    """The bitonic network on ``(R, L)`` rows, L a power of two: the
    ``bsn_sort`` kernel on a CUDA tensor, its plain version on the CPU."""
    if on_card(x):
        return bsn_sort_cuda(x, descending=descending)
    return bsn_sort_plain(x, descending=descending)


def bsn_sort(bits: torch.Tensor) -> torch.Tensor:
    """Descending bitonic sort of thermometer bit vectors ``(..., L)``.

    Pads L to the next power of two with **zeros** and crops, as the
    reference does.  That keeps the popcount for {0, 1} bit inputs only:
    on a row with negative values and a non-power-of-two length the
    padded zeros outrank the negatives, so the cropped row is not a sort
    of the input (the reference behaves the same, and so does this port).
    """
    *batch, length = bits.shape
    r = math.prod(batch)
    lp = 1 << (length - 1).bit_length()
    x2 = bits.reshape(r, length)
    if lp != length:
        x2 = F.pad(x2, (0, lp - length))
    out = sort_rows(x2.contiguous(), descending=True)[:, :length]
    return out.reshape(*batch, length) if batch else out[0]

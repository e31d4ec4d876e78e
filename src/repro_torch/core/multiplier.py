"""Ternary SC multiplier (paper §II-B, Fig 3a).

Port of ``repro.core.multiplier``.  The deterministic multiplier takes a
2-bit thermometer activation and a 2-bit thermometer weight (both
ternary, {-1, 0, +1}) and gives their 2-bit thermometer product with 5
gates.  Writing a ternary code as (f, s) = (first bit, second bit):

    pf = (fa | ~sw) & (fw | ~sa)
    ps = (sa & sw) | (~fa & ~fw)

The wider datapaths' form (ternary weight x L-bit activation) is pass /
zero code / negate, all wiring in hardware (:func:`ternary_scale_bits`).
"""

from __future__ import annotations

import torch

from .coding import check_bsl, negate_bits, zero_code

__all__ = ["ternary_mul_bits", "ternary_mul_q", "ternary_scale_bits",
           "TERNARY_MUL_GATES"]

# gate count of the 2-bit multiplier (the hardware cost model's figure)
TERNARY_MUL_GATES = 5


def ternary_mul_bits(a_bits: torch.Tensor,
                     w_bits: torch.Tensor) -> torch.Tensor:
    """Gate-level 2-bit ternary multiplier; int8 ``(..., 2)`` in and out."""
    if a_bits.shape[-1] != 2 or w_bits.shape[-1] != 2:
        raise ValueError("ternary_mul_bits operates on 2-bit BSL codes")
    fa, sa = a_bits[..., 0].to(torch.int32), a_bits[..., 1].to(torch.int32)
    fw, sw = w_bits[..., 0].to(torch.int32), w_bits[..., 1].to(torch.int32)
    pf = torch.clamp(fa + (1 - sw), 0, 1) * torch.clamp(fw + (1 - sa), 0, 1)
    ps = torch.clamp(sa * sw + (1 - fa) * (1 - fw), 0, 1)
    return torch.stack([pf, ps], dim=-1).to(torch.int8)


def ternary_mul_q(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The q-domain equivalent: the integer product, int32."""
    return a_q.to(torch.int32) * w_q.to(torch.int32)


def ternary_scale_bits(w_q: torch.Tensor,
                       a_bits: torch.Tensor) -> torch.Tensor:
    """Ternary weight x L-bit thermometer activation: ``w = +1`` passes the
    code, ``0`` gives the zero code, ``-1`` the negated code.  ``w_q``
    broadcasts against ``a_bits[..., :-1]``."""
    bsl = a_bits.shape[-1]
    check_bsl(bsl)
    w = w_q[..., None].to(torch.int32)
    neg = negate_bits(a_bits)
    zero = zero_code(bsl, device=a_bits.device)
    out = torch.where(w > 0, a_bits, torch.where(w < 0, neg, zero))
    return out.to(torch.int8)

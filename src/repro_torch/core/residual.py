"""High-precision residual re-scaling block (paper §III), q domain.

Port of ``repro.core.residual``: the re-scaler aligns a residual code
with the datapath's scale by powers of two, a wiring operation in
hardware and integer shifts here.  A multiply by 2^N replicates the
bitstream; a divide runs N cycles of "keep 1 of 2 bits", each padding the
code back to its length with the zero code (``11110000`` at L 16).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pow2_exponent", "rescale_q", "rescale_bits_div2",
           "residual_add_q"]


def pow2_exponent(alpha_from: float, alpha_to: float) -> int:
    """N such that ``alpha_from * 2^N`` best matches ``alpha_to``
    (``round(log2)``, half to even as numpy rounds)."""
    return int(np.round(np.log2(alpha_to / alpha_from)))


def rescale_q(v_q: torch.Tensor, n: int) -> torch.Tensor:
    """value * 2^n in the q domain (int32); ``n < 0`` runs |n| divide
    cycles of ``v -> floor((v + 1) / 2)`` (the centred bit subsample)."""
    v = v_q.to(torch.int32)
    if n >= 0:
        return v * (1 << n)
    for _ in range(-n):
        v = (v + 1) >> 1
    return v


def rescale_bits_div2(bits: torch.Tensor) -> torch.Tensor:
    """One bit-level divide cycle on L-bit thermometer codes ``(..., L)``:
    bits ``0, 2, 4, ...`` (``floor((c + 1) / 2)`` ones), then ``L/4`` ones
    and ``L/4`` zeros, so the length stays L.  The result is two
    thermometer codes concatenated, not one canonical code, as the
    hardware produces it; its value is still ``popcount - L/2``, which is
    all a BSN accumulator reads."""
    length = bits.shape[-1]
    half = length // 2
    quarter = half // 2
    lead = bits.shape[:-1]
    pad = torch.cat([torch.ones(lead + (quarter,), dtype=bits.dtype,
                                device=bits.device),
                     torch.zeros(lead + (half - quarter,), dtype=bits.dtype,
                                 device=bits.device)], dim=-1)
    return torch.cat([bits[..., 0:length:2], pad], dim=-1)


def residual_add_q(conv_q: torch.Tensor, resid_q: torch.Tensor,
                   n: int) -> torch.Tensor:
    """``conv_q + rescale_q(resid_q, n)`` in int32."""
    return conv_q.to(torch.int32) + rescale_q(resid_q, n)

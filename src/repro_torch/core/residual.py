"""High-precision residual re-scaling block (paper §III), q domain.

Port of ``repro.core.residual.rescale_q`` / ``residual_add_q``: the
re-scaler aligns a residual code with the datapath's scale by powers of
two, a wiring operation in hardware and integer shifts here.
"""

from __future__ import annotations

import torch

__all__ = ["rescale_q", "residual_add_q"]


def rescale_q(v_q: torch.Tensor, n: int) -> torch.Tensor:
    """value * 2^n in the q domain (int32); ``n < 0`` runs |n| divide
    cycles of ``v -> floor((v + 1) / 2)`` (the centred bit subsample)."""
    v = v_q.to(torch.int32)
    if n >= 0:
        return v * (1 << n)
    for _ in range(-n):
        v = (v + 1) >> 1
    return v


def residual_add_q(conv_q: torch.Tensor, resid_q: torch.Tensor,
                   n: int) -> torch.Tensor:
    """``conv_q + rescale_q(resid_q, n)`` in int32."""
    return conv_q.to(torch.int32) + rescale_q(resid_q, n)

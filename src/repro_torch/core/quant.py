"""SC-friendly fake quantizers (paper §III-B), forward only.

Port of the forward of ``repro.core.quant``: LSQ fake-quant, ternary
weights, thermometer activations and the ternary scale's init.  Serving
needs no gradient; the custom backward waits for the training slice.
"""

from __future__ import annotations

import torch

__all__ = ["lsq_fake_quant", "ternary_weight_quant", "thermometer_act_quant",
           "ternary_weight_init_alpha"]


def lsq_fake_quant(x: torch.Tensor, alpha: torch.Tensor, qn: int,
                   qp: int) -> torch.Tensor:
    """``alpha * clip(round(x / alpha), qn, qp)``.

    The value path runs in ``x.dtype``: alpha is cast to it first, so a
    bf16 model stays bf16 and the rounding boundary is computed against
    the cast alpha, as in the reference.
    """
    a = alpha.to(x.dtype)
    q = torch.clamp(torch.round(x / a), qn, qp)
    return q * a


def ternary_weight_quant(w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """2-bit-BSL (ternary) weight fake-quant: levels {-1, 0, +1}."""
    return lsq_fake_quant(w, alpha, -1, 1)


def thermometer_act_quant(x: torch.Tensor, alpha: torch.Tensor,
                          bsl: int) -> torch.Tensor:
    """L-bit-BSL activation fake-quant: levels [-L/2, L/2]."""
    half = bsl // 2
    return lsq_fake_quant(x, alpha, -half, half)


def ternary_weight_init_alpha(w: torch.Tensor) -> torch.Tensor:
    """Per-tensor ternary step: ``max(1.4 * mean|w|, 1e-8)``, the midpoint
    of TWN's 0.7 * mean|w| threshold and LSQ's 2 * mean|w| step."""
    return torch.clamp(1.4 * torch.mean(torch.abs(w)), min=1e-8)

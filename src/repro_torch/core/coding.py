"""Deterministic thermometer coding: the q-domain quantizer.

Port of ``repro.core.coding``'s inference-time quantizer.  A value is
``x = alpha * x_q`` with an integer level ``x_q`` in ``[-L/2, L/2]`` for a
bitstream length (BSL) ``L``.
"""

from __future__ import annotations

import torch

__all__ = ["check_bsl", "quantize_levels"]


def check_bsl(bsl: int) -> int:
    """Validate a bitstream length: positive and even (zero must be exact)."""
    if bsl < 2 or bsl % 2 != 0:
        raise ValueError(f"BSL must be an even integer >= 2, got {bsl}")
    return bsl


def quantize_levels(x: torch.Tensor, alpha: torch.Tensor | float,
                    bsl: int) -> torch.Tensor:
    """float -> q domain: ``clip(round(x / alpha), -L/2, L/2)`` as int32.

    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    check_bsl(bsl)
    half = bsl // 2
    return torch.clamp(torch.round(x / alpha), -half, half).to(torch.int32)

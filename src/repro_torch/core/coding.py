"""Deterministic thermometer coding (paper §II, Table II).

Port of ``repro.core.coding``.  A value is ``x = alpha * x_q`` with an
integer level ``x_q`` in ``[-L/2, L/2]`` for a bitstream length (BSL)
``L``; its bitstream is the L-bit thermometer code with ``x_q + L/2``
ones followed by zeros.  Three value domains:

* **bit domain**   — int8 tensors with a trailing length-L axis of {0,1};
* **q domain**     — integer levels ``x_q = popcount(bits) - L/2``;
* **count domain** — ``c = popcount(bits) = x_q + L/2`` in ``[0, L]``.
"""

from __future__ import annotations

import torch

__all__ = ["THERMOMETER_TABLE", "check_bsl", "encode_thermometer",
           "decode_thermometer", "counts_from_bits", "negate_bits",
           "zero_code", "quantize_levels", "dequantize_levels",
           "is_thermometer"]

# Table II of the paper
THERMOMETER_TABLE = {
    2: {-1: "00", 0: "10", 1: "11"},
    4: {-2: "0000", -1: "1000", 0: "1100", 1: "1110", 2: "1111"},
}


def check_bsl(bsl: int) -> int:
    """Validate a bitstream length: positive and even (zero must be exact)."""
    if bsl < 2 or bsl % 2 != 0:
        raise ValueError(f"BSL must be an even integer >= 2, got {bsl}")
    return bsl


def encode_thermometer(x_q: torch.Tensor, bsl: int) -> torch.Tensor:
    """q domain -> bit domain: int8 ``(..., bsl)``; levels outside
    ``[-bsl/2, bsl/2]`` saturate, as hardware registers do."""
    check_bsl(bsl)
    half = bsl // 2
    count = torch.clamp(x_q, -half, half).to(torch.int32) + half
    positions = torch.arange(bsl, dtype=torch.int32, device=x_q.device)
    return (positions < count[..., None]).to(torch.int8)


def counts_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """bit domain -> count domain (popcount of the trailing axis), int32."""
    return torch.sum(bits, dim=-1, dtype=torch.int32)


def decode_thermometer(bits: torch.Tensor) -> torch.Tensor:
    """bit domain -> q domain: ``popcount - L/2``."""
    bsl = bits.shape[-1]
    check_bsl(bsl)
    return counts_from_bits(bits) - bsl // 2


def negate_bits(bits: torch.Tensor) -> torch.Tensor:
    """Bit-domain negation: complement and reverse keep thermometer form
    (``popcount' = L - popcount``, so ``x_q' = -x_q``)."""
    return (1 - torch.flip(bits, dims=(-1,))).to(torch.int8)


def zero_code(bsl: int, shape: tuple[int, ...] = (),
              device: torch.device | str | None = None) -> torch.Tensor:
    """The thermometer code of level 0 (L/2 ones then L/2 zeros)."""
    check_bsl(bsl)
    return encode_thermometer(torch.zeros(shape, dtype=torch.int32,
                                          device=device), bsl)


def quantize_levels(x: torch.Tensor, alpha: torch.Tensor | float,
                    bsl: int) -> torch.Tensor:
    """float -> q domain: ``clip(round(x / alpha), -L/2, L/2)`` as int32.

    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    check_bsl(bsl)
    half = bsl // 2
    return torch.clamp(torch.round(x / alpha), -half, half).to(torch.int32)


def dequantize_levels(x_q: torch.Tensor,
                      alpha: torch.Tensor | float) -> torch.Tensor:
    """q domain -> float32: ``alpha * x_q``."""
    return x_q.to(torch.float32) * alpha


def is_thermometer(bits: torch.Tensor) -> torch.Tensor:
    """True where the trailing axis is a valid thermometer code: binary,
    and no 1 after the first 0."""
    descending = torch.all(bits[..., :-1] >= bits[..., 1:], dim=-1)
    binary = torch.all((bits == 0) | (bits == 1), dim=-1)
    return descending & binary

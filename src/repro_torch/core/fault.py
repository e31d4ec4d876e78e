"""Bit-error fault injection (paper Fig 5).

Port of ``repro.core.fault``.  Thermometer SC codes degrade gracefully
under bit flips: a flipped bit moves the popcount by one LSB wherever it
sits.  Positional binary does not: a flipped MSB moves the value by
2^(B-1).  Both representations are flipped at one bit error rate and
decoded back to values.  The flip masks are ``prng.bernoulli`` draws,
so a key gives ``jax.random``'s masks bit for bit.
"""

from __future__ import annotations

import torch

from .. import prng
from .coding import counts_from_bits, encode_thermometer

__all__ = ["flip_bits", "thermometer_under_ber", "binary_under_ber"]


def flip_bits(bits: torch.Tensor, ber: float,
              key: torch.Tensor) -> torch.Tensor:
    """XOR a Bernoulli(``ber``) mask into a {0, 1} bit tensor (int8)."""
    mask = prng.bernoulli(key.to(bits.device), ber, tuple(bits.shape))
    return torch.bitwise_xor(bits.to(torch.int8), mask.to(torch.int8))


def thermometer_under_ber(x_q: torch.Tensor, bsl: int, ber: float,
                          key: torch.Tensor) -> torch.Tensor:
    """Encode q levels as thermometer codes, flip at ``ber``, decode
    (popcount - L/2: flipped bits are +-1 LSB each, and flips in the 1
    and 0 regions partly cancel)."""
    noisy = flip_bits(encode_thermometer(x_q, bsl), ber, key)
    return counts_from_bits(noisy) - bsl // 2


def binary_under_ber(x_q: torch.Tensor, n_bits: int, ber: float,
                     key: torch.Tensor) -> torch.Tensor:
    """The two's-complement baseline: flip bits of the positional code of
    ``x_q`` in ``[-2^(B-1), 2^(B-1) - 1]`` and sign-extend (int32)."""
    v = x_q.to(torch.int32) & ((1 << n_bits) - 1)
    weights = 1 << torch.arange(n_bits, dtype=torch.int32, device=x_q.device)
    bits = ((v[..., None] // weights) % 2).to(torch.int8)
    noisy = flip_bits(bits, ber, key)
    nv = torch.sum(noisy.to(torch.int32) * weights, dim=-1,
                   dtype=torch.int32)
    return torch.where(nv >= (1 << (n_bits - 1)), nv - (1 << n_bits), nv)

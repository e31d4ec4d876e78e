"""Threefry-2x32 keys and draws, bit-equal to ``jax.random``'s.

The parts of ``jax.random`` that the port's seeded streams need, in torch
integer ops: uint32 values held in int64 tensors and masked to 32 bits
after every add, multiply and shift, so the same code runs on the CPU and
on the card.  They follow jax's default PRNG as jax 0.9.0 computes it with
``jax_threefry_partitionable`` on (its default since jax 0.5): the
fold-like ``split`` and the counter layout of ``random_bits`` are those of
that mode.  The names are the counterparts' in ``jax/_src/prng.py``
(``threefry_seed``, ``iota_2x32_shape``, ``threefry2x32``) and
``jax/_src/random.py`` (``key``, ``fold_in``, ``split``, ``randint``,
``uniform``, ``bernoulli``, ``choice``, ``normal``).  ``lane_keys`` is the serving sampler's key schedule,
``fold_in(PRNGKey(seed), position)`` for a tensor of lanes at once.

A key is a ``(2,)`` int64 tensor holding the two uint32 words of jax's
raw key data, ``jax.random.key_data(k)``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["threefry2x32", "threefry_seed", "key", "fold_in", "split",
           "iota_2x32_shape", "random_bits", "randint", "lane_keys",
           "uniform", "bernoulli", "choice", "normal"]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b`` modulo 2**32 for uint32 ``a`` and ``b``, without leaving
    int64's range."""
    return (a * (b & 0xFFFF) + ((a * (b >> 16) & 0xFFFF) << 16)) & MASK


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash, 20 rounds, of count words ``(x1, x2)``
    under key words ``(k1, k2)`` (broadcast against each other)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK
    return x[0], x[1]


def threefry_seed(seed: int, *, x64: bool = False) -> torch.Tensor:
    """The raw key of integer ``seed``: its 64-bit two's complement split
    into (high word, low word).  jax canonicalises a Python int seed to 32
    bits unless ``jax_enable_x64`` is on, so by default (``x64=False``, as
    the reference runs) the high word is 0 and the low word is ``seed``
    modulo 2**32."""
    s = seed & (2 ** 64 - 1)
    hi = s >> 32 if x64 else 0
    return torch.tensor([hi, s & MASK], dtype=torch.int64)


def key(seed: int, *, x64: bool = False) -> torch.Tensor:
    """``jax.random.key(seed)`` as raw key data (see :func:`threefry_seed`)."""
    return threefry_seed(seed, x64=x64)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the count ``(0, data)`` (``data``
    as uint32) under ``k``."""
    zero = torch.zeros((1,), dtype=torch.int64, device=k.device)
    y1, y2 = threefry2x32(k[0], k[1], zero, zero + (data & MASK))
    return torch.cat([y1, y2])


def iota_2x32_shape(shape: tuple[int, ...], device=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """A row-major 64-bit iota of ``shape`` as (high words, low words)."""
    i = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=device).reshape(shape)
    return i >> 32, i & MASK


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (fold-like): ``(num, 2)`` keys, key ``i`` the
    hash of the 64-bit count ``i`` under ``k``."""
    hi, lo = iota_2x32_shape((num,), k.device)
    y1, y2 = threefry2x32(k[0], k[1], hi, lo)
    return torch.stack([y1, y2], dim=-1)


def random_bits(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element (jax's ``_random_bits`` at bit width 32):
    the two hash words of each element's 64-bit counter, xor-ed."""
    hi, lo = iota_2x32_shape(tuple(shape), k.device)
    y1, y2 = threefry2x32(k[0], k[1], hi, lo)
    return y1 ^ y2


def randint(k: torch.Tensor, shape: tuple[int, ...], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` at its default
    int32 dtype: two draws of 32 bits, ``(hi % span * 2**32 % span + lo %
    span) % span`` in uint32 arithmetic, plus ``minval``."""
    if not -2 ** 31 <= minval <= maxval < 2 ** 31:
        raise ValueError(f"randint takes int32 bounds with minval <= "
                         f"maxval, got [{minval}, {maxval})")
    span = max(maxval - minval, 1)
    k1, k2 = split(k)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    multiplier = (2 ** 16) % span
    multiplier = (multiplier * multiplier & MASK) % span
    offset = _mul32(higher % span, multiplier) + lower % span
    offset = (offset & MASK) % span
    return (offset + minval).to(torch.int32)


def lane_keys(seeds: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """``fold_in(PRNGKey(seed), position)`` for each lane: ``(S, 2)`` keys
    from ``(S,)`` integer seeds and positions.

    A seed is taken modulo 2**32, as ``PRNGKey`` of an int32 seed gives
    the key ``(0, seed mod 2**32)``; the position is folded in as uint32.
    Each lane's key is a function of its own seed and position only."""
    s = seeds.to(torch.int64) & MASK
    p = positions.to(device=s.device, dtype=torch.int64) & MASK
    y1, y2 = threefry2x32(torch.zeros_like(s), s, torch.zeros_like(p), p)
    return torch.stack([y1, y2], dim=-1)


def uniform(k: torch.Tensor, shape: int | tuple[int, ...],
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``.  ``k`` is
    one ``(2,)`` key, or a batch of keys ``(..., 2)``, each drawing its own
    ``shape``: the result is ``(..., *shape)`` float32.

    32 bits per element from :func:`random_bits`' counter layout; the top
    23 become the mantissa of a float in [1, 2) (``bits >> 9 |
    0x3F800000``), less 1; then ``* (maxval - minval) + minval`` and
    ``max(minval, .)``.  XLA fuses the multiply and the add (one
    rounding); the float64 product of two float32 values is exact, so
    the sum taken in float64 and rounded once to float32 is that fused
    result."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    hi, lo = iota_2x32_shape(shape, k.device)
    lead = k.shape[:-1] + (1,) * len(shape)
    y1, y2 = threefry2x32(k[..., 0].reshape(lead), k[..., 1].reshape(lead),
                          hi, lo)
    bits = (y1 ^ y2) >> 9 | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lo_v = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi_v = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    span = (hi_v - lo_v).to(torch.float64)
    y = (f.to(torch.float64) * span + lo_v.to(torch.float64)) \
        .to(torch.float32)
    return torch.maximum(lo_v, y)


def bernoulli(k: torch.Tensor, p: float,
              shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)``: ``uniform < p`` with ``p``
    in float32, a bool tensor."""
    return uniform(k, shape) < torch.tensor(p, dtype=torch.float32,
                                            device=k.device)


def choice(k: torch.Tensor, a: torch.Tensor, shape: tuple[int, ...],
           p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(k, a, shape, p=p)`` (with replacement) for a
    1-d ``a``: the float32 cumulative ``p`` (summed left to right), ``r =
    total * (1 - uniform)``, and the first index whose cumulative sum
    reaches ``r`` (``searchsorted``, left)."""
    pf = p.to(device=k.device, dtype=torch.float32)
    acc = [pf[0]]
    for v in pf[1:]:
        acc.append(acc[-1] + v)
    cum = torch.stack(acc)
    r = cum[-1] * (1 - uniform(k, shape))
    idx = torch.searchsorted(cum, r.reshape(-1)).reshape(r.shape)
    return a.to(k.device)[idx]


# Giles' single-precision erfinv polynomials (XLA's ``ErfInv32``), for
# w = -log1p(-x^2) below 5 and from 5 up
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """The inverse error function as XLA approximates it in float32
    (Giles' polynomials in ``w = -log1p(-x^2)``; +-inf at +-1), so that
    :func:`normal` follows ``jax.random.normal`` to an ulp or so (the
    log1p and the multiply-adds may round differently)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], device=x.device),
                           torch.tensor(_ERFINV_GE5[i], device=x.device))
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.normal(k, shape)`` in float32: ``sqrt(2) * erf_inv(u)``
    with u uniform on ``[nextafter(-1, 0), 1)``.  The draws u are jax's
    bit for bit, and :func:`_erf_inv` is XLA's polynomial, so the values
    agree within an ulp or so, not bit for bit."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(k, shape, lo, 1.0)
    return torch.tensor(math.sqrt(2), dtype=torch.float32,
                        device=k.device) * _erf_inv(u)

"""FSM-based stochastic computing baseline (paper refs [6]-[9], Fig 1).

Port of ``repro.core.fsm_baseline``: the designs the paper improves on.
Values are stochastic bipolar bitstreams (P(bit = 1) = (x + 1) / 2),
multiplication is XNOR, and activation functions are saturating-counter
FSMs run serially over the stream:

* **Stanh** (Brown & Card): a K-state up / down counter whose output bit
  is 1 iff the state is at least K / 2; tanh(K x / 2) in expectation,
  with a variance that decays only as 1 / sqrt(stream length).
* **FSM ReLU** ([9]-style): the same counter; the output bit mirrors the
  input while the state is in the upper half and is the bipolar zero
  code (alternating bits) otherwise.

The FSM is sequential by nature (the paper's point against it): each is
a loop over the stream of vectorised integer ops, the reference's
``lax.scan``, which has no more parallelism.  The streams are
``prng.uniform`` draws, ``jax.random``'s bit for bit under one key.
"""

from __future__ import annotations

import torch

from .. import prng

__all__ = ["stochastic_bitstream", "xnor_multiply", "fsm_stanh", "fsm_relu",
           "decode_bipolar"]


def stochastic_bitstream(x: torch.Tensor, length: int,
                         key: torch.Tensor) -> torch.Tensor:
    """Bipolar stochastic stream of x in [-1, 1]: bit t ~ Bernoulli((x +
    1) / 2); (...,) -> (..., length) int8."""
    p = torch.clamp((x.to(torch.float32) + 1.0) / 2.0, 0.0, 1.0)
    u = prng.uniform(key.to(x.device), tuple(x.shape) + (length,))
    return (u < p[..., None]).to(torch.int8)


def decode_bipolar(bits: torch.Tensor) -> torch.Tensor:
    """The estimate of x: 2 mean(bits) - 1."""
    return 2.0 * torch.mean(bits.to(torch.float32), dim=-1) - 1.0


def xnor_multiply(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """Bipolar SC multiply: the XNOR of independent streams."""
    return (a_bits == b_bits).to(torch.int8)


def fsm_stanh(bits: torch.Tensor, n_states: int = 8) -> torch.Tensor:
    """Stanh over a (..., T) bipolar stream -> (..., T): ``state += bit ?
    +1 : -1`` saturating in ``[0, n_states - 1]``, out bit ``state >=
    n_states / 2``; approximates tanh(n_states / 2 x)."""
    half = n_states // 2
    state = torch.full(bits.shape[:-1], half, dtype=torch.int32,
                       device=bits.device)
    outs = torch.empty(bits.shape, dtype=torch.int8, device=bits.device)
    b = bits.to(torch.int32)
    for t in range(bits.shape[-1]):
        state = torch.clamp(state + 2 * b[..., t] - 1, 0, n_states - 1)
        outs[..., t] = state >= half
    return outs


def fsm_relu(bits: torch.Tensor, n_states: int = 8) -> torch.Tensor:
    """FSM ReLU ([9]): pass the input bit while the running estimate is
    positive, emit the bipolar zero (0, 1, 0, 1, ...) otherwise."""
    half = n_states // 2
    state = torch.full(bits.shape[:-1], half, dtype=torch.int32,
                       device=bits.device)
    outs = torch.empty(bits.shape, dtype=torch.int8, device=bits.device)
    b = bits.to(torch.int32)
    for t in range(bits.shape[-1]):
        state = torch.clamp(state + 2 * b[..., t] - 1, 0, n_states - 1)
        outs[..., t] = torch.where(state >= half, b[..., t], t % 2)
    return outs

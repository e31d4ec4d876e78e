"""Selective Interconnect: accumulation-fused activation (paper §II-B,
Fig 3b, Fig 7).

Port of ``repro.core.si``.  After the BSN the sorted vector is
deterministic (``s[k] = 1`` iff ``count >= k + 1``), so wiring output bit
``j`` to sorted position ``t_j - 1`` realises

    out_count(c) = #{ j : c >= t_j },   t_1 <= t_2 <= ... <= t_Lout

any monotone step function with steps of height one, with routing only.
Input count ``c`` in ``[0, in_max]`` represents ``alpha_in * (c -
in_max/2)``; output count ``o`` in ``[0, out_bsl]`` represents
``alpha_out * (o - zero_point)``, ``zero_point = out_bsl/2`` by default.

The threshold design is numpy (host-side, float64 and int64 as in the
reference); applying the thresholds is torch.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["si_thresholds_from_counts", "si_thresholds", "apply_si_counts",
           "apply_si_bits", "relu_fn", "bn_relu_fn", "tanh_fn",
           "gelu_mono_fn", "silu_mono_fn", "relu2_fn", "identity_fn"]

# argmin locations of the non-monotone activations: below these the SI
# uses the monotone clamp approximation
_GELU_XSTAR = -0.75179
_SILU_XSTAR = -1.27846


# ---------------------------------------------------------------------------
# threshold design (numpy)
# ---------------------------------------------------------------------------

def si_thresholds_from_counts(out_counts: np.ndarray,
                              out_bsl: int) -> np.ndarray:
    """Thresholds from a tabulated monotone ``out_count(c)``, c = 0..in_max.

    Returns int32 ``(out_bsl,)`` with ``t_j`` in ``[0, in_max + 1]``;
    ``t_j = in_max + 1`` means output bit j is constant 0.
    """
    oc = np.asarray(out_counts, dtype=np.int64)
    if np.any(oc[1:] < oc[:-1]):
        raise ValueError("SI target function must be monotone non-decreasing")
    oc = np.clip(oc, 0, out_bsl)
    in_max = oc.shape[0] - 1
    # t_j = min{c : oc[c] >= j}  (searchsorted on the monotone table)
    js = np.arange(1, out_bsl + 1)
    t = np.searchsorted(oc, js, side="left")
    t = np.where(js > oc[-1], in_max + 1, t)
    return t.astype(np.int32)


def si_thresholds(fn: Callable[[np.ndarray], np.ndarray], in_max: int,
                  out_bsl: int, alpha_in: float = 1.0,
                  alpha_out: float = 1.0,
                  zero_point: float | None = None) -> np.ndarray:
    """Design thresholds for a float activation ``fn`` (vectorised,
    monotone): ``value_in = alpha_in * (c - in_max/2)``, ``value_out =
    alpha_out * (o - zero_point)``."""
    if zero_point is None:
        zero_point = out_bsl / 2
    c = np.arange(in_max + 1, dtype=np.float64)
    v = alpha_in * (c - in_max / 2)
    y = np.asarray(fn(v), dtype=np.float64)
    oc = np.clip(np.round(y / alpha_out + zero_point), 0, out_bsl)
    # float rounding can produce 1-ulp non-monotonicity on flat regions
    oc = np.maximum.accumulate(oc)
    return si_thresholds_from_counts(oc.astype(np.int64), out_bsl)


# ---------------------------------------------------------------------------
# application: count-domain form and bit-exact form (torch)
# ---------------------------------------------------------------------------

def apply_si_counts(c: torch.Tensor, thresholds) -> torch.Tensor:
    """``out_count = #{j : c >= t_j}`` (thresholds ascending), int32; the
    same comparison as the fused epilogue of ``ternary_matmul``."""
    t = torch.as_tensor(thresholds, dtype=torch.int32, device=c.device)
    return torch.sum(c[..., None].to(torch.int32) >= t, dim=-1,
                     dtype=torch.int32)


def apply_si_bits(sorted_bits: torch.Tensor, thresholds) -> torch.Tensor:
    """Bit-exact SI: tap sorted wire ``t_j - 1`` (constants at the rails).

    ``sorted_bits``: ``(..., in_max)`` descending thermometer code.
    """
    in_max = sorted_bits.shape[-1]
    t = torch.as_tensor(thresholds, dtype=torch.int32,
                        device=sorted_bits.device)
    pos = torch.clamp(t - 1, 0, in_max - 1).long()
    tapped = sorted_bits[..., pos]
    out = torch.where(t <= 0, torch.ones_like(tapped),
                      torch.where(t >= in_max + 1, torch.zeros_like(tapped),
                                  tapped))
    return out.to(torch.int8)


# ---------------------------------------------------------------------------
# activation builders (float domain, handed to si_thresholds)
# ---------------------------------------------------------------------------

def identity_fn(x: np.ndarray) -> np.ndarray:
    return x


def relu_fn(x: np.ndarray) -> np.ndarray:
    return np.maximum(x, 0.0)


def relu2_fn(x: np.ndarray) -> np.ndarray:
    """Squared ReLU: monotone, exactly SI-realisable."""
    return np.square(np.maximum(x, 0.0))


def bn_relu_fn(gamma: float,
               beta: float) -> Callable[[np.ndarray], np.ndarray]:
    """Paper Eq. 1: ``ReLU(BN(x)) = gamma * (x - beta)`` for ``x >= beta``,
    else 0.  Needs ``gamma > 0`` (a negative gamma is folded into the
    weights' sign at export)."""
    if gamma <= 0:
        raise ValueError("bn_relu_fn requires gamma > 0; fold the sign "
                         "into the upstream weights first")

    def fn(x: np.ndarray) -> np.ndarray:
        return np.where(x >= beta, gamma * (x - beta), 0.0)

    return fn


def tanh_fn(scale: float = 1.0) -> Callable[[np.ndarray], np.ndarray]:
    def fn(x: np.ndarray) -> np.ndarray:
        return np.tanh(x / scale)

    return fn


def _gelu(x: np.ndarray) -> np.ndarray:
    return x * 0.5 * (1.0 + np.tanh(np.sqrt(2 / np.pi)
                                    * (x + 0.044715 * x ** 3)))


def gelu_mono_fn(x: np.ndarray) -> np.ndarray:
    """Monotone clamp of GELU: exact for ``x >= x*`` (-0.7518), flat below."""
    return _gelu(np.maximum(x, _GELU_XSTAR))


def silu_mono_fn(x: np.ndarray) -> np.ndarray:
    """Monotone clamp of SiLU."""
    xc = np.maximum(x, _SILU_XSTAR)
    return xc / (1.0 + np.exp(-xc))

"""Bitonic Sorting Network adders (paper §II-B, §IV).

Port of ``repro.core.bsn``.  The exact adder (Fig 3b) concatenates the
thermometer bitstreams of all addends and bitonic-sorts them: the sorted
vector's popcount is the exact sum.  The approximate spatial adder
(Fig 10b) is a progressive-sorting pipeline: stage ``i`` groups ``g_i``
partial codes, sorts them, clips ``c_i`` bits off each tail and keeps one
of every ``s_i`` bits.  The temporal adder (Fig 12) reuses a small BSN
over ``cycles`` chunks of a wider accumulation.

Each exists as a bit-exact circuit (``*_bits``, compare-exchange
networks on the bits) and in the count domain (``*_counts``, the
oracle).  On the card the networks run in the ``bsn_sort`` kernel and the
count-domain pipelines in the ``approx_bsn`` kernels; :func:`approx_bsn`
is the front door that reaches them through ``kernels.dispatch``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

__all__ = ["bitonic_sort", "exact_bsn_bits", "exact_bsn_counts",
           "SubSampleSpec", "StageSpec", "ApproxBSNSpec",
           "approx_bsn_counts", "approx_bsn_bits", "spatial_temporal_counts",
           "approx_bsn", "default_approx_spec", "spec_stages",
           "approx_bsn_output_bsl", "approx_bsn_scale"]


# ---------------------------------------------------------------------------
# bitonic sort (Batcher 1968) and the exact adder
# ---------------------------------------------------------------------------

def _ceil_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def bitonic_sort(x: torch.Tensor, descending: bool = True) -> torch.Tensor:
    """Sort the trailing axis with Batcher's bitonic network.

    Any dtype with min/max.  A non-power-of-two length is padded with the
    dtype's sentinel (its minimum, or -inf, when descending) and cropped.
    The network runs in the ``bsn_sort`` kernel on a CUDA tensor and in
    its plain PyTorch version on a CPU tensor (``kernels.ops.sort_rows``).
    """
    from ..kernels.ops import sort_rows            # kernels build on core
    n = x.shape[-1]
    m = _ceil_pow2(n)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, n)
    if m != n:
        if x.dtype.is_floating_point:
            pad_val = float("-inf") if descending else float("inf")
        else:
            info = torch.iinfo(x.dtype)
            pad_val = info.min if descending else info.max
        x2 = torch.nn.functional.pad(x2, (0, m - n), value=pad_val)
    out = sort_rows(x2.contiguous(), descending=descending)
    return out[:, :n].reshape(*lead, n)


def exact_bsn_bits(bits: torch.Tensor) -> torch.Tensor:
    """Exact BSN: ``(..., N, L)`` thermometer codes -> ``(..., N*L)``
    sorted descending, again a thermometer code of the exact sum."""
    flat = bits.reshape(*bits.shape[:-2], bits.shape[-2] * bits.shape[-1])
    return bitonic_sort(flat.to(torch.int8), descending=True)


def exact_bsn_counts(counts: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The exact adder in the count domain: the sorted popcount is the sum."""
    return torch.sum(counts, dim=axis, dtype=torch.int32)


# ---------------------------------------------------------------------------
# approximate spatial BSN (paper §IV-B, Fig 10b)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SubSampleSpec:
    """Clip ``clip`` bits from each end of the sorted code, then keep one
    of every ``stride`` bits (phase ``stride // 2`` centres the tap)."""
    clip: int = 0
    stride: int = 1

    def out_len(self, in_len: int) -> int:
        kept = in_len - 2 * self.clip
        if kept <= 0 or kept % self.stride != 0:
            raise ValueError(
                f"sub-sample (clip={self.clip}, stride={self.stride}) "
                f"invalid for BSL {in_len}")
        return kept // self.stride

    @property
    def phase(self) -> int:
        return self.stride // 2

    def apply_counts(self, c: torch.Tensor, in_len: int) -> torch.Tensor:
        """Count-domain semantics: saturate then floor-divide with phase."""
        kept = in_len - 2 * self.clip
        c = torch.clamp(c - self.clip, 0, kept)
        return torch.div(c + self.phase, self.stride, rounding_mode="floor")

    def apply_bits(self, sorted_bits: torch.Tensor) -> torch.Tensor:
        """Bit-domain semantics: tap wires of the sorted vector; output bit
        j taps sorted position ``clip + j*stride + (stride - 1 - phase)``."""
        out_len = self.out_len(sorted_bits.shape[-1])
        pos = (self.clip + torch.arange(out_len, device=sorted_bits.device)
               * self.stride + (self.stride - 1 - self.phase))
        return sorted_bits[..., pos]


@dataclass(frozen=True)
class StageSpec:
    """One progressive-sorting stage: group ``group`` codes, sort, sample."""
    group: int
    sub: SubSampleSpec = field(default_factory=SubSampleSpec)


@dataclass(frozen=True)
class ApproxBSNSpec:
    """``width`` input codes of BSL ``in_bsl`` through ``stages``;
    ``prod(group_i)`` must equal ``width``."""
    width: int
    in_bsl: int
    stages: tuple[StageSpec, ...]

    def __post_init__(self):
        g = math.prod(s.group for s in self.stages)
        if g != self.width:
            raise ValueError(f"prod(groups)={g} != width={self.width}")
        self.layer_bsls()  # validates divisibility

    def layer_bsls(self) -> list[int]:
        """BSL entering each stage, and the output BSL last."""
        bsls = [self.in_bsl]
        for s in self.stages:
            bsls.append(s.sub.out_len(bsls[-1] * s.group))
        return bsls

    @property
    def out_bsl(self) -> int:
        return self.layer_bsls()[-1]

    @property
    def scale(self) -> int:
        """Units per output bit relative to the input (prod of strides)."""
        return math.prod(s.sub.stride for s in self.stages)


def approx_bsn_output_bsl(spec: ApproxBSNSpec) -> int:
    return spec.out_bsl


def approx_bsn_scale(spec: ApproxBSNSpec) -> int:
    return spec.scale


def spec_stages(spec: ApproxBSNSpec) -> tuple[tuple[int, int, int], ...]:
    """ApproxBSNSpec -> the primitive ``(group, clip, stride)`` tuples the
    kernel takes."""
    return tuple((s.group, s.sub.clip, s.sub.stride) for s in spec.stages)


def approx_bsn_counts(counts: torch.Tensor,
                      spec: ApproxBSNSpec) -> torch.Tensor:
    """Count-domain approximate BSN: ``(..., width)`` popcounts in
    ``[0, in_bsl]`` -> the output code's popcount ``(...,)`` int32 in
    ``[0, out_bsl]``; the represented q value is
    ``scale * (out - out_bsl / 2)``."""
    if counts.shape[-1] != spec.width:
        raise ValueError(f"expected width {spec.width}, got "
                         f"{tuple(counts.shape)}")
    c = counts.to(torch.int32)
    bsl = spec.in_bsl
    for s in spec.stages:
        c = c.reshape(*c.shape[:-1], c.shape[-1] // s.group, s.group)
        c = torch.sum(c, dim=-1, dtype=torch.int32)      # sorted popcount
        sorted_len = bsl * s.group
        c = s.sub.apply_counts(c, sorted_len)
        bsl = s.sub.out_len(sorted_len)
    return c.squeeze(-1)


def approx_bsn_bits(bits: torch.Tensor, spec: ApproxBSNSpec) -> torch.Tensor:
    """Bit-exact approximate BSN on ``(..., width, in_bsl)`` codes ->
    ``(..., out_bsl)`` bits."""
    if bits.shape[-2] != spec.width or bits.shape[-1] != spec.in_bsl:
        raise ValueError(f"expected (..., {spec.width}, {spec.in_bsl}), "
                         f"got {tuple(bits.shape)}")
    x = bits
    for s in spec.stages:
        m = x.shape[-2] // s.group
        x = x.reshape(*x.shape[:-2], m, s.group * x.shape[-1])
        x = bitonic_sort(x.to(torch.int8), descending=True)
        x = s.sub.apply_bits(x)
    return x.squeeze(-2)


# ---------------------------------------------------------------------------
# spatial-temporal BSN (paper §IV-B, Fig 12) and the kernel front door
# ---------------------------------------------------------------------------

def spatial_temporal_counts(counts: torch.Tensor, spec: ApproxBSNSpec,
                            cycles: int) -> torch.Tensor:
    """Fold a ``cycles * spec.width`` accumulation onto one small BSN: the
    spatial pipeline on each chunk, the short partial codes summed
    exactly.  The value is ``scale * (out - cycles * out_bsl / 2)``."""
    w = spec.width
    if counts.shape[-1] != cycles * w:
        raise ValueError(f"expected {cycles * w} inputs, got "
                         f"{tuple(counts.shape)}")
    c = counts.reshape(*counts.shape[:-1], cycles, w)
    return torch.sum(approx_bsn_counts(c, spec), dim=-1, dtype=torch.int32)


def approx_bsn(counts: torch.Tensor, spec: ApproxBSNSpec, *,
               cycles: int = 1) -> torch.Tensor:
    """The approximate adder through the kernel dispatch: the semantics of
    :func:`approx_bsn_counts` (``cycles == 1``) or
    :func:`spatial_temporal_counts` (``cycles > 1``), run by the CUDA
    kernels on a CUDA tensor and by their plain versions on the CPU."""
    from ..kernels.dispatch import approx_bsn as run
    return run(counts, spec, cycles=cycles)


def default_approx_spec(width: int, in_bsl: int, *,
                        target_out_bsl: int = 32) -> ApproxBSNSpec:
    """A single-stage spec for a ``width``-wide accumulation: a power-of-two
    stride putting the output BSL near ``target_out_bsl``, then a
    symmetric clip window absorbing the rest of the sorted length."""
    sorted_len = width * in_bsl
    if sorted_len <= target_out_bsl:
        return ApproxBSNSpec(width=width, in_bsl=in_bsl,
                             stages=(StageSpec(width, SubSampleSpec(0, 1)),))
    stride = 1
    while stride * 2 * target_out_bsl <= sorted_len:
        stride *= 2
    # symmetric clipping needs kept == sorted_len (mod 2); an even stride
    # makes kept even, so an odd sorted length forces stride 1
    if sorted_len % 2 and stride > 1:
        stride = 1
    out_bsl = min(target_out_bsl, sorted_len // stride)
    if (sorted_len - out_bsl * stride) % 2:     # only possible at stride 1
        out_bsl += 1 if out_bsl + 1 <= sorted_len else -1
    kept = out_bsl * stride
    return ApproxBSNSpec(
        width=width, in_bsl=in_bsl,
        stages=(StageSpec(width, SubSampleSpec((sorted_len - kept) // 2,
                                               stride)),))

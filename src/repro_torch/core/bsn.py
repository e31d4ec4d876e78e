"""Approximate progressive-sorting BSN adder (paper §IV-B, Fig 10b).

Port of the count-domain half of ``repro.core.bsn``: the design-space
specs, :func:`default_approx_spec` and the count-domain oracle
:func:`approx_bsn_counts`.  Stage ``i`` groups ``g_i`` partial codes,
sorts them (in the count domain: sums them), clips ``c_i`` bits off each
tail and keeps one of every ``s_i`` bits.  The CUDA kernel that runs the
pipeline on the card is ``repro_torch.kernels.approx_bsn``; the serving
path reaches it through ``kernels.dispatch.approx_bsn``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

__all__ = ["SubSampleSpec", "StageSpec", "ApproxBSNSpec",
           "approx_bsn_counts", "default_approx_spec", "spec_stages"]


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

"""Approximate-BSN adder: CUDA kernel wrappers and their plain versions.

Port of ``repro.kernels.approx_bsn``: the spatial ``approx_bsn_pallas``
and the Fig 12 temporal ``approx_bsn_temporal_pallas``.  Stages are
primitive static tuples ``((group, clip, stride), ...)`` so this module
stays free of core imports; ``kernels/dispatch.py`` converts an
``ApproxBSNSpec``.  Both wrappers launch the one kernel of
``csrc/approx_bsn.cu`` (the spatial adder is one cycle) and count their
launches apart, as ``approx_bsn`` and ``approx_bsn_temporal``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import kernel_op, launch, on_card, stream_of

__all__ = ["MAX_STAGES", "validate_stages", "approx_bsn_plain",
           "approx_bsn_temporal_plain", "approx_bsn_cuda",
           "approx_bsn_temporal_cuda"]

Stages = tuple[tuple[int, int, int], ...]

MAX_STAGES = 8                  # csrc/approx_bsn.cu's fixed argument size


def validate_stages(width: int, in_bsl: int, stages: Stages) -> int:
    """Static shape-check of a primitive stage tuple; returns out_bsl."""
    n, bsl = width, in_bsl
    prod_g = 1
    for group, clip, stride in stages:
        prod_g *= group
        if n % group:
            raise ValueError(f"group {group} does not divide width {n}")
        n //= group
        sorted_len = bsl * group
        kept = sorted_len - 2 * clip
        if kept <= 0 or kept % stride:
            raise ValueError(f"clip={clip}, stride={stride} invalid for "
                             f"sorted length {sorted_len}")
        bsl = kept // stride
    if prod_g != width:
        raise ValueError(f"prod(groups)={prod_g} != width={width}")
    return bsl


def approx_bsn_plain(counts: torch.Tensor, *, in_bsl: int,
                     stages: Stages) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``(R, width)`` int popcounts
    -> ``(R,)`` int32, stage by stage as the kernel runs it."""
    validate_stages(counts.shape[-1], in_bsl, stages)
    x = counts.to(torch.int32)
    bsl = in_bsl
    for group, clip, stride in stages:
        x = x.reshape(*x.shape[:-1], x.shape[-1] // group, group)
        x = torch.sum(x, dim=-1, dtype=torch.int32)
        kept = bsl * group - 2 * clip
        # clamp unconditionally, as the reference does even with clip=0
        x = torch.clamp(x - clip, 0, kept)
        if stride > 1:
            x = torch.div(x + stride // 2, stride, rounding_mode="floor")
        bsl = kept // stride
    return x[..., 0]


def approx_bsn_temporal_plain(counts: torch.Tensor, *, in_bsl: int,
                              stages: Stages, cycles: int) -> torch.Tensor:
    """The temporal kernel's function: ``(R, cycles * width)`` -> ``(R,)``
    int32, the spatial pipeline on each chunk, the outputs summed."""
    rows, total = counts.shape
    if cycles < 1 or total % cycles:
        raise ValueError(f"{total} counts do not split into {cycles} "
                         f"cycles")
    per_chunk = approx_bsn_plain(counts.reshape(rows * cycles,
                                                total // cycles),
                                 in_bsl=in_bsl, stages=stages)
    return torch.sum(per_chunk.reshape(rows, cycles), dim=-1,
                     dtype=torch.int32)


def _launch(kernel: str, counts: torch.Tensor, in_bsl: int, stages: Stages,
            cycles: int) -> torch.Tensor:
    if not on_card(counts):
        raise ValueError(f"{kernel}_cuda needs a CUDA tensor")
    if counts.dtype != torch.int32 or counts.ndim != 2:
        raise ValueError(f"counts must be (R, cycles * width) int32, got "
                         f"{tuple(counts.shape)} {counts.dtype}")
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    if not 1 <= len(stages) <= MAX_STAGES:
        raise ValueError(f"the kernel takes 1..{MAX_STAGES} stages, "
                         f"got {len(stages)}")
    rows, total = counts.shape
    if cycles < 1 or total % cycles:
        raise ValueError(f"{total} counts do not split into {cycles} "
                         f"cycles")
    width = total // cycles
    validate_stages(width, in_bsl, stages)
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows exceed one launch's grid")
    return _approx_op(counts, in_bsl, [v for st in stages for v in st],
                      cycles, kernel == "approx_bsn_temporal")


def _approx_out(counts, *_):
    return torch.empty((counts.shape[0],), dtype=torch.int32,
                       device=counts.device)


@kernel_op("approx_bsn", _approx_out)
def _approx_op(counts: torch.Tensor, in_bsl: int, flat: list[int],
               cycles: int, temporal: bool) -> torch.Tensor:
    rows, total = counts.shape
    out = _approx_out(counts)
    if rows == 0:
        return out
    arr = (ctypes.c_int * len(flat))(*flat)
    launch("approx_bsn_temporal" if temporal else "approx_bsn",
           "approx_bsn_launch", counts.data_ptr(), out.data_ptr(), rows,
           total // cycles, cycles, in_bsl, arr, len(flat) // 3,
           stream_of(counts))
    return out


def approx_bsn_cuda(counts: torch.Tensor, *, in_bsl: int,
                    stages: Stages) -> torch.Tensor:
    """Launch ``csrc/approx_bsn.cu`` on ``(R, width)`` int32 counts on the
    card; returns ``(R,)`` int32.  Raises on anything the kernel does not
    take."""
    return _launch("approx_bsn", counts, in_bsl, stages, 1)


def approx_bsn_temporal_cuda(counts: torch.Tensor, *, in_bsl: int,
                             stages: Stages, cycles: int) -> torch.Tensor:
    """Launch the temporal adder on ``(R, cycles * width)`` int32 counts on
    the card; returns ``(R,)`` int32, the chunks' outputs summed."""
    return _launch("approx_bsn_temporal", counts, in_bsl, stages, cycles)

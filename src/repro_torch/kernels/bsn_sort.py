"""The exact BSN's bitonic sorting network: CUDA wrapper and plain version.

Port of ``repro.kernels.bsn_sort`` (``bsn_sort_pallas``): each row of an
``(R, L)`` tensor, L a power of two, sorted by Batcher's compare-exchange
network.  The kernel source is ``csrc/bsn_sort.cu``; it takes int8, int32
and float32.  ``kernels.ops.bsn_sort`` (zero padding, the exact BSN's
front door) and ``core.bsn.bitonic_sort`` (sentinel padding) reach it
through ``kernels.ops.sort_rows``.
"""

from __future__ import annotations

import torch

from .build import kernel_op, launch, on_card, stream_of

__all__ = ["SORT_DTYPES", "bsn_sort_plain", "bsn_sort_cuda"]

# the dtype codes csrc/bsn_sort.cu takes
SORT_DTYPES = {torch.int8: 0, torch.int32: 1, torch.float32: 2}


def _check_length(length: int) -> None:
    if length < 1 or length & (length - 1):
        raise ValueError(f"the row length must be a power of two, got "
                         f"{length}")


def bsn_sort_plain(x: torch.Tensor, *, descending: bool = True
                   ) -> torch.Tensor:
    """The kernel's network in plain PyTorch on ``(R, L)``: at level
    ``(k, j)`` each pair ``(i, i + j)`` of a ``2j``-block keeps the larger
    value first where bit ``k`` of the block's start is 0 (descending)."""
    rows, length = x.shape
    _check_length(length)
    k = 2
    while k <= length:
        j = k // 2
        while j >= 1:
            blocks = length // (2 * j)
            xr = x.reshape(rows, blocks, 2, j)
            a, b = xr[:, :, 0, :], xr[:, :, 1, :]
            starts = torch.arange(blocks, device=x.device) * (2 * j)
            up = (starts & k) == 0
            keep_hi = (up if descending else ~up)[None, :, None]
            hi, lo = torch.maximum(a, b), torch.minimum(a, b)
            first = torch.where(keep_hi, hi, lo)
            second = torch.where(keep_hi, lo, hi)
            x = torch.stack([first, second], dim=2).reshape(rows, length)
            j //= 2
        k *= 2
    return x


def bsn_sort_cuda(x: torch.Tensor, *, descending: bool = True
                  ) -> torch.Tensor:
    """Launch ``csrc/bsn_sort.cu`` on ``(R, L)`` rows on the card.  Raises
    on anything the kernel does not take (a row above a block's shared
    memory is refused at launch with the byte count)."""
    if not on_card(x):
        raise ValueError("bsn_sort_cuda needs a CUDA tensor")
    if x.dtype not in SORT_DTYPES:
        raise ValueError(f"bsn_sort takes int8, int32 or float32, got "
                         f"{x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (R, L) tensor, got "
                         f"{tuple(x.shape)}")
    rows, length = x.shape
    _check_length(length)
    if rows >= 2 ** 31 or length >= 2 ** 31:
        raise ValueError(f"{tuple(x.shape)} exceeds one launch")
    return _sort_op(x, bool(descending))


def _sort_out(x, descending):
    return torch.empty_like(x)


@kernel_op("bsn_sort", _sort_out)
def _sort_op(x: torch.Tensor, descending: bool) -> torch.Tensor:
    rows, length = x.shape
    out = torch.empty_like(x)
    launch("bsn_sort", "bsn_sort_launch", x.data_ptr(), out.data_ptr(),
           rows, length, SORT_DTYPES[x.dtype], int(descending), stream_of(x))
    return out

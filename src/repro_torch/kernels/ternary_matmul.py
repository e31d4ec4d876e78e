"""The SC integer datapath kernel: CUDA wrapper.

Port of ``repro.kernels.ternary_matmul`` (``ternary_matmul_pallas``):
int8 activation levels ``(M, K)`` x int8 ternary weights ``(K, N)`` ->
int32 sums, optionally through the fused SI epilogue ``#{j : sum >=
t[n, j]} - out_bsl // 2``.  The kernel source is
``csrc/ternary_matmul.cu``; its plain version is
``kernels.ref.ternary_matmul_ref``, and ``kernels.ops.ternary_matmul`` is
the front door (batching, ragged shapes, the device rule).
"""

from __future__ import annotations

import torch

from .build import launch, stream_of

__all__ = ["DP4A_MAX_ROWS", "operand_multiple", "ternary_matmul_cuda"]

# csrc/ternary_matmul.cu: up to this many rows run the dp4a kernel (K and
# N multiples of 4), more rows the tensor-core kernel (multiples of 16)
DP4A_MAX_ROWS = 16


def operand_multiple(m: int) -> int:
    """The multiple K and N must have for the kernel that ``m`` rows run."""
    return 4 if m <= DP4A_MAX_ROWS else 16


def ternary_matmul_cuda(x_q: torch.Tensor, w_int: torch.Tensor,
                        thresholds_q: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Launch ``csrc/ternary_matmul.cu``: ``x_q (M, K)`` int8 @ ``w_int
    (K, N)`` int8 -> ``(M, N)`` int32, with the SI epilogue when
    ``thresholds_q (N, out_bsl)`` int32 (q domain) is given.  K and N must
    be multiples of :func:`operand_multiple` ``(M)`` (``ops.ternary_matmul``
    pads) and ``out_bsl`` at most 32.  Raises on anything the kernel does
    not take (the C entry point checks the multiples and alignment)."""
    si = thresholds_q is not None
    if not (x_q.is_cuda and w_int.is_cuda
            and (not si or thresholds_q.is_cuda)):
        raise ValueError("ternary_matmul_cuda needs CUDA tensors")
    if x_q.dtype != torch.int8 or w_int.dtype != torch.int8:
        raise ValueError(f"x_q and w_int must be int8, got {x_q.dtype} and "
                         f"{w_int.dtype}")
    if x_q.ndim != 2 or w_int.ndim != 2 or x_q.shape[1] != w_int.shape[0]:
        raise ValueError(f"expected x_q (M, K) and w_int (K, N), got "
                         f"{tuple(x_q.shape)} and {tuple(w_int.shape)}")
    if not (x_q.is_contiguous() and w_int.is_contiguous()
            and (not si or thresholds_q.is_contiguous())):
        raise ValueError("ternary_matmul_cuda needs contiguous tensors")
    m, k = x_q.shape
    n = w_int.shape[1]
    out_bsl = 0
    if si:
        if (thresholds_q.dtype != torch.int32 or thresholds_q.ndim != 2
                or thresholds_q.shape[0] != n):
            raise ValueError(f"thresholds_q must be ({n}, out_bsl) int32, "
                             f"got {tuple(thresholds_q.shape)} "
                             f"{thresholds_q.dtype}")
        out_bsl = thresholds_q.shape[1]
    if m >= 2 ** 31 or n >= 2 ** 31 or k >= 2 ** 31:
        raise ValueError(f"shape ({m}, {k}) x ({k}, {n}) exceeds int32 "
                         f"indexing")
    out = torch.empty((m, n), dtype=torch.int32, device=x_q.device)
    if m == 0 or n == 0:
        return out
    launch("ternary_matmul", "ternary_matmul_launch", x_q.data_ptr(),
           w_int.data_ptr(), thresholds_q.data_ptr() if si else None,
           out.data_ptr(), m, n, k, out_bsl, stream_of(x_q))
    return out

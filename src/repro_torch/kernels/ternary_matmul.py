"""The SC integer datapath kernel: CUDA wrapper.

Port of ``repro.kernels.ternary_matmul`` (``ternary_matmul_pallas``):
int8 activation levels ``(M, K)`` x int8 ternary weights ``(K, N)`` ->
int32 sums, optionally through the fused SI epilogue ``#{j : sum >=
t[n, j]} - out_bsl // 2``; or a batch of E such products (the MoE
experts') in one launch.  The kernel source is
``csrc/ternary_matmul.cu``; its plain version is
``kernels.ref.ternary_matmul_ref``, and ``kernels.ops.ternary_matmul`` is
the front door (batching, ragged shapes, the device rule).
"""

from __future__ import annotations

import torch

from .build import kernel_op, launch, on_card, stream_of

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
    ``thresholds_q (N, out_bsl)`` int32 (q domain) is given; or E products
    in one launch, ``x_q (E, M, K)`` @ ``w_int (E, K, N)`` -> ``(E, M, N)``
    (no SI).  K and N must be multiples of :func:`operand_multiple`
    ``(M)`` (``ops.ternary_matmul`` pads) and ``out_bsl`` at most 32.
    Raises on anything the kernel does not take (the C entry point checks
    the multiples and alignment)."""
    si = thresholds_q is not None
    if not (on_card(x_q) and on_card(w_int)
            and (not si or on_card(thresholds_q))):
        raise ValueError("ternary_matmul_cuda needs CUDA tensors")
    if x_q.dtype != torch.int8 or w_int.dtype != torch.int8:
        raise ValueError(f"x_q and w_int must be int8, got {x_q.dtype} and "
                         f"{w_int.dtype}")
    batched = x_q.ndim == 3
    if (x_q.ndim not in (2, 3) or w_int.ndim != x_q.ndim
            or x_q.shape[-1] != w_int.shape[-2]
            or (batched and x_q.shape[0] != w_int.shape[0])):
        raise ValueError(f"expected x_q (M, K) and w_int (K, N), or (E, M, "
                         f"K) and (E, K, N), got {tuple(x_q.shape)} and "
                         f"{tuple(w_int.shape)}")
    if not (x_q.is_contiguous() and w_int.is_contiguous()
            and (not si or thresholds_q.is_contiguous())):
        raise ValueError("ternary_matmul_cuda needs contiguous tensors")
    e = x_q.shape[0] if batched else 1
    m, k = x_q.shape[-2:]
    n = w_int.shape[-1]
    out_bsl = 0
    if si:
        if batched:
            raise ValueError("the SI epilogue takes one product, not a "
                             "batch of them")
        if (thresholds_q.dtype != torch.int32 or thresholds_q.ndim != 2
                or thresholds_q.shape[0] != n):
            raise ValueError(f"thresholds_q must be ({n}, out_bsl) int32, "
                             f"got {tuple(thresholds_q.shape)} "
                             f"{thresholds_q.dtype}")
        out_bsl = thresholds_q.shape[1]
    if max(e, m, n, k) >= 2 ** 31:
        raise ValueError(f"shape {tuple(x_q.shape)} x {tuple(w_int.shape)} "
                         f"exceeds int32 indexing")
    return _ternary_op(x_q, w_int, thresholds_q)


def _ternary_out(x_q, w_int, thresholds_q):
    return torch.empty((*x_q.shape[:-1], w_int.shape[-1]),
                       dtype=torch.int32, device=x_q.device)


@kernel_op("ternary_matmul", _ternary_out)
def _ternary_op(x_q: torch.Tensor, w_int: torch.Tensor,
                thresholds_q: torch.Tensor | None) -> torch.Tensor:
    si, batched = thresholds_q is not None, x_q.ndim == 3
    e = x_q.shape[0] if batched else 1
    m, k = x_q.shape[-2:]
    n = w_int.shape[-1]
    out_bsl = thresholds_q.shape[1] if si else 0
    out = _ternary_out(x_q, w_int, thresholds_q)
    if out.numel() == 0:
        return out
    launch("ternary_matmul_batched" if batched else "ternary_matmul",
           "ternary_matmul_launch", x_q.data_ptr(),
           w_int.data_ptr(), thresholds_q.data_ptr() if si else None,
           out.data_ptr(), e, m, n, k, out_bsl, stream_of(x_q))
    return out

"""SC-quantized layers: the paper's integer datapath on torch tensors.

Port of the serving half of ``repro.core.sc_layers``: the quantization
config, the exact integer datapath (:func:`sc_linear_int`), the one
through the approximate BSN adder (:func:`sc_linear_int_approx`, whose
accumulator is the CUDA kernel on the card), the on-the-fly QAT ->
integer bridge every projection uses when serving ``sc_int``
(:func:`sc_linear_int_from_qat`) and the SI threshold epilogue.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .bsn import ApproxBSNSpec, default_approx_spec

__all__ = ["SCQuantConfig", "SC_OFF", "COUNTS_BUDGET_BYTES",
           "sc_linear_int", "sc_linear_int_approx", "sc_linear_int_from_qat"]

# the approximate adder's (rows, N, K) int32 count tensor is formed one
# block of rows at a time so it never exceeds this many bytes (rows are
# independent, so blocking changes no bit)
COUNTS_BUDGET_BYTES = 1 << 30

# float32 carries every integer below 2**24 exactly
_F32_EXACT = 1 << 24


@dataclass(frozen=True)
class SCQuantConfig:
    """Per-model SC quantization settings (paper notation W-A-R/BSL)."""
    mode: str = "none"              # none | sc_qat | sc_int
    weight_bsl: int = 2             # ternary weights
    act_bsl: int = 8                # datapath activation BSL
    resid_bsl: int = 16             # high-precision residual BSL
    per_channel: bool = True        # per-output-channel weight scales
    # sc_int only: accumulate through the approximate BSN adder
    int_approx: bool = False

    @property
    def enabled(self) -> bool:
        return self.mode != "none"

    @property
    def act_half(self) -> int:
        return self.act_bsl // 2

    @property
    def resid_half(self) -> int:
        return self.resid_bsl // 2


SC_OFF = SCQuantConfig(mode="none")


def _si_epilogue(int_params: dict, sum_q: torch.Tensor) -> torch.Tensor:
    """Optional SI threshold activation on accumulated q-domain sums:
    ``#{j : sum_q + sum_max >= t[c, j]} - out_bsl // 2``."""
    thresholds = int_params.get("thresholds")
    if thresholds is None:
        return sum_q
    t = torch.as_tensor(thresholds, dtype=torch.int32,
                        device=sum_q.device)          # (C or 1, out_bsl)
    counts = sum_q + int(int_params["sum_max"])        # count domain
    out_counts = torch.sum(counts[..., None] >= t, dim=-1, dtype=torch.int32)
    return out_counts - t.shape[-1] // 2


def _exact_int_sum(x_q: torch.Tensor, w_int: torch.Tensor) -> torch.Tensor:
    """``x_q @ w_int`` in int32, through a float32 matmul.

    CUDA ``torch.matmul`` has no int32 product.  With int8 levels against
    ternary weights every partial sum is an integer of magnitude at most
    ``K * 128``; below ``2**24`` float32 holds each one exactly, so the
    product is exact in any summation order, provided the matmul really
    runs in float32 (TF32 keeps 10 mantissa bits).
    """
    k = x_q.shape[-1]
    if k * 128 >= _F32_EXACT:
        raise ValueError(f"K={k} is too wide for an exact float32 sum")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("sc_int needs exact float32 products: turn "
                           "torch.backends.cuda.matmul.allow_tf32 off")
    y = torch.matmul(x_q.to(torch.float32), w_int.to(torch.float32))
    return torch.round(y).to(torch.int32)


def sc_linear_int(int_params: dict, x_q: torch.Tensor) -> torch.Tensor:
    """Integer datapath: int8 levels ``x_q (..., K)`` @ ternary int8
    ``w_int (K, N)`` -> int32 sums (== the exact BSN's popcount), then the
    optional SI epilogue."""
    return _si_epilogue(int_params, _exact_int_sum(x_q, int_params["w_int"]))


def sc_linear_int_approx(int_params: dict, x_q: torch.Tensor, act_bsl: int,
                         spec: ApproxBSNSpec | None = None) -> torch.Tensor:
    """Integer datapath through the paper's approximate BSN adder.

    Per output channel the ``K`` partial products ``x_q[k] * w[k, n]``
    (levels in ``[-act_bsl/2, act_bsl/2]``) enter the adder as counts
    ``x_q * w + act_bsl/2``; the compressed output code is rescaled by
    ``spec.scale`` back to the q domain, then the SI epilogue applies.
    The counts are formed directly in the ``(rows, N, K)`` layout the
    adder reads, one block of rows at a time under
    :data:`COUNTS_BUDGET_BYTES`.
    """
    from ..kernels.dispatch import approx_bsn      # kernels build on core
    w_int = int_params["w_int"]
    k, n = w_int.shape
    if spec is None:
        spec = default_approx_spec(k, act_bsl)
    if spec.width != k:
        raise ValueError(f"spec.width={spec.width} != K={k}")
    if spec.in_bsl != act_bsl:
        raise ValueError(f"spec.in_bsl={spec.in_bsl} != act_bsl={act_bsl}")
    half = act_bsl // 2
    batch = x_q.shape[:-1]
    x2 = x_q.reshape(-1, k).to(torch.int32)
    w_t = w_int.to(torch.int32).t().contiguous()        # (N, K)
    block = max(1, COUNTS_BUDGET_BYTES // (4 * n * k))
    out = torch.empty((x2.shape[0], n), dtype=torch.int32,
                      device=x_q.device)
    for r0 in range(0, x2.shape[0], block):
        xb = x2[r0:r0 + block]
        counts = xb[:, None, :] * w_t[None]             # (b, N, K)
        counts += half
        out[r0:r0 + block] = approx_bsn(counts, spec)
    sum_q = spec.scale * (out - spec.out_bsl // 2)
    return _si_epilogue(int_params, sum_q.reshape(*batch, n))


def sc_linear_int_from_qat(params: dict, x: torch.Tensor,
                           cfg: SCQuantConfig) -> torch.Tensor:
    """Run a QAT linear (``w/alpha_w/alpha_a``) on the integer datapath.

    Activations and weights quantize to their integer codes exactly as
    the fake-quant forward rounds them (alpha cast to the activation
    dtype before the divide), the accumulation runs int8 x ternary ->
    int32 (or the approximate adder under ``cfg.int_approx``), and the
    result rescales back to the float residual stream in ``x.dtype``.
    """
    half = cfg.act_half
    aa = params["alpha_a"].to(x.dtype)
    aw = params["alpha_w"].to(torch.float32)
    x_q = torch.clamp(torch.round(x / aa), -half, half).to(torch.int8)
    w = params["w"].to(torch.float32)
    w_int = torch.clamp(torch.round(w / aw), -1, 1).to(torch.int8)
    int_params = {"w_int": w_int}
    if cfg.int_approx:
        sum_q = sc_linear_int_approx(int_params, x_q, cfg.act_bsl)
    else:
        sum_q = sc_linear_int(int_params, x_q)
    y = sum_q.to(torch.float32) * (aa.to(torch.float32)
                                   * torch.atleast_1d(aw))
    return y.to(x.dtype)

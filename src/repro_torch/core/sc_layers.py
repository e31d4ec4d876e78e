"""SC-quantized layers: the paper's datapath on torch tensors.

Port of ``repro.core.sc_layers``: the quantization config, the QAT view
(:func:`sc_linear_qat`, :func:`sc_residual_quant`), the export of a QAT
linear to its deployable integer form (:func:`export_sc_linear`: ternary
int8 weights and SI threshold tables), the exact integer datapath
(:func:`sc_linear_int`, carried by the ``ternary_matmul`` kernel on the
card), the one through the approximate BSN adder
(:func:`sc_linear_int_approx`, spatial or temporal, whose accumulator is
the ``approx_bsn`` kernel on the card), the on-the-fly QAT -> integer
bridge every projection uses when serving ``sc_int``
(:func:`sc_linear_int_from_qat`) and the SI threshold epilogue.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from . import si as si_mod
from .bsn import ApproxBSNSpec, default_approx_spec
from .quant import (lsq_fake_quant, ternary_weight_init_alpha,
                    ternary_weight_quant, thermometer_act_quant)

__all__ = ["SCQuantConfig", "SC_OFF", "COUNTS_BUDGET_BYTES",
           "init_sc_linear", "sc_linear_qat", "sc_residual_quant",
           "export_sc_linear", "sc_linear_int", "sc_linear_int_approx",
           "sc_linear_int_from_qat"]

# the approximate adder's (rows, N, K) int32 count tensor is formed one
# block of rows at a time so it never exceeds this many bytes (rows are
# independent, so blocking changes no bit)
COUNTS_BUDGET_BYTES = 1 << 30


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

    def with_mode(self, mode: str) -> "SCQuantConfig":
        return dataclasses.replace(self, mode=mode)


SC_OFF = SCQuantConfig(mode="none")


# ---------------------------------------------------------------------------
# parameter init and the QAT view
# ---------------------------------------------------------------------------

def init_sc_linear(generator: torch.Generator, in_dim: int, out_dim: int,
                   cfg: SCQuantConfig, w_init_scale: float | None = None,
                   dtype: torch.dtype = torch.float32,
                   device: str | torch.device | None = None) -> dict:
    """Linear params and LSQ scales, ``w`` stored ``(in_dim, out_dim)``,
    shaped and scaled as the reference's ``init_sc_linear`` (the values
    come from ``generator``, not from a JAX key; carry the reference's
    values over with ``weights.tree_to_torch``)."""
    dev = resolve_device(device)
    scale = (w_init_scale if w_init_scale is not None
             else 1.0 / math.sqrt(in_dim))
    w = torch.randn((in_dim, out_dim), generator=generator, device=dev,
                    dtype=dtype) * scale
    params = {"w": w}
    if cfg.enabled:
        if cfg.per_channel:
            aw = torch.clamp(1.4 * torch.mean(torch.abs(w), dim=0),
                             min=1e-8)
        else:
            aw = ternary_weight_init_alpha(w)
        params["alpha_w"] = aw.to(torch.float32)
        # activation scale initialised for unit-variance inputs
        params["alpha_a"] = torch.tensor(
            2.0 / math.sqrt(max(cfg.act_half, 1)), dtype=torch.float32,
            device=dev)
    return params


def sc_linear_qat(params: dict, x: torch.Tensor,
                  cfg: SCQuantConfig) -> torch.Tensor:
    """Fake-quant linear: quantize activations and weights, product in the
    compute dtype; with quantization off a plain product."""
    w = params["w"]
    if not cfg.enabled:
        return x @ w
    x_fq = thermometer_act_quant(x, params["alpha_a"], cfg.act_bsl)
    w_fq = ternary_weight_quant(w, params["alpha_w"])
    return x_fq.to(x.dtype) @ w_fq.to(x.dtype)


def sc_residual_quant(r: torch.Tensor, alpha_r: torch.Tensor,
                      cfg: SCQuantConfig) -> torch.Tensor:
    """High-precision residual fake-quant (16-bit BSL by default, §III)."""
    if not cfg.enabled:
        return r
    return lsq_fake_quant(r, alpha_r, -cfg.resid_half, cfg.resid_half)


# ---------------------------------------------------------------------------
# the integer (silicon-equivalent) path
# ---------------------------------------------------------------------------

def export_sc_linear(params: dict, cfg: SCQuantConfig,
                     act_fn: Callable[[np.ndarray], np.ndarray] | None = None,
                     out_bsl: int | None = None,
                     alpha_out: float | None = None) -> dict:
    """Quantize trained params into the deployable integer form.

    Returns ``{"w_int": int8 (in, out), "alpha_w", "alpha_a": float,
    "thresholds": int32 (C or 1, out_bsl) or None, "alpha_out"}`` (plus
    ``"sum_max"`` with an activation), tensors on ``w``'s device.  The SI
    thresholds realise ``act_fn`` on the accumulated integer sum, whose
    value is ``alpha_a * alpha_w * sum_q``; per-channel weight scales get
    per-channel tables.  The threshold design is the reference's numpy
    code (:mod:`si`), fed the same float32 scales.
    """
    w = torch.as_tensor(params["w"]).to(torch.float32)
    aw = torch.as_tensor(params["alpha_w"]).to(torch.float32).to(w.device)
    aa = float(params["alpha_a"])
    w_int = torch.clamp(torch.round(w / aw), -1, 1).to(torch.int8)
    out = {"w_int": w_int, "alpha_w": aw, "alpha_a": aa, "thresholds": None,
           "alpha_out": None}
    if act_fn is not None:
        if out_bsl is None or alpha_out is None:
            raise ValueError("SI epilogue needs out_bsl and alpha_out")
        sum_max = w.shape[0] * cfg.act_half    # |sum_q| <= in_dim * L/2
        aw_vec = np.atleast_1d(aw.cpu().numpy())
        tables = [si_mod.si_thresholds(act_fn, 2 * sum_max, out_bsl,
                                       alpha_in=float(a) * aa,
                                       alpha_out=alpha_out)
                  for a in aw_vec]
        out["thresholds"] = torch.from_numpy(np.stack(tables)).to(w.device)
        out["alpha_out"] = alpha_out
        out["sum_max"] = sum_max
    return out


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


def sc_linear_int(int_params: dict, x_q: torch.Tensor) -> torch.Tensor:
    """Integer datapath: int8 levels ``x_q (..., K)`` @ ternary int8
    ``w_int (K, N)`` -> int32 sums (== the exact BSN's popcount), through
    ``kernels.ops.ternary_matmul`` (the kernel on the card).

    With SI thresholds (count domain, ``(C or 1, out_bsl)``, and
    ``sum_max``) the epilogue is fused into the kernel: ``sum_q + sum_max
    >= t`` is ``sum_q >= t - sum_max``, so the q-domain table ``t -
    sum_max`` broadcast to ``(N, out_bsl)`` gives the same codes as
    :func:`_si_epilogue` bit for bit.
    """
    from ..kernels.ops import ternary_matmul       # kernels build on core
    w_int = int_params["w_int"]
    if not (isinstance(w_int, torch.Tensor) and w_int.device == x_q.device):
        w_int = torch.as_tensor(w_int, device=x_q.device)
    thresholds = int_params.get("thresholds")
    t_q = None
    if thresholds is not None:
        t = torch.as_tensor(thresholds, device=x_q.device).to(torch.int64)
        t_q = (t - int(int_params["sum_max"])).to(torch.int32)
        t_q = t_q.expand(w_int.shape[1], t_q.shape[-1]).contiguous()
    return ternary_matmul(x_q, w_int, t_q)


def sc_linear_int_approx(int_params: dict, x_q: torch.Tensor, act_bsl: int,
                         spec: ApproxBSNSpec | None = None, *,
                         cycles: int = 1) -> torch.Tensor:
    """Integer datapath through the paper's approximate BSN adder.

    Per output channel the ``K`` partial products ``x_q[k] * w[k, n]``
    (levels in ``[-act_bsl/2, act_bsl/2]``) enter the adder as counts
    ``x_q * w + act_bsl/2``; the compressed output code is rescaled by
    ``spec.scale`` back to the q domain, then the SI epilogue applies.
    ``spec`` defaults to :func:`default_approx_spec` of ``K // cycles``;
    with ``cycles > 1`` the temporal adder folds ``cycles * spec.width ==
    K`` inputs onto the small spatial pipeline.  The counts are formed
    directly in the ``(rows, N, K)`` layout the adder reads, one block of
    rows at a time under :data:`COUNTS_BUDGET_BYTES`.
    """
    from ..kernels.dispatch import approx_bsn      # kernels build on core
    w_int = torch.as_tensor(int_params["w_int"], device=x_q.device)
    k, n = w_int.shape
    if spec is None:
        spec = default_approx_spec(k // cycles, act_bsl)
    if cycles * spec.width != k:
        raise ValueError(f"cycles*width={cycles * spec.width} != K={k}")
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
        out[r0:r0 + block] = approx_bsn(counts, spec, cycles=cycles)
    sum_q = spec.scale * (out - cycles * spec.out_bsl // 2)
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

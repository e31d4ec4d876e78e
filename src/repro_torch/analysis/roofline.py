"""Three-term roofline of one step on an H100, from its counted cost.

Port of ``repro.analysis.roofline``::

    compute    = sum over precisions of operations / the card's peak rate
    memory     = HBM bytes / HBM bandwidth
    collective = bytes a rank gathers / NVLink bandwidth (one direction)

The reference takes its counts from the compiled HLO; the port has none,
so ``analysis/op_cost.py`` counts a step as it runs (aten ops by
``torch.utils.flop_counter``'s formulas and the products' shapes, each
kernel launch from its own formula, the mesh's gathers), and
:func:`roofline_from_step` projects that onto :data:`H100_SXM`.

MODEL_FLOPS is the analytic ``6 N D`` (train) / ``2 N D`` (prefill and
decode) with the active N of a mixture of experts, as the reference's;
MODEL_FLOPS over the counted operations shows what the serving products
(float64 rows, fake quantization) and the datapath add.

:func:`bound` is the least time of a kernel's work: the larger of its
bytes over the memory rate and its operations over the peak rate of
their type.  ``chip_smoke.py`` takes its bounds from it.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass

from ..configs.base import ShapeConfig

__all__ = ["HwSpec", "H100_SXM", "HBM_BPS", "BF16_OPS", "INT8_OPS",
           "FP32_OPS", "FP64_OPS", "StepShape", "RooflineReport", "bound",
           "count_params", "model_flops", "roofline_from_step"]


@dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops_bf16: float      # tensor cores, dense
    peak_flops_int8: float      # tensor cores, dense
    peak_flops_fp32: float      # CUDA cores (also stands for their
                                # integer adds and compares)
    peak_flops_fp64: float      # tensor cores
    hbm_bw: float               # bytes/s
    link_bw: float              # NVLink bytes/s, one direction
    hbm_bytes: float
    source: str

    def rate(self, precision: str) -> float:
        """Peak operations/s of a precision class of ``op_cost``."""
        return {"bf16": self.peak_flops_bf16, "int8": self.peak_flops_int8,
                "fp64": self.peak_flops_fp64}.get(precision,
                                                  self.peak_flops_fp32)


# NVIDIA's published H100 SXM figures (data sheet, dense rates, at the
# 700 W power limit): not measured here.  A card set below 700 W reaches
# less; chip_smoke.py prints the card's limit beside every number.
H100_SXM = HwSpec(name="h100-sxm", peak_flops_bf16=989e12,
                  peak_flops_int8=1979e12, peak_flops_fp32=67e12,
                  peak_flops_fp64=67e12, hbm_bw=3.35e12, link_bw=450e9,
                  hbm_bytes=80 * 2 ** 30,
                  source="NVIDIA H100 SXM data sheet (published, dense)")
HBM_BPS = H100_SXM.hbm_bw
BF16_OPS = H100_SXM.peak_flops_bf16
INT8_OPS = H100_SXM.peak_flops_int8
FP32_OPS = H100_SXM.peak_flops_fp32
FP64_OPS = H100_SXM.peak_flops_fp64


def bound(nbytes: float, ops: float, ops_rate: float,
          hw: HwSpec = H100_SXM) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` (each input read once, each output written once) and
    do ``ops`` operations at ``ops_rate`` operations/s."""
    t_bytes, t_ops = nbytes / hw.hbm_bw * 1e3, ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# analytic parameter / FLOP counts (as the reference's)
# ---------------------------------------------------------------------------

# the reference's ``ShapeConfig`` (a step's sequence length, global batch
# and kind), under the name this module's callers used before the configs
# held it
StepShape = ShapeConfig


def count_params(cfg, active_only: bool = False) -> float:
    """Analytic parameter count (matmul weights; norms and scales
    ignored), the reference's formula on the port's ``ModelConfig``."""
    d, dh = cfg.d_model, cfg.head_dim
    total = 2.0 * cfg.padded_vocab * d              # embed + head
    for spec in cfg.period:
        if spec.mixer == "attn":
            total_l = d * dh * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
        elif spec.mixer == "mamba":
            din, n, r = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.dt_rank
            total_l = d * 2 * din + din * (r + 2 * n) + r * din + din * d
        elif spec.mixer == "rwkv6":
            total_l = 5 * d * d                      # r, k, v, g, o
        else:
            total_l = 0
        if spec.ffn == "dense":
            total_l += d * cfg.d_ff * (3 if cfg.ffn_gated else 2)
        elif spec.ffn == "moe":
            e = cfg.n_experts_per_tok if active_only else cfg.n_experts
            total_l += e * d * cfg.d_ff * (3 if cfg.ffn_gated else 2) \
                + d * cfg.n_experts
        elif spec.ffn == "rwkv_cmix":
            total_l += d * cfg.d_ff * 2 + d * d
        total += total_l * cfg.n_periods
    return total


def model_flops(cfg, shape: StepShape) -> float:
    """6 N_active D train; 2 N_active D forward (decode: D = new tokens)."""
    n_active = count_params(cfg, active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hw: str
    # one rank's counted cost of the step (analysis/op_cost.py)
    flops_by_precision: dict
    hbm_bytes_per_device: float
    wire_bytes_per_device: float
    kernel_launches: dict
    # terms, seconds
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    model_flops_total: float = 0.0
    useful_flops_ratio: float = 0.0
    bottleneck: str = ""
    t_bound: float = 0.0
    roofline_fraction: float = 0.0     # useful model math / t_bound
    measured_s: float | None = None
    bound_share: float = 0.0           # t_bound / measured, when measured
    peak_hbm_bytes: float = 0.0
    fits_hbm: bool = True
    note: str = ""

    def finalize(self, hw: HwSpec) -> "RooflineReport":
        self.t_compute = sum(n / hw.rate(p)
                             for p, n in self.flops_by_precision.items())
        self.t_memory = self.hbm_bytes_per_device / hw.hbm_bw
        self.t_collective = self.wire_bytes_per_device / hw.link_bw
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        self.t_bound = max(terms.values())
        flops = sum(self.flops_by_precision.values())
        if flops > 0:
            self.useful_flops_ratio = (self.model_flops_total
                                       / self.n_chips) / flops
        if self.t_bound > 0:
            useful_t = (self.model_flops_total / self.n_chips) \
                / hw.peak_flops_bf16
            self.roofline_fraction = min(useful_t / self.t_bound, 1.0)
        if self.measured_s:
            self.bound_share = self.t_bound / self.measured_s
        self.fits_hbm = self.peak_hbm_bytes <= hw.hbm_bytes
        return self

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


def roofline_from_step(cost, cfg, shape: StepShape, *, mesh: str = "1",
                       n_chips: int = 1, hw: HwSpec = H100_SXM,
                       measured_s: float | None = None,
                       peak_hbm_bytes: float = 0.0,
                       note: str = "") -> RooflineReport:
    """The roofline of one step from its ``op_cost.StepCost``."""
    rep = RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh, n_chips=n_chips,
        hw=hw.name, flops_by_precision=dict(cost.flops),
        hbm_bytes_per_device=cost.hbm_bytes,
        wire_bytes_per_device=cost.wire_bytes,
        kernel_launches=dict(cost.launches),
        model_flops_total=model_flops(cfg, shape), measured_s=measured_s,
        peak_hbm_bytes=peak_hbm_bytes, note=note)
    return rep.finalize(hw)

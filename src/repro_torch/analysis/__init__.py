"""The port's analysis gates: the kernel audit of the CUDA launch plans,
the hot-path contracts of executed steps, the AST lint, and an H100
roofline (see README.md; ``python -m repro_torch.analysis``)."""

from .contracts import (PassResult, Violation, audit_dtype, audit_host,
                        audit_inplace, audit_retrace, audit_sharding,
                        results_to_json, run_engine_contracts)
from .kernel_audit import (audit_bounds, audit_grid, audit_registers,
                           audit_registry, audit_revisit, audit_smem,
                           run_plan_audits)
from .lint import LintViolation, hygiene_repo, lint_repo, lint_sources
from .roofline import (H100_SXM, HwSpec, RooflineReport, bound,
                       count_params, model_flops, roofline_from_step)

__all__ = ["PassResult", "Violation", "results_to_json", "audit_inplace",
           "audit_retrace", "audit_dtype", "audit_host", "audit_sharding",
           "run_engine_contracts", "audit_bounds", "audit_smem",
           "audit_registers", "audit_grid", "audit_revisit",
           "run_plan_audits", "audit_registry", "LintViolation",
           "lint_repo", "lint_sources", "hygiene_repo", "HwSpec",
           "H100_SXM", "RooflineReport", "bound", "count_params",
           "model_flops", "roofline_from_step"]

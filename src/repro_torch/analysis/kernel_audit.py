"""Auditor of the port's CUDA launches: bounds, shared memory, registers,
grid limits and split partials, from the kernels' launch plans.

Port of ``repro.analysis.kernel_audit``.  A CUDA kernel that reads one
page past the pool returns garbage and raises nothing; a shared-memory
layout above a block's 227 KiB fails only at launch; a 32-bit offset that
wraps reads the wrong row.  None of that shows in a test on the CPU,
where the plain versions run.  This module audits the
:class:`repro_torch.kernels.plan.LaunchPlan` of every registered launch
(``kernels/dispatch.KERNEL_REGISTRY``), whose geometry ``chip_smoke.py``
holds equal to the launchers' C++ (``*_geometry`` entry points).  No
kernel runs.

Passes (each a :class:`~repro_torch.analysis.contracts.PassResult`):

``bounds``     every element range of every operand a block touches lies
               inside the operand, with the scalar operands filled with
               each value of their worst-case model (page tables at 0 and
               ``num_pages - 1``, lengths at 0, ragged, across a split
               and at the table's end), each grid dimension evaluated at
               its extremes and declared interior values.  A proof where
               the ranges are monotone in the block index and the
               scalars (analysis/README.md); the plans add interior
               values where a dimension folds two indices.
``smem``       dynamic plus static shared memory at most ``SMEM_CAP``
               (227 KiB) a block.
``registers``  from the ``ptxas -v`` log of the build: registers x
               threads at most 65536 a block, and no spill loads or
               stores where the plan says the machine code must not use
               local memory; every instance must be in the log.
``grid``       grid.x < 2^31, grid.y and grid.z <= 65535, 1..1024
               threads, every axis positive, and every value the kernel
               computes in 32-bit ``int`` below 2^31.
``revisit``    every split-partial slot written by exactly one block and
               read once by the merge launch, which reads no slot left
               unwritten; an accumulation declaration exactly where a
               launch has more than one split.
"""

from __future__ import annotations

import itertools
import re
from collections import Counter
from pathlib import Path

from ..kernels.plan import SMEM_CAP, LaunchPlan
from .contracts import PassResult, results_to_json

__all__ = ["audit_bounds", "audit_smem", "audit_registers", "audit_grid",
           "audit_revisit", "run_plan_audits", "audit_registry",
           "scalar_sets", "parse_ptxas_log", "SAMPLE_PTXAS_LOG",
           "REGS_PER_BLOCK", "MAX_THREADS", "GRID_X_MAX", "GRID_YZ_MAX",
           "INT32_MAX"]

REGS_PER_BLOCK = 65536       # 32-bit registers an H100 SM (and a block) has
MAX_THREADS = 1024
GRID_X_MAX = 2 ** 31 - 1
GRID_YZ_MAX = 65535
INT32_MAX = 2 ** 31 - 1
_MAX_REPORTED = 3            # violations reported per (pass, operand)

# a `ptxas -v` log of this package's kernels, from a build on the H100
# (kernels/build.py keeps each build's log beside the library)
SAMPLE_PTXAS_LOG = Path(__file__).with_name("ptxas_sample.log")


class Uniform:
    """A scalar array filled with one value: every index reads it, so a
    plan's mirror of an overrunning block still evaluates (its read of
    the scalar operand is what the bounds pass flags)."""

    def __init__(self, value: int, shape: tuple[int, ...]):
        self.value, self.shape = value, shape

    def __getitem__(self, _):
        return self.value


def scalar_sets(plan: LaunchPlan) -> list[dict]:
    """Every combination of the scalar operands' fills, each array filled
    uniformly with one value of its model."""
    if not plan.scalars:
        return [{}]
    fills = [s.fills() for s in plan.scalars]
    return [{s.name: Uniform(v, s.shape)
             for s, v in zip(plan.scalars, combo)}
            for combo in itertools.product(*fills)]


def _fills(arrs: dict) -> dict:
    return {k: v.value for k, v in arrs.items()}


def audit_bounds(label: str, plan: LaunchPlan) -> PassResult:
    """Every range ``[lo, hi)`` an operand's ``access`` gives lies in
    ``[0, numel]``, for every worst-case scalar set and probe block."""
    res = PassResult("bounds", label)
    sets = scalar_sets(plan)
    points = plan.probe_points()
    checked = 0
    reported: Counter = Counter()
    for op in plan.operands:
        for arrs in sets:
            for p in points:
                for lo, hi in op.access(p, arrs):
                    checked += 1
                    if 0 <= lo <= hi <= op.numel:
                        continue
                    reported[op.name] += 1
                    if reported[op.name] <= _MAX_REPORTED:
                        res.fail(
                            f"{plan.kernel} operand {op.name}: block {p} "
                            f"{'writes' if op.write else 'reads'} elements "
                            f"[{lo}, {hi}) outside its {op.numel} with "
                            f"scalars {_fills(arrs)}")
    over = sum(max(0, n - _MAX_REPORTED) for n in reported.values())
    if over:
        res.fail(f"...and {over} more out-of-bounds ranges")
    res.notes.append(f"{checked} ranges over {len(points)} probe blocks x "
                     f"{len(sets)} scalar set(s)")
    return res


def audit_smem(label: str, plan: LaunchPlan, *,
               static: int | None = None) -> PassResult:
    """Dynamic plus static shared memory of a block at most SMEM_CAP;
    ``static`` from the ptxas log where there is one, else the plan's."""
    res = PassResult("smem", label)
    st = plan.static_smem if static is None else static
    total = plan.smem + st
    if total > SMEM_CAP:
        res.fail(f"{plan.kernel}: {plan.smem} B dynamic + {st} B static "
                 f"shared memory a block, above the {SMEM_CAP} B a block "
                 "can have")
    res.notes.append(f"smem {plan.smem} + {st} static of {SMEM_CAP}")
    return res


# ---------------------------------------------------------------------------
# ptxas -v
# ---------------------------------------------------------------------------

_ENTRY = re.compile(r"(?:Compiling entry function|Function properties "
                    r"for)\s+'?([\w$]+)'?")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas_log(text: str) -> dict[str, dict]:
    """{mangled kernel name: {registers, spill_stores, spill_loads, stack,
    smem}} from a ``ptxas -v`` log (``nvcc -Xptxas -v``)."""
    out: dict[str, dict] = {}
    cur = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), dict(
                registers=None, spill_stores=0, spill_loads=0, stack=0,
                smem=0))
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            cur["smem"] = int(s.group(1)) if s else 0
    return out


def find_instance(kernels: dict[str, dict], instance: str) -> dict | None:
    """The log's entry for a plan's kernel instance (a fragment of its
    mangled name), or None."""
    hits = [v for k, v in kernels.items() if instance in k]
    return hits[0] if len(hits) == 1 else None


def audit_registers(label: str, plan: LaunchPlan,
                    kernels: dict[str, dict]) -> PassResult:
    """Registers x threads at most REGS_PER_BLOCK, and no spills where the
    plan requires none, from the parsed ptxas log."""
    res = PassResult("registers", label)
    k = find_instance(kernels, plan.kernel)
    if k is None or k["registers"] is None:
        res.fail(f"{plan.kernel}: not (or not once) in the ptxas log")
        return res
    need = k["registers"] * plan.threads
    if need > REGS_PER_BLOCK:
        res.fail(f"{plan.kernel}: {k['registers']} registers x "
                 f"{plan.threads} threads = {need}, above the "
                 f"{REGS_PER_BLOCK} a block can have")
    if plan.no_spills and (k["spill_stores"] or k["spill_loads"]):
        res.fail(f"{plan.kernel}: {k['spill_stores']} B spill stores, "
                 f"{k['spill_loads']} B spill loads where the machine code "
                 "must not use local memory")
    res.notes.append(f"{k['registers']} registers x {plan.threads} "
                     f"threads, spills {k['spill_stores']} / "
                     f"{k['spill_loads']} B, static smem {k['smem']} B")
    return res


def audit_grid(label: str, plan: LaunchPlan) -> PassResult:
    """CUDA's launch limits and the kernel's 32-bit ``int`` values."""
    res = PassResult("grid", label)
    gx, gy, gz = plan.grid
    if min(plan.grid) < 1:
        res.fail(f"{plan.kernel}: grid {plan.grid} has an empty axis")
    if gx > GRID_X_MAX:
        res.fail(f"{plan.kernel}: grid.x {gx} above {GRID_X_MAX}")
    for axis, g in (("y", gy), ("z", gz)):
        if g > GRID_YZ_MAX:
            res.fail(f"{plan.kernel}: grid.{axis} {g} above {GRID_YZ_MAX}")
    if not 1 <= plan.threads <= MAX_THREADS:
        res.fail(f"{plan.kernel}: {plan.threads} threads a block, outside "
                 f"1..{MAX_THREADS}")
    for what, v in plan.int_offsets.items():
        if v > INT32_MAX:
            res.fail(f"{plan.kernel}: {what} reaches {v}, past the 32-bit "
                     "int the kernel computes it in")
    res.notes.append(f"grid {plan.grid} x {plan.threads} threads, "
                     f"{len(plan.int_offsets)} int values checked")
    return res


def audit_revisit(label: str, plan: LaunchPlan) -> PassResult:
    """Split partials written once each and read once by the merge; the
    ``accumulate`` declarations exactly where there is more than one
    split."""
    res = PassResult("revisit", label)
    multi = plan.splits > 1
    for name, disc in plan.accumulate.items():
        if not multi:
            res.fail(f"{plan.kernel}: {name} declares '{disc}' but the "
                     "launch has one split: stale declaration")
    if multi and not plan.accumulate:
        res.fail(f"{plan.kernel}: {plan.splits} splits write their results "
                 "but the plan declares no accumulation")
    pt = plan.partials
    if multi and any(d == "split-combine" for d in plan.accumulate.values()):
        if pt is None or plan.combine is None:
            res.fail(f"{plan.kernel}: split-combine declared without "
                     "partials and a merge launch")
    if pt is not None:
        for arrs in scalar_sets(plan):
            written = Counter(s for p in plan.programs()
                              for s in pt.slots(p, arrs))
            twice = [s for s, n in written.items() if n > 1]
            outside = [s for s in written if not 0 <= s < pt.n_slots]
            read = Counter(pt.reads(arrs))
            if twice:
                res.fail(f"{plan.kernel}: {len(twice)} partial slot(s) "
                         f"written by more than one block (e.g. "
                         f"{twice[:3]}) with scalars {_fills(arrs)}")
            if outside:
                res.fail(f"{plan.kernel}: partial slots {outside[:3]} "
                         f"outside the {pt.n_slots} slots")
            reread = [s for s, n in read.items() if n > 1]
            stale = [s for s in read if s not in written]
            unread = [s for s in written if s not in read]
            if reread:
                res.fail(f"{plan.kernel}: the merge reads {len(reread)} "
                         f"partial slot(s) more than once")
            if stale:
                res.fail(f"{plan.kernel}: the merge reads {len(stale)} "
                         f"slot(s) no block wrote (e.g. {stale[:3]}) with "
                         f"scalars {_fills(arrs)}")
            if unread:
                res.fail(f"{plan.kernel}: {len(unread)} written partial "
                         f"slot(s) never merged (e.g. {unread[:3]})")
    res.notes.append(f"{plan.splits} split(s), accumulate "
                     f"{plan.accumulate or 'none'}")
    return res


def run_plan_audits(plan: LaunchPlan, label: str,
                    kernels: dict[str, dict] | None = None) -> list:
    """The five passes over one launch and its merge launch; the ptxas
    log's entries (``kernels``) default to the committed sample's."""
    if kernels is None:
        kernels = parse_ptxas_log(SAMPLE_PTXAS_LOG.read_text())
    out = []
    for p in [plan] + ([plan.combine] if plan.combine else []):
        lab = label if p is plan else f"{label}/combine"
        k = find_instance(kernels, p.kernel)
        out += [audit_bounds(f"{lab}/bounds", p),
                audit_smem(f"{lab}/smem", p,
                           static=None if k is None else k["smem"]),
                audit_registers(f"{lab}/registers", p, kernels),
                audit_grid(f"{lab}/grid", p),
                audit_revisit(f"{lab}/revisit", p)]
    return out


def audit_registry(*, registry=None, ptxas_log: str | None = None,
                   sms: int = 132) -> dict:
    """Every registered launch x its audit cases.  Returns the
    ``kernel_audit`` section of the analysis report::

        {"ptxas_log": ..., "ok": bool, "kernels": {"label": {"ok": ...,
         "passes": [...], "geometry": {...}}}}
    """
    from ..kernels.dispatch import KERNEL_REGISTRY
    registry = KERNEL_REGISTRY if registry is None else registry
    text = SAMPLE_PTXAS_LOG.read_text() if ptxas_log is None else ptxas_log
    kernels = parse_ptxas_log(text)
    out = {"ptxas_log": "sample" if ptxas_log is None else "build",
           "kernels": {}, "ok": True}
    for entry in registry.values():
        for case_label, kwargs in entry.cases():
            label = f"{entry.name}/{case_label}"
            plan = entry.plan(sms=sms, **kwargs)
            cell = results_to_json(run_plan_audits(plan, label, kernels))
            cell["geometry"] = plan.geometry()
            cell["kernel"] = plan.kernel
            out["kernels"][label] = cell
    out["ok"] = all(c["ok"] for c in out["kernels"].values())
    return out

"""Hot-path contracts of the serving engine, checked on executed steps.

Port of ``repro.analysis.contracts``.  The reference audits *lowered*
jaxprs and compiled HLO and never runs a step.  The port has no jit and
no graph to lower, so each pass here **runs one step** of a real engine
(a prefill chunk through ``_admit``, a decode step through ``step``:
on the CPU in the tests and the analysis CLI, on the card in
``chip_smoke.py``) and watches it through a ``TorchDispatchMode``
(:class:`OpRecorder`): every aten op, its operands and results, and the
innermost ``repro_torch`` frame that issued it.

Passes (see analysis/README.md):

``inplace``   (donation's role) every paged-pool and state-row leaf keeps
              its storage through a prefill chunk and a decode step, and
              no op in them allocates a tensor of a pool leaf's bytes or
              more: an out-of-place pool update doubles the KV memory.
``retrace``   (its role) a byte-identical repeated workload adds nothing
              to the port's memo tables and launches each kernel (on the
              CPU: calls each kernel's front door) as often as the first.
``dtype``     under ``sc_int`` / ``sc_int_approx`` no matmul-class aten op
              with float operands outside the float-math allowlist, and
              the integer datapath engaged (an integer product from
              ``core/sc_layers.py`` / ``kernels/ops.py``; an op from
              ``core/sc_layers.py`` / ``core/bsn.py``).
``host``      (card only) every device-to-host sync of a decode step and
              a prefill chunk, named by its site, is on the allowance
              list; on the CPU the ``host-op`` lint stands for it.
``sharding``  under a (data, model) mesh every pool leaf keeps the spec
              ``shard_tree`` gave it, and a decode step gathers no more
              bytes than a budget proportional to its activations and
              logits.
"""

from __future__ import annotations

import contextlib
import sys
import warnings
from dataclasses import dataclass, field

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Violation", "PassResult", "results_to_json", "OpRecorder",
           "provenance", "audit_inplace", "audit_retrace", "audit_dtype",
           "audit_host", "audit_sharding", "run_engine_contracts",
           "FLOAT_DOT_ALLOW_FILES", "FLOAT_DOT_ALLOW_FUNCS",
           "HOST_SYNC_ALLOW", "MATMUL_OPS"]


@dataclass(frozen=True)
class Violation:
    passname: str
    label: str
    message: str

    def to_dict(self) -> dict:
        return {"pass": self.passname, "label": self.label,
                "message": self.message}


@dataclass
class PassResult:
    passname: str
    label: str
    violations: list = field(default_factory=list)
    notes: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def fail(self, message: str) -> None:
        self.violations.append(Violation(self.passname, self.label, message))

    def to_dict(self) -> dict:
        return {"pass": self.passname, "label": self.label, "ok": self.ok,
                "violations": [v.to_dict() for v in self.violations],
                "notes": list(self.notes)}


def results_to_json(results: list) -> dict:
    vios = [v for r in results for v in r.violations]
    return {"ok": not vios, "passes": [r.to_dict() for r in results],
            "violation_count": len(vios)}


# ---------------------------------------------------------------------------
# watching a step
# ---------------------------------------------------------------------------

_PKG = "/repro_torch/"
_SKIP = ("/repro_torch/analysis/",)


def _frames(frame) -> list[str]:
    """The ``repro_torch`` frames from ``frame`` outwards, as
    ``"path/file.py:function"`` relative to the package."""
    out = []
    while frame is not None:
        fn = frame.f_code.co_filename.replace("\\", "/")
        if _PKG in fn and not any(s in fn for s in _SKIP):
            out.append(f"{fn.split(_PKG)[-1]}:{frame.f_code.co_name}")
        frame = frame.f_back
    return out


def provenance(frames: list[str]) -> str:
    """The innermost ``repro_torch`` frame, ``"<external>"`` if none."""
    return frames[0] if frames else "<external>"


@dataclass
class OpRecord:
    name: str
    inputs: list          # (dtype, shape, storage ptr)
    outputs: list         # (dtype, shape, storage ptr, storage bytes)
    frames: list[str]


def _storage(t: torch.Tensor) -> tuple[int, int]:
    try:
        s = t.untyped_storage()
        return s.data_ptr(), s.nbytes()
    except (RuntimeError, NotImplementedError):
        return 0, 0


class OpRecorder(TorchDispatchMode):
    """Record every aten op run inside the block (its name, operand and
    result dtypes, shapes and storages, and the ``repro_torch`` frames
    that issued it)."""

    def __init__(self):
        super().__init__()
        self.ops: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [(a.dtype, tuple(a.shape), _storage(a)[0])
               for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [(o.dtype, tuple(o.shape), *_storage(o))
                for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        self.ops.append(OpRecord(func.overloadpacket.__name__, ins, outs,
                                 _frames(sys._getframe(1))))
        return out


# ---------------------------------------------------------------------------
# inplace
# ---------------------------------------------------------------------------

def _flat(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{name}").items()}
    return {prefix: tree} if isinstance(tree, torch.Tensor) else {}


def pool_leaves(cache: dict) -> dict[str, torch.Tensor]:
    """Every tensor of the paged cache's layers (KV pools, their scales
    and residuals, state rows), by path ``layers/<i>/<name>[/...]``."""
    return {k: v for i, e in enumerate(cache["layers"])
            for k, v in _flat(e, f"layers/{i}").items()}


def _pool_floor(leaves: dict[str, torch.Tensor]) -> int:
    """The bytes of the smallest KV pool (``*_pages``), or, with no
    attention layer, of the largest state-row leaf: what an out-of-place
    update of a pool would allocate at the least."""
    pages = [v.untyped_storage().nbytes() for k, v in leaves.items()
             if k.endswith("_pages")]
    if pages:
        return min(pages)
    return max((v.untyped_storage().nbytes() for v in leaves.values()),
               default=0)


def audit_inplace(label: str, before: dict[str, int],
                  cache: dict, ops: list[OpRecord],
                  floor: int) -> PassResult:
    """Every pool leaf's storage (``before``: path -> storage pointer) is
    the one it has after the recorded ops, and no recorded op allocates
    a pool-sized tensor: ``floor`` bytes or more (:func:`_pool_floor`)
    that spans a pool, with a pool leaf's shape or its page count along
    dimension 0.  Activations (and the approximate adder's counts, up to
    a GiB a block) can outgrow a small pool; only a tensor that spans
    one is a copy of it."""
    res = PassResult("inplace", label)
    after = pool_leaves(cache)
    shapes = {tuple(t.shape) for t in after.values()}
    pages = {t.shape[0] for k, t in after.items() if k.endswith("_pages")}
    for path, ptr in before.items():
        t = after.get(path)
        if t is None:
            res.fail(f"pool leaf {path} is gone after the step")
        elif _storage(t)[0] != ptr:
            res.fail(f"pool leaf {path} was replaced by a new tensor (its "
                     "storage moved): an out-of-place update")
    big = 0
    for op in ops:
        ins = {p for _, _, p in op.inputs}
        for dt, shape, ptr, nbytes in op.outputs:
            spans = shape in shapes or (shape and shape[0] in pages)
            if ptr and ptr not in ins and nbytes >= floor and spans:
                big += 1
                if big <= 3:
                    res.fail(f"{op.name} at {provenance(op.frames)} "
                             f"allocates {nbytes} B {dt} {shape}, a copy "
                             f"of a pool ({floor} B a leaf at the least)")
    res.notes.append(f"{len(before)} pool leaves kept their storage; "
                     f"{len(ops)} ops, allocation floor {floor} B")
    return res


# ---------------------------------------------------------------------------
# dtype
# ---------------------------------------------------------------------------

# Float products are allowed only where the paper keeps float math:
# attention (softmax is float by definition), the recurrent mixers'
# state updates (not BSN accumulations), the sampler, and the kernels'
# plain versions of float kernels.  kernels/ref.py's integer product
# (ternary_matmul_ref) runs in float64, exact; it counts as an integer
# product.  The projections (models/common.py dense_apply,
# core/sc_layers.py, models/moe.py's experts) are the BSN region.
FLOAT_DOT_ALLOW_FILES = (
    "kernels/paged_attention.py", "kernels/flash_attention.py",
    "kernels/ref.py", "models/attention.py", "models/mamba.py",
    "models/rwkv6.py", "serving/sampling.py",
)
# the MoE router draws its gate logits in float by design (outside the
# quantized datapath, as the reference's moe_apply); expert products are
# not allowed
FLOAT_DOT_ALLOW_FUNCS = (
    ("models/moe.py", "route"),
)
# helpers whose products belong to their caller
_PRODUCT_HELPERS = ("models/common.py:matmul_rows",)
# the aten products; in inference mode the composite ones (matmul,
# einsum, linear) reach the dispatch mode before they decompose
MATMUL_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm",
                        "_int_mm", "convolution", "_convolution", "mv",
                        "addmv", "dot", "vdot", "matmul", "einsum",
                        "linear", "tensordot", "bilinear", "inner"})
_INT_PRODUCT = ("kernels/ref.py:ternary_matmul_ref",)


def _site(frames: list[str]) -> str:
    """The innermost frame that is not a product helper."""
    for f in frames:
        if f not in _PRODUCT_HELPERS:
            return f
    return provenance(frames)


def _allowed(site: str) -> bool:
    f, _, fn = site.partition(":")
    return f in FLOAT_DOT_ALLOW_FILES or (f, fn) in FLOAT_DOT_ALLOW_FUNCS


def audit_dtype(label: str, ops: list[OpRecord], *, datapath: str,
                launches: dict[str, int] | None = None) -> PassResult:
    """No float product outside the allowlist under sc_int /
    sc_int_approx, and the integer datapath engaged.  ``launches``: the
    kernel launches of the recorded steps on the card (a launch through
    ctypes is no aten op), counted as the products they compute."""
    res = PassResult("dtype", label)
    if datapath == "qat":
        res.notes.append("qat datapath: float projections are the "
                         "datapath; purity not applicable")
        return res
    launches = launches or {}
    n_float = n_int = n_sc = 0
    for op in ops:
        if any(f.startswith(("core/sc_layers.py", "core/bsn.py"))
               for f in op.frames[:1]):
            n_sc += 1
        if op.name not in MATMUL_OPS:
            continue
        site = _site(op.frames)
        integer = (all(not dt.is_floating_point for dt, _, _ in op.inputs)
                   or any(f in _INT_PRODUCT for f in op.frames))
        if integer:
            if any(f.startswith(("core/sc_layers.py", "kernels/ops.py"))
                   for f in op.frames):
                n_int += 1
            continue
        n_float += 1
        if not _allowed(site):
            dts = sorted({str(dt) for dt, _, _ in op.inputs})
            res.fail(f"float {op.name} ({', '.join(dts)}) at {site} "
                     f"(innermost {provenance(op.frames)}) inside the "
                     f"{datapath} BSN region: not in the float-math "
                     "allowlist (analysis/README.md)")
    n_int += launches.get("ternary_matmul", 0) \
        + launches.get("ternary_matmul_batched", 0)
    n_sc += launches.get("approx_bsn", 0) \
        + launches.get("approx_bsn_temporal", 0)
    if datapath == "sc_int" and n_int == 0:
        res.fail("sc_int produced no integer product from "
                 "core/sc_layers.py or kernels/ops.py: the integer "
                 "datapath is not engaged (quantization silently off?)")
    if datapath == "sc_int_approx" and n_sc == 0:
        res.fail("sc_int_approx ran no op from core/sc_layers.py or "
                 "core/bsn.py: the approximate BSN datapath is not "
                 "engaged")
    res.notes.append(f"{n_float} float products (allowlisted), {n_int} "
                     f"integer products, {n_sc} sc ops")
    return res


# ---------------------------------------------------------------------------
# host (the card)
# ---------------------------------------------------------------------------

# site -> why its sync is expected.  The engine's host bookkeeping
# (queue, slots, allocator, page tables) lives in numpy and Python by
# design, as the reference's: a step's tokens come back each tick, and its
# inputs go up through pinned memory without a sync (engine._tensor).
HOST_SYNC_ALLOW = {
    "serving/engine.py:_prefill_group":
        "the first tokens of the admitted requests come back to the host "
        "bookkeeping (one read-back a prefill)",
    "serving/engine.py:_decode":
        "the step's tokens come back to the host bookkeeping (one "
        "read-back a decode step)",
}


# what torch.cuda.set_sync_debug_mode("warn") says at each sync
_SYNC_WARNING = "called a synchronizing CUDA operation"


# the syncs every step makes: a step that shows none was not watched
_READ_BACKS = ("serving/engine.py:_prefill_group", "serving/engine.py:_decode")


@contextlib.contextmanager
def sync_sites(sites: list[tuple[str, list[str]]]):
    """Inside the block, every synchronizing CUDA call warns
    (``torch.cuda.set_sync_debug_mode``); each is appended to ``sites``
    as (message, the ``repro_torch`` frames at the call)."""
    show = warnings.showwarning

    def catch(message, category, filename, lineno, file=None, line=None):
        text = str(message)
        if _SYNC_WARNING in text:
            sites.append((text, _frames(sys._getframe(1))))
        else:       # the mode's own notice that it is a prototype, ...
            show(message, category, filename, lineno, file, line)
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = catch
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode(prev)
            warnings.showwarning = show


def audit_host(label: str, sites: list[tuple[str, list[str]]]
               ) -> PassResult:
    """Every sync site of the recorded steps is on the allowance list."""
    res = PassResult("host", label)
    seen: dict[str, list] = {}
    for text, frames in sites:
        seen.setdefault(provenance(frames), []).append(text)
    for site, texts in sorted(seen.items()):
        if site in HOST_SYNC_ALLOW:
            res.notes.append(f"{site}: {len(texts)} sync(s), allowed: "
                             f"{HOST_SYNC_ALLOW[site]}")
        else:
            res.fail(f"{len(texts)} device-to-host sync(s) at {site}, not "
                     f"on the allowance list ({texts[0][:120]})")
    if not any(s in seen for s in _READ_BACKS):
        res.fail("no sync seen at the token read-back "
                 f"({', '.join(_READ_BACKS)}): the sync detection is not "
                 "engaged")
    res.notes.append(f"{len(sites)} syncs at {len(seen)} site(s)")
    return res


# ---------------------------------------------------------------------------
# retrace
# ---------------------------------------------------------------------------

# the kernels' front doors: each call is a launch on the card, the plain
# version's call on the CPU
_FRONT_DOORS = (("kernels.dispatch", "approx_bsn"),
                ("kernels.dispatch", "paged_attn_decode"),
                ("kernels.dispatch", "paged_attn_prefill"),
                ("kernels.dispatch", "flash_attention"),
                ("kernels.ops", "ternary_matmul"),
                ("kernels.ops", "sort_rows"))


@contextlib.contextmanager
def wrap_functions(targets, make):
    """Inside the block, function ``fn_name`` of module ``repro_torch.<mod>``
    (each of ``targets``) is ``make(inner, fn_name)`` in every
    ``repro_torch`` module that holds it (a ``from ... import`` copies the
    reference)."""
    import importlib
    saved = []
    for mod_name, fn_name in targets:
        inner = getattr(importlib.import_module(f"repro_torch.{mod_name}"),
                        fn_name)
        wrapper = make(inner, fn_name)
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("repro_torch") \
                    and getattr(mod, fn_name, None) is inner:
                saved.append((mod, fn_name, inner))
                setattr(mod, fn_name, wrapper)
    try:
        yield
    finally:
        for mod, fn_name, inner in reversed(saved):
            setattr(mod, fn_name, inner)


@contextlib.contextmanager
def count_front_doors(counts: dict[str, int]):
    """Count calls of the kernels' front doors inside the block."""
    def make(inner, key):
        def counted(*a, **kw):
            counts[key] = counts.get(key, 0) + 1
            return inner(*a, **kw)
        return counted
    with wrap_functions(_FRONT_DOORS, make):
        yield counts


def memo_sizes(eng) -> dict[str, int]:
    """The port's memo tables: the bound kernel entry points and the
    engine's packed sampling tensors."""
    from ..kernels import build
    return {"kernels.build._entries": len(build._entries),
            "ServeEngine._samp_key": 0 if eng._samp_key is None
            else len(eng._samp_key[0])}


def audit_retrace(label: str, eng, prompts: list[list[int]], *,
                  max_new: int = 4) -> PassResult:
    """Run a prompt ladder twice through one engine: the second, byte-
    identical run adds nothing to the memo tables and makes as many
    kernel calls (and, on the card, launches) as the first."""
    from ..kernels import build
    res = PassResult("retrace", label)

    def run():
        counts: dict[str, int] = {}
        build.reset_launches()
        with count_front_doors(counts):
            for p in prompts:
                eng.submit(list(p), max_new_tokens=max_new)
            eng.run_to_completion()
        return counts, dict(build.LAUNCHES)

    calls1, launches1 = run()
    memo1 = memo_sizes(eng)
    calls2, launches2 = run()
    memo2 = memo_sizes(eng)
    for k, v in memo2.items():
        if v > memo1[k]:
            res.fail(f"memo table {k} grew on an identical repeated "
                     f"workload: {memo1[k]} -> {v}")
    if calls1 != calls2:
        res.fail(f"kernel calls differ on the repeat: {calls1} -> {calls2}")
    if launches1 != launches2:
        res.fail(f"kernel launches differ on the repeat: {launches1} -> "
                 f"{launches2}")
    res.notes.append(f"calls a run {calls1}; launches "
                     f"{ {k: v for k, v in launches1.items() if v} }; "
                     f"memo {memo1}")
    return res


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def count_gathers(log: list[tuple[int, int, list[str]]]):
    """Record every ``torch.distributed.all_gather`` inside the block as
    (bytes a rank sends, ranks, the ``repro_torch`` frames)."""
    import torch.distributed as dist
    inner = dist.all_gather

    def counted(tensor_list, tensor, *a, **kw):
        log.append((tensor.numel() * tensor.element_size(),
                    len(tensor_list), _frames(sys._getframe(1))))
        return inner(tensor_list, tensor, *a, **kw)
    dist.all_gather = counted
    try:
        yield log
    finally:
        dist.all_gather = inner


def audit_sharding(label: str, eng, tags: dict[str, tuple],
                   gathers: list[tuple[int, int, list[str]]], *,
                   lanes: int, wire_budget_mult: float = 8.0
                   ) -> PassResult:
    """Under the engine's mesh: every pool leaf still carries the spec
    ``tags`` recorded after construction, which is the one
    ``fit_spec`` of ``paged_cache_specs`` through the rules gives; and
    the bytes one decode step's gathers bring a rank (``gathers``) stay
    within ``mult x 4 B x lanes x (vocab + 4 x layers x d_model)``."""
    import math

    from ..distributed.sharding import _names, fit_spec, spec_of
    from ..models import paged_cache_specs
    res = PassResult("sharding", label)
    rules = eng.rules
    if rules is None:
        res.notes.append("no mesh: nothing to check")
        return res
    mesh = rules.mesh
    specs = paged_cache_specs(eng.cfg, eng.kv_format)
    leaves = pool_leaves(eng.cache)
    sharded = 0
    for path, t in leaves.items():
        _, i, *names = path.split("/")
        got = spec_of(t)
        if got != tags.get(path):
            res.fail(f"pool leaf {path} carries spec {got or None}, "
                     f"not the {tags.get(path)} shard_tree gave it")
            continue
        whole = [n * math.prod(mesh.axis_size(a) for a in _names(ax))
                 for n, ax in zip(t.shape, got + (None,) * t.ndim)]
        logical = specs["layers"][int(i)]
        for name in names:
            logical = logical.get(name) if isinstance(logical, dict) \
                else None
        want = fit_spec(rules.resolve(logical) if logical else (),
                        whole, mesh)
        if got != want:
            res.fail(f"pool leaf {path}: spec {got} is not "
                     f"paged_cache_specs' {want} through the rules")
        elif any(ax is not None for ax in got):
            sharded += 1
    cfg = eng.cfg
    V = cfg.padded_vocab
    budget = wire_budget_mult * 4.0 * lanes * (V + 4 * cfg.n_layers
                                               * cfg.d_model)
    wire = sum(nbytes * (n - 1) for nbytes, n, _ in gathers)
    if wire > budget:
        top: dict[str, int] = {}
        for nbytes, n, frames in gathers:
            site = provenance(frames[1:]) if frames[:1] == [
                "distributed/sharding.py:gather"] else provenance(frames)
            top[site] = top.get(site, 0) + nbytes * (n - 1)
        worst = sorted(top.items(), key=lambda kv: -kv[1])[:3]
        res.fail(f"a decode step gathers {wire} B into a rank, above the "
                 f"budget {budget:.0f} B ({len(gathers)} gathers; most at "
                 f"{worst})")
    res.notes.append(f"{len(leaves)} pool leaves, {sharded} sharded; "
                     f"decode gathers {wire} B of budget {budget:.0f} B in "
                     f"{len(gathers)} gathers")
    return res


# ---------------------------------------------------------------------------
# one engine's battery
# ---------------------------------------------------------------------------

def run_engine_contracts(eng, label: str, prompts: list[list[int]], *,
                         on_card: bool = False) -> list:
    """``inplace`` and ``dtype`` (and on the card ``host``) over one
    prefill chunk (``_admit``) and one decode step of ``eng``, with
    ``prompts`` queued.  The exact-length prefill (``prefill_mode=
    "exact"``, ``ServeEngine._prefill_one``) is exempt from ``inplace``
    by design, recorded as a note: it builds a fresh dense cache of the
    prompt and scatters it into the pools."""
    from ..kernels import build
    for p in prompts:
        eng.submit(list(p), max_new_tokens=4)
    leaves = pool_leaves(eng.cache)
    before = {k: _storage(v)[0] for k, v in leaves.items()}
    floor = _pool_floor(leaves)
    results = []
    sites: list = []
    for what, run in (("prefill", eng._admit), ("decode", eng.step)):
        build.reset_launches()
        rec = OpRecorder()
        ctx = sync_sites(sites) if on_card else contextlib.nullcontext()
        with ctx, rec:
            run()
        if on_card:
            torch.cuda.synchronize()
        results.append(audit_inplace(f"{label}/{what}", before, eng.cache,
                                     rec.ops, floor))
        results.append(audit_dtype(f"{label}/{what}", rec.ops,
                                   datapath=eng.datapath,
                                   launches=dict(build.LAUNCHES)))
    host = PassResult("host", f"{label}/steps")
    if on_card:
        host = audit_host(f"{label}/steps", sites)
    else:
        host.notes.append("not run here: the host pass needs the card "
                          "(chip_smoke.py phase 12); the host-op lint "
                          "stands for it on the CPU")
    results.append(host)
    exempt = PassResult("inplace", f"{label}/prefill_exact")
    exempt.notes.append(
        "exempt by design: the exact-length prefill (prefill_mode="
        "'exact', ServeEngine._prefill_one) builds a fresh dense cache of "
        "the prompt and scatters it into the pools")
    results.append(exempt)
    return results

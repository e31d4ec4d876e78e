"""The port's kernel audit (``repro_torch.analysis.kernel_audit``) over the
launch plans of its CUDA kernels (``repro_torch.kernels.plan``).

Every pass has an injection here that trips it and no other pass (a pass
without one is assumed vacuous): a table entry one page past the pool
and a grid one lane too wide (``bounds``), shared memory above 227 KiB
(``smem``), registers x threads above 65536 and spills where none may be,
from a log in ptxas's format (``registers``), grid.y above 65535 and a
32-bit offset past 2^31 (``grid``), a partial slot written twice and a
stale accumulation declaration (``revisit``).  The registry covers
``build.KERNELS`` and audits clean with the committed ptxas log of the
H100 build, and the plans' constants are the ``constexpr`` values of
``csrc/``.  That the plans' geometry equals the launchers' C++ is
checked on the card (``tests/test_torch_cuda.py``, chip_smoke.py phase
12).
"""

import dataclasses
import re
from pathlib import Path

import pytest

from port_fixtures import _one_torch_thread  # noqa: F401
from repro_torch.analysis import kernel_audit as ka
from repro_torch.kernels import build
from repro_torch.kernels import plan as kp
from repro_torch.kernels.dispatch import KERNEL_REGISTRY

CSRC = Path(kp.__file__).with_name("csrc")
KERNELS = ka.parse_ptxas_log(ka.SAMPLE_PTXAS_LOG.read_text())


def _decode(maxp=256, S=32, kind=kp.KV_INT8, D=64):
    return kp.paged_decode_plan(S=S, Hkv=8, G=4, D=D, page=16, maxp=maxp,
                                num_pages=S * maxp + 1, kv_kind=kind)


def _failing(plan, kernels=KERNELS) -> set:
    return {r.passname for r in ka.run_plan_audits(plan, "case", kernels)
            if not r.ok}


def _messages(plan, kernels=KERNELS) -> str:
    return " | ".join(v.message for r in ka.run_plan_audits(
        plan, "case", kernels) for v in r.violations)


def test_clean_plan_passes_every_pass():
    plan = _decode()
    results = ka.run_plan_audits(plan, "decode", KERNELS)
    assert {r.passname for r in results} == {"bounds", "smem", "registers",
                                            "grid", "revisit"}
    assert all(r.ok for r in results), _messages(plan)
    # the split decode at a 4096-token window has a merge launch
    assert plan.combine is not None and plan.splits == 8


def test_bounds_table_entry_one_page_past_the_pool():
    plan = _decode()
    tables, lengths = plan.scalars
    bad = dataclasses.replace(plan, scalars=(
        dataclasses.replace(tables, max_value=tables.max_value + 1),
        lengths))
    assert _failing(bad) == {"bounds"}
    assert "k_pages" in _messages(bad) and "outside" in _messages(bad)


def test_bounds_grid_overrun():
    plan = _decode(maxp=16, S=8)
    bad = dataclasses.replace(plan, grid=(plan.grid[0] + 8, *plan.grid[1:]),
                              probe=None)
    assert _failing(bad) == {"bounds"}
    assert "operand q" in _messages(bad)


def test_bounds_prefill_last_chunk_of_a_4096_prompt_is_clean():
    plan = kp.paged_prefill_plan(G=4, C=64, Hkv=8, Gq=4, D=64, page=16,
                                 width=256, start=4032, num_pages=1025,
                                 kv_kind=kp.KV_SC)
    assert plan.splits == 4 and plan.combine is not None
    assert not _failing(plan)
    # one chunk further the table runs out: the width check catches it
    far = dataclasses.replace(plan, operands=tuple(
        dataclasses.replace(op, numel=op.numel // 2)
        if op.name == "tables" else op for op in plan.operands))
    assert _failing(far) == {"bounds"}


def test_smem_over_a_block():
    bad = dataclasses.replace(_decode(), smem=kp.SMEM_CAP + 1)
    assert _failing(bad) == {"smem"}
    assert "shared memory" in _messages(bad)


def _log(instance: str, regs: int, spills: int = 0) -> dict:
    """A ptxas -v log of one kernel, in the format the build keeps."""
    name = f"_ZN12_GLOBAL__N_1{instance}EvPKfPi"
    text = (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\nptxas info    : Function properties for {name}\n"
            f"    8 bytes stack frame, {spills} bytes spill stores, "
            f"{spills} bytes spill loads\nptxas info    : Used {regs} "
            "registers, used 1 barriers, 16 bytes smem\n")
    return ka.parse_ptxas_log(text)


def test_registers_times_threads_over_a_block():
    plan = _decode(maxp=16, S=8)
    assert not _failing(plan, _log(plan.kernel, 255))    # 255 x 128 fits
    wide = dataclasses.replace(plan, threads=512)
    assert _failing(wide, _log(plan.kernel, 255)) == {"registers"}
    assert "255 registers x 512 threads = 130560" in _messages(
        wide, _log(plan.kernel, 255))


def test_registers_spills_where_none_may_be():
    plan = _decode()                 # D 64: must not use local memory
    assert plan.no_spills
    assert _failing(plan, _log(plan.kernel, 96, spills=8)) == {"registers"}
    d32 = _decode(maxp=16, S=8, D=32)   # D 32 may (the build spills there)
    assert not d32.no_spills
    assert not _failing(d32, _log(d32.kernel, 96, spills=8))


def test_registers_instance_missing_from_the_log_fails():
    plan = _decode()
    assert _failing(plan, {}) == {"registers"}


def test_grid_y_over_65535():
    bad = dataclasses.replace(_decode(), grid=(256, 65536, 1),
                              probe=((0, 255), (0, 7)), partials=None,
                              accumulate={"part": "split-combine"})
    assert "grid" in _failing(bad)
    assert "grid.y 65536" in _messages(bad)


def test_int_offset_over_2_31():
    plan = kp.paged_prefill_plan(G=4, C=64, Hkv=8, Gq=4, D=64, page=16,
                                 width=256, start=4032, num_pages=1025,
                                 kv_kind=kp.KV_BF16)
    big = dataclasses.replace(plan, int_offsets={
        **plan.int_offsets, "G * C * Hkv * Gq * D + 255": 2 ** 31})
    assert _failing(big) == {"grid"}
    assert "past the 32-bit int" in _messages(big)


def test_revisit_partial_written_twice():
    plan = _decode()
    pt = plan.partials
    bad = dataclasses.replace(plan, partials=dataclasses.replace(
        pt, slots=lambda p, sc: [s // 2 for s in pt.slots(p, sc)]))
    assert _failing(bad) == {"revisit"}
    assert "written by more than one block" in _messages(bad)


def test_revisit_stale_accumulation_declaration():
    one = _decode(maxp=16, S=8)          # 256 positions: one split
    assert one.splits == 1 and not one.accumulate
    bad = dataclasses.replace(one, accumulate={"part": "split-combine"})
    assert _failing(bad) == {"revisit"}
    assert "stale declaration" in _messages(bad)
    # and a missing one where there are splits
    assert _failing(dataclasses.replace(_decode(), accumulate={})) \
        == {"revisit"}


def test_ternary_k_split_declares_atomic_accumulation():
    split = kp.ternary_matmul_plan(batch=1, M=4, N=2048, K=2048)
    assert split.splits > 1 and split.accumulate == {"out": "atomic-add"}
    si = kp.ternary_matmul_plan(batch=1, M=4, N=2048, K=2048, out_bsl=8)
    assert si.splits == 1 and not si.accumulate
    assert not _failing(split) and not _failing(si)


def test_registry_covers_every_kernel():
    assert set(KERNEL_REGISTRY) == set(build.KERNELS)
    for entry in KERNEL_REGISTRY.values():
        assert entry.cases(), entry.name
        assert entry.geometry_entry in build._SIGNATURES


@pytest.mark.parametrize("name", sorted(build.KERNELS))
def test_registry_audits_clean(name):
    entry = KERNEL_REGISTRY[name]
    out = ka.audit_registry(registry={name: entry})
    bad = {k: [v["message"] for p in c["passes"] for v in p["violations"]]
           for k, c in out["kernels"].items() if not c["ok"]}
    assert out["ok"], bad
    for case, _ in entry.cases():
        plan = entry.plan(**dict(entry.cases())[case])
        assert plan.name == name
        assert ka.find_instance(KERNELS, plan.kernel) is not None, \
            plan.kernel


def _constexprs(text: str) -> dict:
    """The namespace-level ``constexpr`` ints of a source, evaluated."""
    out = {}
    for m in re.finditer(r"^constexpr (?:int|size_t) (\w+) = ([^;]+);",
                         text, re.M):
        out[m.group(1)] = eval(m.group(2), {}, dict(out))  # noqa: S307
    return out


@pytest.mark.parametrize("fname", sorted(kp.CSRC_CONSTANTS))
def test_plan_constants_are_the_csrc_constexprs(fname):
    parsed = _constexprs((CSRC / fname).read_text())
    for name, value in kp.CSRC_CONSTANTS[fname].items():
        assert parsed.get(name) == value, (fname, name, parsed.get(name))


def test_plan_sources_name_their_kernels():
    for entry in KERNEL_REGISTRY.values():
        for _, kw in entry.cases():
            plan = entry.plan(**kw)
            for p in (plan, plan.combine):
                if p is None:
                    continue
                f, line = p.source.rsplit(":", 1)
                text = Path(f.replace("src/repro_torch/kernels/csrc/",
                                      str(CSRC) + "/")).read_text()
                head = "\n".join(text.splitlines()[int(line) - 1:
                                                   int(line) + 3])
                name = re.sub(r"^\d+", "", p.kernel).split("I")[0] \
                    .rstrip("E")
                assert "__global__" in head and name in head, (p.source,
                                                              name)


@pytest.mark.parametrize("D,kernel", [
    (16, "flash_fwd_mma_kernel"), (32, "flash_fwd_mma_kernel"),
    (64, "flash_fwd_wgmma_kernel"), (80, "flash_fwd_wgmma_kernel"),
    (128, "flash_fwd_wgmma_kernel")])
def test_flash_plan_routes_bf16_by_head_width(D, kernel):
    """bf16 at the models' head widths runs the wgmma kernel (384 threads,
    128-row blocks), the narrower widths the mma.sync one; shared memory
    within a block's, and every TMA box of the wgmma kernel's q tile and
    K / V ring 1024-byte aligned, as the 128B swizzle's phase needs (the
    32B one's 256 bytes follow)."""
    plan = kp.flash_attention_plan(B=2, S=300, Hq=8, Hkv=2, D=D)
    assert plan.kernel == kp.kernel_instance(kernel, f"Li{D}E")
    assert plan.smem <= kp.SMEM_CAP
    assert kp.flash_attention_plan(B=2, S=300, Hq=8, Hkv=2, D=D,
                                   bf16=False).code == 0
    if kernel == "flash_fwd_wgmma_kernel":
        fl = kp.CSRC_CONSTANTS["flash_attention.cu"]
        assert (plan.code, plan.threads, plan.block) == (
            2, fl["WG_THREADS"], fl["WG_BQ"])
        offs = kp.flash_stage_offsets(D)
        assert len(offs) == (1 + 2 * fl["WG_STAGES"]) * (D // 64 + D % 64
                                                         // 16)
        assert all(o % 1024 == 0 for o in offs)
        # the barriers sit past the last box, inside the block's memory
        assert max(offs) < plan.smem - 1024
    else:
        assert plan.code == 1


def test_ptxas_sample_parses_every_instance():
    assert len(KERNELS) >= 60
    assert all(k["registers"] for k in KERNELS.values())
    # the float32 flash kernel at D 128 spills (recorded, not refused)
    f128 = ka.find_instance(KERNELS, kp.kernel_instance(
        "flash_fwd_kernel", "Li128E"))
    assert f128["spill_stores"] > 0

"""The port's roofline (``repro_torch.analysis.roofline``), its step cost
(``analysis/op_cost.py``) and report formatting.

``count_params`` / ``model_flops`` equal the JAX package's
(``repro.analysis.roofline``) for every arch the port registers, at every
shape of the reference's ``SHAPES``; ``op_cost`` counts a hand-counted
product exactly, eager or in inference mode, and counts a kernel at its
front door by its formula (never its plain version's ops); ``chip_smoke.py``
takes its H100 peaks and bounds from the roofline and its phase 3 bounds
are the numbers its formulas gave before they moved there.
"""

import ast
import contextlib
import importlib.util
from pathlib import Path

import pytest
import torch

from port_fixtures import _one_torch_thread  # noqa: F401
from repro.analysis import roofline as ref_roofline
from repro.configs import get_arch as ref_arch
from repro.configs.base import SHAPES
from repro_torch.analysis import op_cost, report
from repro_torch.analysis import roofline as R
from repro_torch.configs import get_arch
from repro_torch.configs.base import list_archs
from repro_torch.kernels import dispatch, ops

CHIP_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"


@pytest.mark.parametrize("arch", list_archs())
def test_count_params_and_model_flops_equal_the_reference(arch):
    port, ref = get_arch(arch), ref_arch(arch)
    for active in (False, True):
        assert R.count_params(port, active) == \
            ref_roofline.count_params(ref, active)
    for shp in SHAPES.values():
        mine = R.StepShape(shp.name, shp.seq_len, shp.global_batch, shp.kind)
        assert R.model_flops(port, mine) == ref_roofline.model_flops(ref, shp)


@pytest.mark.parametrize("inference", [False, True])
def test_op_cost_exact_on_a_matmul(inference):
    a, b = torch.ones(3, 4), torch.ones(4, 5)
    ctx = torch.inference_mode() if inference else contextlib.nullcontext()
    with ctx:
        cost = op_cost.step_cost(lambda: torch.matmul(a, b))
    assert cost.flops == {"fp32": 2 * 3 * 4 * 5}
    assert cost.hbm_bytes == (12 + 20 + 15) * 4
    assert cost.launches == {}


def test_op_cost_counts_a_kernel_by_its_formula():
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-4, 5, (4, 64), generator=g, dtype=torch.int8)
    w = torch.randint(-1, 2, (64, 128), generator=g, dtype=torch.int8)
    with torch.inference_mode():
        cost = op_cost.step_cost(lambda: ops.ternary_matmul(x, w))
    assert cost.launches == {"ternary_matmul": 1}
    assert cost.flops == {"int8": 2 * 4 * 128 * 64}
    assert cost.hbm_bytes == 4 * 64 + 64 * 128 + 4 * 4 * 128


def test_op_cost_decode_formula_reads_the_live_lengths():
    S, Hkv, G, D, page, maxp = 2, 2, 2, 16, 4, 3
    g = torch.Generator().manual_seed(0)
    q = torch.randn((S, Hkv, G, D), generator=g)
    pool = torch.randn((S * maxp + 1, page, Hkv, D), generator=g)
    tables = torch.arange(1, S * maxp + 1, dtype=torch.int32).reshape(S, -1)
    lengths = torch.tensor([5, 10], dtype=torch.int32)
    cost = op_cost.step_cost(lambda: dispatch.paged_attn_decode(
        q, pool, pool, tables, lengths))
    n_live = 6 + 11
    assert cost.launches == {"paged_attn_decode": 1}
    assert cost.flops == {"fp32": 4 * n_live * Hkv * G * D}
    assert cost.hbm_bytes == (2 * q.numel() * 4 + tables.numel() * 4
                              + S * 4 + 2 * n_live * 4 * Hkv * D)


def test_roofline_terms_and_bound():
    assert R.bound(3.35e12, 0, 1.0) == (1000.0, "bytes")
    assert R.bound(0, 989e12, R.BF16_OPS) == (1000.0, "operations")
    cost = op_cost.StepCost(flops={"bf16": 989e12, "int8": 1979e12},
                            hbm_bytes=3.35e12, wire_bytes=450e9)
    cfg = get_arch("granite-3-2b")
    rep = R.roofline_from_step(cost, cfg, R.StepShape("d", 1, 4, "decode"),
                               measured_s=4.0)
    assert rep.t_compute == pytest.approx(2.0)
    assert rep.t_memory == pytest.approx(1.0)
    assert rep.t_collective == pytest.approx(1.0)
    assert rep.bottleneck == "compute" and rep.bound_share == \
        pytest.approx(0.5)
    assert rep.model_flops_total == 2 * R.count_params(cfg, True) * 4


def test_report_formatting():
    assert report.fmt_s(0.0005) == "500.0us"
    assert report.fmt_s(0.002) == "2.0ms"
    assert report.fmt_s(3.0) == "3.00s"
    assert report.fmt_s(None) == "not measured"
    assert report.fmt_bytes(2 ** 31) == "2.00"
    rep = R.roofline_from_step(
        op_cost.StepCost(flops={"fp64": 67e9}, hbm_bytes=3.35e9),
        get_arch("granite-3-2b"), R.StepShape("decode 4", 256, 4, "decode"))
    table = report.roofline_table([rep.__dict__])
    lines = table.splitlines()
    assert lines[0].startswith("| arch | shape | mesh | t_compute")
    assert len(lines) == 3 and lines[2].count("|") == lines[0].count("|")
    assert "| **compute** |" in lines[2] or "| **memory** |" in lines[2]
    assert "not measured" in lines[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_mod",
                                                  CHIP_SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_takes_its_peaks_from_the_roofline():
    tree = ast.parse(CHIP_SMOKE.read_text())
    names = {"HBM_BPS", "BF16_OPS", "INT8_OPS", "FP32_OPS", "bound"}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            assert not {t.id for t in node.targets
                        if isinstance(t, ast.Name)} & names
        if isinstance(node, ast.FunctionDef):
            assert node.name != "bound"
    imported = {a.name for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)
                and n.module == "repro_torch.analysis.roofline"
                for a in n.names}
    assert names <= imported
    cs = _chip_smoke()
    assert (cs.HBM_BPS, cs.BF16_OPS, cs.INT8_OPS, cs.FP32_OPS) == (
        3.35e12, 989e12, 1979e12, 67e12)


def _old_bound(nbytes, ops_, rate):
    """chip_smoke.py's bound before it moved into the roofline."""
    t_bytes, t_ops = nbytes / 3.35e12 * 1e3, ops_ / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _old_kv(fmt, Hkv, D):
    return {"fp": 2 * Hkv * D, "int8": Hkv * D + 4 * Hkv,
            "sc": 2 * Hkv * D + 4 * Hkv}[fmt]


def test_chip_smoke_phase3_bounds_are_unchanged():
    cs = _chip_smoke()
    for rows, k in ((32768, 2048), (8192, 8192), (49408, 2048)):
        assert cs.kernel_bound(op_cost.approx_bsn_cost(rows, k)) == \
            _old_bound(rows * k * 4 + rows * 4, rows * k, 67e12)
    for _, m, k, n, bsl in cs.TERNARY_SHAPES:
        assert cs.kernel_bound(op_cost.ternary_cost(m, k, n, bsl)) == \
            _old_bound(m * k + k * n + 4 * m * n + 4 * n * bsl,
                       2 * m * n * k + m * n * bsl, 1979e12)
    for _, e, m, k, n in cs.BATCHED_SHAPES:
        assert cs.kernel_bound(op_cost.batched_ternary_cost(e, m, k, n)) \
            == _old_bound(e * k * n + e * m * k + 4 * e * m * n,
                          2 * e * m * n * k, 1979e12)
    for nbytes, rows, length in ((2 * 8192 * 16384, 8192, 16384),
                                 (2 * 4096 * 1024 * 4, 4096, 1024)):
        levels = length.bit_length() - 1
        ex = rows * (length // 2) * levels * (levels + 1) // 2
        assert cs.sort_bound(nbytes, rows, length) == \
            _old_bound(nbytes, 2 * ex, 67e12)
    Hkv, page = 8, 16
    for G, D, shapes in ((4, 64, cs._decode_shapes(page)),
                         (8, 128, cs.JAMBA_DECODE_SHAPES)):
        for _, S, maxp, lens in shapes:
            n_live = sum(n + 1 for n in lens)
            for fmt in ("fp", "int8", "sc"):
                q_numel, t_numel = S * Hkv * G * D, S * maxp
                new = cs.kernel_bound(op_cost.paged_decode_cost(
                    q_numel=q_numel, q_itemsize=2, table_numel=t_numel,
                    S=S, n_live=n_live, fmt=fmt, Hkv=Hkv, G=G, D=D))
                old = _old_bound(q_numel * 4 + t_numel * 4 + S * 4
                                 + 2 * n_live * _old_kv(fmt, Hkv, D),
                                 4 * n_live * Hkv * G * D, 989e12)
                assert new == old
    Gr, C = 4, 64
    for Gq, D, shapes in ((4, 64, cs.PREFILL_SHAPES),
                          (8, 128, cs.JAMBA_PREFILL_SHAPES)):
        for _, start, width in shapes:
            T = (start + C) // page * page
            pairs = sum(start + c + 1 for c in range(C))
            for fmt in ("fp", "int8", "sc"):
                q_numel = Gr * C * Hkv * Gq * D
                new = cs.kernel_bound(op_cost.paged_prefill_cost(
                    q_numel=q_numel, q_itemsize=2, table_numel=Gr * width,
                    G=Gr, C=C, Hkv=Hkv, Gq=Gq, D=D, start=start, fmt=fmt))
                old = _old_bound(q_numel * 4 + Gr * width * 4
                                 + 2 * Gr * T * _old_kv(fmt, Hkv, D),
                                 4 * Gr * pairs * Hkv * Gq * D, 989e12)
                assert new == old
    for shp, causal, isz in ((cs.FLASH_SHAPE, True, 2),
                             (cs.JAMBA_FLASH_SHAPE, True, 2),
                             (dict(B=1, S=1000, Hq=8, Hkv=2, D=64), False,
                              2),
                             (dict(B=1, S=1024, Hq=8, Hkv=2, D=64), True,
                              4)):
        B, S, Hq, Hkv_, D = (shp[k] for k in ("B", "S", "Hq", "Hkv", "D"))
        pairs = S * (S + 1) // 2 if causal else S * S
        old = _old_bound(isz * B * S * D * (2 * Hq + 2 * Hkv_)
                         + 4 * B * Hq * S, 4 * B * Hq * pairs * D,
                         989e12 if isz == 2 else 67e12)
        assert cs.flash_bound(**shp, causal=causal, itemsize=isz) == old

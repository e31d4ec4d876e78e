"""The port's hot-path contracts (``repro_torch.analysis.contracts``), each
pass run on executed steps of a tiny float32 engine on the CPU.

Clean cells: granite on (qat, fp), (sc_int, sc) and (sc_int_approx,
int8), and the retrace cell.  Each pass has an injection that trips it
and only it: an out-of-place pool update (``inplace``), a float product
in the MoE experts (``dtype``, after the reference's
``test_contracts.py``), quantization turned off (``dtype``'s engagement
check), a memo table that grows (``retrace``), a sync at a site off the
allowance list (``host``, fed its sites here; the card runs it for real
in ``tests/test_torch_cuda.py`` and chip_smoke.py phase 12), and a whole
K pool gathered every decode step on a (1, 2) gloo mesh (``sharding``,
clean and injected in one spawn of two local ranks).  The analysis CLI
runs its smoke gate.
"""

import json

import pytest
import torch

from port_fixtures import _one_torch_thread  # noqa: F401
from repro_torch.analysis import contracts as C
from repro_torch.analysis.__main__ import ENGINE, PROMPTS, SCALE, arch_cfgs
from repro_torch.configs import get_arch
from repro_torch.core.sc_layers import SC_OFF
from repro_torch.kernels import build
from repro_torch.models import attention, init_params, moe
from repro_torch.serving import ServeEngine

GRANITE = get_arch("granite-3-2b").scaled(n_layers=2, **SCALE)
QWEN = get_arch("qwen3-moe-235b-a22b").scaled(
    n_layers=2, **{**SCALE, "d_ff": 48}, n_experts=8, n_experts_per_tok=2,
    moe_group_size=16, moe_capacity_factor=4.0)


@pytest.fixture(scope="module")
def params():
    return init_params(GRANITE, torch.Generator().manual_seed(0), "cpu")


def _engine(params, cfg=GRANITE, datapath="qat", kv_format="fp"):
    return ServeEngine(params, cfg, datapath=datapath, kv_format=kv_format,
                       device="cpu", **ENGINE)


def _failing(results) -> set:
    return {r.passname for r in results if not r.ok}


def _messages(results) -> str:
    return " | ".join(v.message for r in results for v in r.violations)


@pytest.mark.parametrize("datapath,kv_format", [
    ("qat", "fp"), ("sc_int", "sc"), ("sc_int_approx", "int8")])
def test_clean_cell(params, datapath, kv_format):
    results = C.run_engine_contracts(_engine(params, datapath=datapath,
                                             kv_format=kv_format),
                                     f"granite/{datapath}/{kv_format}",
                                     PROMPTS)
    assert {r.passname for r in results} == {"inplace", "dtype", "host"}
    assert not _failing(results), _messages(results)
    notes = " ".join(n for r in results for n in r.notes)
    assert "exempt by design" in notes          # the exact prefill
    assert "needs the card" in notes            # host: not run here
    if datapath == "sc_int":
        assert "0 integer products" not in notes


def test_retrace_clean(params):
    r = C.audit_retrace("granite/live", _engine(params), PROMPTS)
    assert r.ok, r.violations
    assert "paged_attn_decode" in r.notes[0]


def test_inplace_injection_out_of_place_pool_update(params, monkeypatch):
    inner = attention._scatter_pools

    def out_of_place(pools, fmt, k_new, v_new, put):
        def put_copy(pool, val):
            put(pool.clone(), val)              # the write misses the pool
        return inner(pools, fmt, k_new, v_new, put_copy)
    monkeypatch.setattr(attention, "_scatter_pools", out_of_place)
    results = C.run_engine_contracts(_engine(params), "inject", PROMPTS)
    assert _failing(results) == {"inplace"}
    assert "models/attention.py" in _messages(results)
    assert "a copy of a pool" in _messages(results)


def test_inplace_injection_replaced_pool_leaf(params):
    eng = _engine(params)
    leaves = C.pool_leaves(eng.cache)
    before = {k: C._storage(v)[0] for k, v in leaves.items()}
    eng.cache["layers"][1]["v_pages"] = eng.cache["layers"][1][
        "v_pages"].clone()
    r = C.audit_inplace("inject", before, eng.cache, [], 1 << 30)
    assert not r.ok and "layers/1/v_pages was replaced" in \
        r.violations[0].message


def test_dtype_injection_float_expert_product(monkeypatch):
    p = init_params(QWEN, torch.Generator().manual_seed(0), "cpu")
    clean = C.run_engine_contracts(_engine(p, QWEN, "sc_int", "sc"),
                                   "qwen3/sc_int/sc", PROMPTS)
    assert not _failing(clean), _messages(clean)
    orig = moe._expert_matmul
    monkeypatch.setattr(moe, "_expert_matmul",
                        lambda p_, x, quant, **kw: orig(
                            p_, x, quant.with_mode("none"), **kw))
    results = C.run_engine_contracts(_engine(p, QWEN, "sc_int", "sc"),
                                     "inject/float-expert", PROMPTS)
    assert _failing(results) == {"dtype"}
    assert "models/moe.py:_expert_matmul" in _messages(results)
    assert "sc_int BSN region" in _messages(results)


def test_dtype_injection_quantization_off():
    cfg = GRANITE.scaled(quant=SC_OFF)
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    results = C.run_engine_contracts(_engine(p, cfg, "sc_int", "sc"),
                                     "inject/quant-off", PROMPTS)
    assert _failing(results) == {"dtype"}
    assert "not engaged" in _messages(results)


def test_retrace_injection_growing_memo(params, monkeypatch):
    monkeypatch.setattr(build, "_entries", {})
    eng = _engine(params)
    inner = eng.run_to_completion

    def growing(*a, **kw):
        build._entries[f"entry {len(build._entries)}"] = None
        return inner(*a, **kw)
    eng.run_to_completion = growing
    r = C.audit_retrace("inject/memo", eng, PROMPTS)
    assert not r.ok
    assert "kernels.build._entries grew" in r.violations[0].message


def test_host_pass_on_recorded_sites():
    ok = [("sync", ["serving/engine.py:_decode", "serving/engine.py:step"]),
          ("sync", ["serving/engine.py:_prefill_group"])]
    assert C.audit_host("clean", ok).ok
    bad = ok + [("sync", ["models/attention.py:attn_decode_paged",
                          "models/transformer.py:paged_decode_step"])]
    r = C.audit_host("inject", bad)
    assert not r.ok and len(r.violations) == 1
    assert "models/attention.py:attn_decode_paged" in r.violations[0].message
    # a step that shows no sync at all was not watched
    r = C.audit_host("unwatched", [])
    assert not r.ok and "not engaged" in r.violations[0].message


def test_sharding_clean_and_injected_in_one_spawn():
    from repro_torch.analysis.mesh import run_sharding_cells
    cfg = arch_cfgs()["granite"]
    out = run_sharding_cells([
        ("clean", cfg, "sc_int", "sc", None),
        ("inject", cfg, "sc_int", "sc", "gather-pool")])
    assert out["clean"]["ok"], out["clean"]
    notes = out["clean"]["passes"][0]["notes"][0]
    assert "12 pool leaves, 12 sharded" in notes
    bad = out["inject"]
    assert not bad["ok"]
    assert {p["pass"] for p in bad["passes"] if not p["ok"]} == {"sharding"}
    assert "above the budget" in bad["passes"][0]["violations"][0]["message"]


def test_analysis_cli_smoke_gate(tmp_path):
    from repro_torch.analysis.__main__ import main
    out = tmp_path / "report.json"
    assert main(["--smoke", "--gate", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["schema"] == 1 and report["ok"]
    assert report["card_only"] == {"host": report["card_only"]["host"]}
    assert len(report["kernel_audit"]["kernels"]) > 80
    assert set(report["cells"]) == {"granite/qat/fp", "granite/sc_int/sc",
                                    "granite/qat/fp/live",
                                    "granite/sc_int/sc/mesh1x2"}

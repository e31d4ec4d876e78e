"""The port's package contract: no JAX and no reference package inside
``src/repro_torch`` or ``chip_smoke.py``, entry points that refuse to run on the host without
being asked, and the engine's host-side bookkeeping and validation."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticClassification
from repro_torch.examples._qat_mlp import QatSpec, init_mlp, train_mlp
from repro_torch.models import init_paged_cache, init_params
from repro_torch.serving import (EngineConfig, PageAllocator, PageTable,
                                 ServeEngine, pad_pow2, pages_needed,
                                 sequential_generate)
from repro_torch.serving.paging import TRASH_PAGE
from repro_torch.launch.train import main as train_main
from repro_torch.weights import from_jax

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
TINY = get_arch("granite-3-2b").scaled(
    n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
    vocab_size=32, vocab_pad_multiple=32, dtype="float32")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax_or_the_reference():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 15
    # the card scripts at the root (chip_smoke.py, ...) drive the port
    files += sorted(PKG.parents[1].glob("chip_*.py"))
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (f, mod)


def test_importing_the_port_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.serving, "
            "repro_torch.weights, repro_torch.kernels.dispatch, "
            "repro_torch.kernels.build, repro_torch.kernels.ops, "
            "repro_torch.core.si, repro_torch.core.multiplier, "
            "repro_torch.optim, repro_torch.train, repro_torch.data, "
            "repro_torch.checkpoint, repro_torch.launch.train, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.examples.serve_sc; "
            "assert 'jax' not in sys.modules, 'jax'; "
            "assert 'repro' not in sys.modules, 'repro'")
    env = {"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_refuse_the_host_unless_asked(monkeypatch):
    """Without a card and without device='cpu', every entry point raises
    instead of quietly running the plain versions on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(TINY, gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_paged_cache(TINY, 1, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax({}, TINY)
    params = init_params(TINY, gen, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(params, TINY, max_len=16, page_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        sequential_generate(params, TINY, [[1, 2]], max_new_tokens=1)
    eng = ServeEngine(params, TINY, max_len=16, page_size=4, device="cpu")
    assert eng.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--arch", "granite-3-2b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticClassification().batch(0, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_mlp(prng.key(0), QatSpec())
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mlp(QatSpec(), steps=1, batch=2)


def test_engine_rejects_params_on_another_device():
    params = init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError):
        ServeEngine(params, TINY, device="meta")


def test_init_params_shapes_and_scales():
    cfg = TINY
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["embed"]["table"].shape == (cfg.padded_vocab, cfg.d_model)
    assert len(p["layers"]) == cfg.n_layers
    lp = p["layers"][0]
    assert lp["mixer"]["wk"]["w"].shape == (cfg.d_model,
                                            cfg.n_kv_heads * cfg.head_dim)
    assert lp["ffn"]["w_down"]["w"].shape == (cfg.d_ff, cfg.d_model)
    std = 1.0 / np.sqrt(cfg.d_ff)
    np.testing.assert_allclose(lp["ffn"]["w_down"]["alpha_w"].numpy(),
                               1.4 * std * 0.8, rtol=1e-6)
    assert float(lp["mixer"]["wq"]["alpha_a"]) == pytest.approx(1.0)
    assert float(lp["alpha_r1"]) == pytest.approx(0.05)
    assert p["lm_head"]["w"].shape == (cfg.d_model, cfg.padded_vocab)


def test_granite_full_width_config():
    cfg = get_arch("granite-3-2b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.padded_vocab,
            cfg.dtype) == (40, 2048, 32, 8, 64, 8192, 49155, 49408,
                           "bfloat16")
    assert cfg.quant.mode == "sc_qat" and cfg.quant.act_bsl == 8


@pytest.mark.parametrize("bad,match", [
    (dict(max_slots=0), "max_slots"),
    (dict(max_len=1), "max_len"),
    (dict(page_size=6), "power of two"),
    (dict(num_pages=1), "num_pages"),
    (dict(prefill_chunk=0), "prefill_chunk"),
    (dict(datapath="fp8"), "datapath"),
    (dict(kv_format="fp4"), "kv_format"),
    (dict(kv_format="sc", datapath="qat"), "SC datapaths"),
])
def test_engine_config_validation(bad, match):
    with pytest.raises(ValueError, match=match):
        EngineConfig(**bad).validate()


def test_submit_validation():
    params = init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(params, TINY, max_len=16, page_size=4, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        eng.submit([])
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit([1], max_new_tokens=0)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(list(range(16)))


def test_paging_bookkeeping():
    a = PageAllocator(6)
    assert a.free_count == 5
    t = PageTable(4)
    assert t.ensure(9, a) and len(t.pages) == 3
    assert TRASH_PAGE not in t.pages
    assert not t.ensure(40, a) and len(t.pages) == 3     # all-or-nothing
    row = t.padded(8)
    assert list(row[3:]) == [TRASH_PAGE] * 5
    t.release(a)
    assert a.free_count == 5
    with pytest.raises(ValueError):
        a.free([1])
    assert [pad_pow2(n) for n in (1, 3, 4, 5)] == [1, 4, 4, 8]
    assert pad_pow2(3, lo=8) == 8 and pad_pow2(6, hi=6) == 8
    assert pages_needed(9, 4) == 3 and pages_needed(0, 4) == 0

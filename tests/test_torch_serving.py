"""The port's ServeEngine against the JAX reference engine and against
its own sequential oracle.

Tiny granite-3-2b (2 layers, float32) with parameters carried over by
``weights.from_jax``; the prompts of ``tests/test_paged_kv.py``.  Greedy
tokens must be equal, for every valid datapath x kv_format pair.  The
reference engine runs its ``"reference"`` backends (the XLA gather
attention and the count-domain BSN oracle).
"""

import jax
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_arch
from repro_torch.serving import ServeEngine, sequential_generate
from repro_torch.weights import from_jax
from port_fixtures import _one_torch_thread  # noqa: F401


SCALE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=64, vocab_pad_multiple=32, dtype="float32")
JCFG = jget_arch("granite-3-2b").scaled(attn_q_chunk=8, **SCALE)
CFG = get_arch("granite-3-2b").scaled(**SCALE)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12, 13, 14]]
PAIRS = [("qat", "fp"), ("qat", "int8"), ("sc_int", "fp"),
         ("sc_int", "int8"), ("sc_int", "sc"), ("sc_int_approx", "fp"),
         ("sc_int_approx", "int8"), ("sc_int_approx", "sc")]
ENGINE = dict(max_slots=2, max_len=32, page_size=4)


@pytest.fixture(scope="module")
def params():
    jp = jinit_params(jax.random.key(0), JCFG)
    return jp, from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")


def _tokens(done):
    return [r.generated for r in sorted(done, key=lambda r: r.rid)]


def _port_tokens(tp, datapath, fmt, max_new=5, prompts=PROMPTS, **kw):
    eng = ServeEngine(tp, CFG, datapath=datapath, kv_format=fmt,
                      device="cpu", **{**ENGINE, **kw})
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    done = eng.run_to_completion()
    assert len(done) == len(prompts)
    return _tokens(done)


@pytest.mark.parametrize("datapath,fmt", PAIRS)
def test_engine_tokens_equal_reference_engine(params, datapath, fmt):
    """4 prompts through 2 slots: admission, queueing, slot reuse and
    pow2 buckets on both sides."""
    jp, tp = params
    jeng = JServeEngine(jp, JCFG, datapath=datapath, kv_format=fmt,
                        bsn_backend="reference", attn_backend="reference",
                        **ENGINE)
    for p in PROMPTS:
        jeng.submit(p, max_new_tokens=5)
    want = _tokens(jeng.run_to_completion())
    assert _port_tokens(tp, datapath, fmt) == want


@pytest.mark.parametrize("datapath,fmt", PAIRS)
def test_engine_tokens_equal_sequential_generate(params, datapath, fmt):
    """Batched == one request at a time, with a page size (8) different
    from the engine's (4) and a chunked prefill (chunk 4 < prompt bucket
    8) on the engine side."""
    _, tp = params
    prompts = PROMPTS + [[3, 1, 4, 1, 5, 9, 2, 6]]
    got = _port_tokens(tp, datapath, fmt, max_new=6, prompts=prompts,
                       prefill_chunk=4)
    want = sequential_generate(tp, CFG, prompts, max_new_tokens=6,
                               max_len=32, datapath=datapath,
                               kv_format=fmt, page_size=8, device="cpu")
    assert got == want


def test_preemption_under_pool_pressure_keeps_tokens(params):
    """2 slots x up to 24 tokens need 6 pages of 8; a pool of 4 (+ trash)
    forces preemption and re-prefill, and greedy decode regenerates the
    same tokens (the reference's test_preemption_under_page_pressure)."""
    _, tp = params
    prompts = [[1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13]]
    eng = ServeEngine(tp, CFG, max_slots=2, max_len=24, page_size=8,
                      num_pages=5, datapath="sc_int", kv_format="int8",
                      device="cpu")
    for p in prompts:
        eng.submit(p, max_new_tokens=12)
    got = _tokens(eng.run_to_completion())
    want = sequential_generate(tp, CFG, prompts, max_new_tokens=12,
                               max_len=24, datapath="sc_int",
                               kv_format="int8", device="cpu")
    assert got == want


def test_stop_rules_match_sequential(params):
    """eos and the max_len - 1 boundary stop the engine where the oracle
    stops."""
    _, tp = params
    prompts = [list(range(1, 15)), list(range(1, 16)), [5, 6, 7]]
    eng = ServeEngine(tp, CFG, max_slots=2, max_len=16, page_size=4,
                      device="cpu")
    first = sequential_generate(tp, CFG, [prompts[2]], max_new_tokens=8,
                                max_len=16, device="cpu")[0]
    eos = first[2]
    for p in prompts:
        eng.submit(p, max_new_tokens=8, eos_id=eos)
    got = _tokens(eng.run_to_completion())
    want = sequential_generate(tp, CFG, prompts, max_new_tokens=8,
                               max_len=16, eos_id=eos, device="cpu")
    assert got == want
    assert len(got[1]) == 1 and got[2][-1] == eos

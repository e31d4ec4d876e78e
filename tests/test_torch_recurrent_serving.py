"""The recurrent archs through the port's ``ServeEngine`` against the JAX
engine and the port's own ``sequential_generate``: tiny rwkv6-7b and
jamba-1.5-large-398b (``REDUCED`` of ``tests/test_models_smoke.py``,
float32, parameters carried over by ``weights.from_jax``, mamba's
``conv_w`` at 10x the reference's draw so that the SSM state is live;
see ``tests/test_torch_recurrent.py``), on qat x fp, sc_int x int8 and
sc_int_approx x sc.

Greedy tokens must be equal.  On the qat pair a token decided by an
exact tie on the fake-quant lattice may part from the JAX engine's (the
port's float64 product keeps the tie, the reference's float32 sum breaks
it by rounding: ROADMAP Queue 3 item 10); the test then holds the JAX
engine's whole sequence greedy under the port's own logits along it,
within the qat logits tolerance 5e-5 of ``tests/test_torch_recurrent.py``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_arch
from repro_torch.models import (init_paged_cache, paged_decode_step,
                                paged_prefill)
from repro_torch.serving import ServeEngine, sequential_generate
from repro_torch.weights import from_jax
from port_fixtures import _one_torch_thread  # noqa: F401


QAT_ATOL = 5e-5
ARCHS = ("rwkv6-7b", "jamba-1.5-large-398b")
PAIRS = [("qat", "fp"), ("sc_int", "int8"), ("sc_int_approx", "sc")]
REDUCED = {
    "rwkv6-7b": dict(n_layers=2, d_model=64, d_ff=128, vocab_size=131,
                     n_heads=4, n_kv_heads=4, rwkv_head_dim=16),
    "jamba-1.5-large-398b": dict(n_layers=8, d_model=64, n_heads=4,
                                 n_kv_heads=2, d_ff=96, vocab_size=131,
                                 n_experts=4, n_experts_per_tok=2,
                                 mamba_d_state=8, moe_group_size=16,
                                 moe_capacity_factor=2.0)}
COMMON = dict(dtype="float32", vocab_pad_multiple=32)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12, 13, 14]]
ENGINE = dict(max_slots=2, max_len=32, page_size=4)


def _model_cfgs(arch):
    return (jget_arch(arch).scaled(attn_q_chunk=8, **COMMON, **REDUCED[arch]),
            get_arch(arch).scaled(**COMMON, **REDUCED[arch]))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jc, c = _model_cfgs(request.param)
    jp = jinit_params(jax.random.key(0), jc)
    periods = {name: dict(pp, mixer=dict(pp["mixer"],
                                         conv_w=pp["mixer"]["conv_w"] * 10))
               if "conv_w" in pp["mixer"] else pp
               for name, pp in jp["periods"].items()}
    jp = dict(jp, periods=periods)
    return (request.param, jp,
            from_jax(jax.tree.map(np.asarray, jp), c, device="cpu"))


def _tokens(done):
    return [r.generated for r in sorted(done, key=lambda r: r.rid)]


def _forced_logits(tp, c, prompt, tokens, datapath, fmt, page=8):
    """The port's logits at each generated position of ``prompt`` followed
    by ``tokens`` (teacher forcing), through ``paged_prefill`` and
    ``paged_decode_step`` on a single-slot cache, as
    ``sequential_generate`` runs them."""
    from repro_torch.serving.engine import _cfg_for_datapath
    from repro_torch.serving.paging import pad_pow2
    c = _cfg_for_datapath(c, datapath)
    L = pad_pow2(max(len(prompt), page))
    maxp = max(32 // page, L // page)
    cache = init_paged_cache(c, 1, maxp + 1, page, fmt, device="cpu")
    tables = torch.arange(1, maxp + 1, dtype=torch.int32)[None, :]
    slot = torch.zeros((1,), dtype=torch.int32)
    toks = torch.zeros((1, L), dtype=torch.int32)
    toks[0, :len(prompt)] = torch.tensor(prompt)
    with torch.inference_mode():
        lg, cache = paged_prefill(tp, cache, toks, tables,
                                  torch.tensor([len(prompt)]), c, chunk=L,
                                  slot_ids=slot)
        out = [lg[0, :c.vocab_size]]
        for i, t in enumerate(tokens[:-1]):
            lg, cache = paged_decode_step(
                tp, cache, torch.tensor([t], dtype=torch.int32), slot,
                tables, torch.tensor([len(prompt) + i], dtype=torch.int32),
                c)
            out.append(lg[0, :c.vocab_size])
    return out


@pytest.mark.parametrize("datapath,fmt", PAIRS)
def test_engine_tokens_equal_reference_engine(model, datapath, fmt):
    """Greedy tokens equal the JAX engine's.  One exception, on the qat
    pair only: a token that an exact tie on the fake-quant lattice decides
    (logits ``alpha_a * alpha_w * n`` with the same integer n; the port's
    float64 product keeps the tie and takes the lower id, the reference's
    float32 sum breaks it by rounding, ROADMAP Queue 3 item 10).  There the
    reference's whole sequence must be greedy under the port's own logits
    along it, within the qat tolerance, and must part from the port's
    only at such a tie."""
    arch, jp, tp = model
    jc, c = _model_cfgs(arch)
    jeng = JServeEngine(jp, jc, datapath=datapath, kv_format=fmt,
                        bsn_backend="reference", attn_backend="reference",
                        **ENGINE)
    eng = ServeEngine(tp, c, datapath=datapath, kv_format=fmt, device="cpu",
                      **ENGINE)
    for p in PROMPTS:
        jeng.submit(p, max_new_tokens=5)
        eng.submit(p, max_new_tokens=5)
    got = _tokens(eng.run_to_completion())
    want = _tokens(jeng.run_to_completion())
    if datapath != "qat":
        assert got == want
        return
    for prompt, g, w in zip(PROMPTS, got, want):
        if g == w:
            continue
        logits = _forced_logits(tp, c, prompt, w, datapath, fmt)
        first = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        for i, (lg, t) in enumerate(zip(logits, w)):
            assert float(lg[t]) >= float(lg.max()) - QAT_ATOL, (prompt, i)
        lg = logits[first]
        assert float(lg[g[first]]) == float(lg[w[first]]) == \
            float(lg.max()), (prompt, first)


@pytest.mark.parametrize("datapath,fmt", PAIRS)
def test_engine_tokens_equal_sequential_generate(model, datapath, fmt):
    arch, _, tp = model
    _, c = _model_cfgs(arch)
    prompts = PROMPTS + [[3, 1, 4, 1, 5, 9, 2, 6]]
    eng = ServeEngine(tp, c, datapath=datapath, kv_format=fmt, device="cpu",
                      prefill_chunk=4, **ENGINE)
    for p in prompts:
        eng.submit(p, max_new_tokens=6)
    assert _tokens(eng.run_to_completion()) == sequential_generate(
        tp, c, prompts, max_new_tokens=6, max_len=32, datapath=datapath,
        kv_format=fmt, page_size=8, device="cpu")


def test_preempted_request_reprefills_from_zero_state(model):
    """2 slots x up to 24 tokens need 6 pages of 8; a pool of 4 (+ trash)
    forces preemption: the victim's slot rows are rebuilt by a fresh
    prefill from zero state, and its tokens still equal the oracle's (the
    reference's test_recurrent_preemption_under_page_pressure)."""
    arch, _, tp = model
    _, c = _model_cfgs(arch)
    prompts = [[1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13]]
    eng = ServeEngine(tp, c, max_slots=2, max_len=24, page_size=8,
                      num_pages=5, datapath="sc_int", kv_format="int8",
                      device="cpu")
    for p in prompts:
        eng.submit(p, max_new_tokens=12)
    preempted = []
    grow = eng._grow_or_preempt

    def watch(active):
        before = {r.rid for r in eng.slots if r is not None}
        out = grow(active)
        preempted.extend(before - {r.rid for r in eng.slots
                                   if r is not None})
        return out
    eng._grow_or_preempt = watch
    got = _tokens(eng.run_to_completion())
    assert preempted, "the pool was meant to force a preemption"
    assert got == sequential_generate(
        tp, c, prompts, max_new_tokens=12, max_len=24, datapath="sc_int",
        kv_format="int8", device="cpu")


def test_padded_lanes_write_only_the_scratch_row(model):
    """Three requests in four slots: the prefill bucket and every decode
    step carry one padded lane, which writes the scratch row (slot 4)
    and never the free slot 3, whose rows stay zero."""
    arch, _, tp = model
    _, c = _model_cfgs(arch)
    eng = ServeEngine(tp, c, max_slots=4, max_len=32, page_size=4,
                      datapath="sc_int", kv_format="int8", device="cpu")
    for p in PROMPTS[:3]:
        eng.submit(p, max_new_tokens=4)
    for _ in range(3):
        eng.step()
        for e in eng.cache["layers"]:
            for k in ("h", "conv", "s", "shift"):
                if k in e:
                    assert not e[k][3].any(), k
                    assert e[k][4].any() and e[k][0].any(), k

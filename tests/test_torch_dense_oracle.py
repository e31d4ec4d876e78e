"""The dense fp oracle of the port's ``sequential_generate`` and
``ServeEngine(prefill_mode="exact")`` against the JAX reference's, and
against the port's own chunked engine.  The dense entry points under
them are held in ``tests/test_torch_dense_cache.py``, whose models
(``REDUCED`` of ``tests/test_models_smoke.py``, float32, parameters from
the reference's ``init_params`` carried over by ``weights.from_jax``;
mamba's ``conv_w`` at 10x the reference's draw, so that the SSM state is
live) and helpers this file shares (the two files are one suite, cut in
two so that two workers share it).

Tokens: equal.  Against the reference on the qat datapath, a token that
an exact tie on the fake-quant lattice decides may part (ROADMAP Queue 3
item 10): the reference's whole sequence must then be greedy under the
port's own dense logits along it, within 5e-5, and the first parting
token must be an exact tie there.  On a compressed cache the exact
prefill's attention reads the float K / V where the chunked prefill
reads them quantized from the pools, in both packages, so exact ==
chunked is held there only without attention layers (ROADMAP Queue 3
item 11); exact == the reference's exact everywhere.
"""

import functools

import jax
import pytest
import torch

from repro.models import init_params as jinit_params
from repro.serving import ServeEngine as JServeEngine
from repro.serving import sequential_generate as jsequential_generate
from repro_torch.models import decode_step, prefill
from repro_torch.serving import EngineConfig, ServeEngine, sequential_generate
from repro_torch.serving.engine import _cfg_for_datapath, _pad_prefill_cache
from repro_torch.weights import from_jax
from port_fixtures import _one_torch_thread  # noqa: F401
from test_torch_dense_cache import SERVED, _cfgs, _live_ssm, _np

PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12, 13, 14]]
ENGINE = dict(max_slots=2, max_len=32, page_size=4)
QAT_ATOL = 5e-5


# ---------------------------------------------------------------------------
# the dense oracle and the exact-prefill engine
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _served(arch):
    """(arch, reference params, port params) of a served tiny model."""
    jc, c = _cfgs(arch)
    jp = _live_ssm(jinit_params(jax.random.key(0), jc))
    return arch, jp, from_jax(_np(jp), c, device="cpu")


@pytest.fixture(scope="module", params=SERVED)
def served(request):
    return _served(request.param)


# jamba (eight layers: attention, mamba, MoE) on one datapath / pair only:
# its reference runs are the slowest of the file
DENSE_ORACLE_CASES = [(a, d) for a in SERVED[:2]
                      for d in ("qat", "sc_int", "sc_int_approx")] + \
    [(SERVED[2], "qat")]
EXACT_CASES = [(a, d, f) for a in SERVED[:2]
               for d, f in (("qat", "fp"), ("sc_int", "int8"))] + \
    [(SERVED[2], "qat", "fp")]


def _forced_dense_logits(tp, c, prompt, tokens):
    """The port's logits at each generated position of ``prompt`` followed
    by ``tokens`` (teacher forcing) on the dense path, as the dense
    ``sequential_generate`` runs them."""
    with torch.inference_mode():
        lg, cache = prefill(tp, {"tokens": torch.tensor([prompt])}, c)
        cache = _pad_prefill_cache(cache, ENGINE["max_len"])
        out = [lg[0, -1, :c.vocab_size]]
        for t in tokens[:-1]:
            lg, cache = decode_step(tp, cache, torch.tensor([[t]]), c)
            out.append(lg[0, 0, :c.vocab_size])
    return out


def _same_or_lattice_tie(tp, c, got, want, datapath):
    """``got`` (the port's tokens) equal ``want`` (the reference's), or on
    the qat datapath part only at an exact lattice tie (module
    docstring)."""
    if datapath != "qat":
        assert got == want
        return
    c = _cfg_for_datapath(c, datapath)
    for prompt, g, w in zip(PROMPTS, got, want):
        if g == w:
            continue
        logits = _forced_dense_logits(tp, c, prompt, w)
        first = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        for i, (lg, t) in enumerate(zip(logits, w)):
            assert float(lg[t]) >= float(lg.max()) - QAT_ATOL, (prompt, i)
        lg = logits[first]
        assert float(lg[g[first]]) == float(lg[w[first]]) == \
            float(lg.max()), (prompt, first)


@pytest.mark.parametrize("arch,datapath", DENSE_ORACLE_CASES)
def test_dense_sequential_generate_equals_reference(arch, datapath):
    """``kv_format="fp"`` runs the dense cache on both sides."""
    arch, jp, tp = _served(arch)
    jc, c = _cfgs(arch)
    want = jsequential_generate(jp, jc, PROMPTS, max_new_tokens=5,
                                max_len=32, bsn_backend="reference",
                                datapath=datapath)
    got = sequential_generate(tp, c, PROMPTS, max_new_tokens=5, max_len=32,
                              datapath=datapath, device="cpu")
    _same_or_lattice_tie(tp, c, got, want, datapath)


def test_sequential_generate_fp_runs_the_dense_path(served, monkeypatch):
    """The fp oracle calls ``prefill`` / ``decode_step`` and never the
    paged entry points; the compressed formats the reverse."""
    from repro_torch.serving import engine
    _, _, tp = served
    _, c = _cfgs(served[0])
    calls = []
    for name in ("prefill", "decode_step", "paged_prefill",
                 "paged_decode_step"):
        fn = getattr(engine, name)
        monkeypatch.setattr(engine, name, lambda *a, _f=fn, _n=name, **k:
                            (calls.append(_n), _f(*a, **k))[1])
    sequential_generate(tp, c, PROMPTS[:1], max_new_tokens=3, max_len=32,
                        device="cpu")
    assert set(calls) == {"prefill", "decode_step"}
    calls.clear()
    sequential_generate(tp, c, PROMPTS[:1], max_new_tokens=3, max_len=32,
                        datapath="sc_int", kv_format="int8", device="cpu")
    assert set(calls) == {"paged_prefill", "paged_decode_step"}


def _engine_tokens(tp, c, datapath, fmt, **kw):
    eng = ServeEngine(tp, c, datapath=datapath, kv_format=fmt, device="cpu",
                      **{**ENGINE, **kw})
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=5)
    return [r.generated for r in sorted(eng.run_to_completion(),
                                        key=lambda r: r.rid)]


@pytest.mark.parametrize("arch,datapath,fmt", EXACT_CASES)
def test_exact_prefill_mode_equals_chunked_and_reference(arch, datapath,
                                                         fmt):
    """``prefill_mode="exact"`` tokens == the chunked engine's (int8:
    where no layer is attention) == the reference's exact engine's (the
    lattice-tie rule on qat)."""
    arch, jp, tp = _served(arch)
    jc, c = _cfgs(arch)
    exact = _engine_tokens(tp, c, datapath, fmt, prefill_mode="exact")
    chunked = _engine_tokens(tp, c, datapath, fmt, prefill_chunk=4)
    if fmt == "fp" or not c.has_mixer("attn"):
        assert exact == chunked
    jeng = JServeEngine(jp, jc, datapath=datapath, kv_format=fmt,
                        bsn_backend="reference", attn_backend="reference",
                        prefill_mode="exact", **ENGINE)
    for p in PROMPTS:
        jeng.submit(p, max_new_tokens=5)
    want = [r.generated for r in sorted(jeng.run_to_completion(),
                                        key=lambda r: r.rid)]
    _same_or_lattice_tie(tp, c, exact, want, datapath)


def test_exact_prefill_scatter_fills_pages_and_rows(served):
    """After an exact prefill, the request's pages hold the dense K / V
    (int8 codes and scales per position, zero past the prompt) and its
    slot's rows the dense final state; other slots' rows stay zero."""
    from repro_torch.core.kv_quant import kv_quant
    arch, _, tp = served
    _, c = _cfgs(arch)
    c = _cfg_for_datapath(c, "sc_int")
    eng = ServeEngine(tp, c, datapath="sc_int", kv_format="int8",
                      device="cpu", prefill_mode="exact", max_slots=3,
                      max_len=32, page_size=4)
    prompt = PROMPTS[3]
    eng.submit(PROMPTS[0], max_new_tokens=2)
    eng.submit(prompt, max_new_tokens=2)
    eng._admit()
    req = eng.slots[1]
    with torch.inference_mode():
        _, dense = prefill(tp, {"tokens": torch.tensor([prompt])}, c)
    pages = torch.tensor(req._table.pages[:2])
    for e, d in zip(eng.cache["layers"], dense["layers"]):
        if "k" in d:
            q = kv_quant(d["k"][0], "int8")
            got = e["k_pages"][pages].reshape(8, *q["q"].shape[1:])
            assert torch.equal(got[:5], q["q"])
            assert not got[5:].any()
            assert torch.equal(e["k_scale"][pages].reshape(8, -1)[:5],
                               q["scale"])
        for k in ("h", "conv", "s", "shift"):
            if k in d:
                assert torch.equal(e[k][1], d[k][0].to(e[k].dtype)), k
                assert not e[k][2].any(), k


@pytest.mark.parametrize("fmt", ["fp", "int8"])
def test_exact_prefill_tail_never_attends(fmt):
    """The reference's poison test on the exact path: every pool position
    a request does not own holds a huge value (int8: codes and scales)
    before and after the exact prefill; tokens still equal an unpoisoned
    exact engine's, and for fp the oracle's."""
    _, c = _cfgs("granite-3-2b")
    from repro_torch.models import init_params
    tp = init_params(c, torch.Generator().manual_seed(0), "cpu")
    page = 4
    for plen in (1, 3, 4, 6):
        prompts = [[(2 * plen + j) % 64 for j in range(plen)], [9, 10]]

        def engine():
            eng = ServeEngine(tp, c, max_slots=2, max_len=16,
                              page_size=page, kv_format=fmt,
                              prefill_mode="exact", device="cpu")
            for p in prompts:
                eng.submit(p, max_new_tokens=4)
            return eng
        clean = [r.generated for r in sorted(engine().run_to_completion(),
                                             key=lambda r: r.rid)]
        eng = engine()

        def poison(keep):
            for e in eng.cache["layers"]:
                for name, val in (("k_pages", 100), ("v_pages", 100),
                                  ("k_scale", 1e4), ("v_scale", 1e4)):
                    if name not in e:
                        continue
                    pool = e[name]
                    for pg in range(pool.shape[0]):
                        for off in range(page):
                            if (pg, off) not in keep:
                                pool[pg, off] = val
        poison(set())
        eng._admit()
        keep = {(r._table.pages[t // page], t % page)
                for r in eng.slots if r is not None
                for t in range(len(r.prompt))}
        poison(keep)
        got = [r.generated for r in sorted(eng.run_to_completion(),
                                           key=lambda r: r.rid)]
        assert got == clean, plen
        if fmt == "fp":
            assert got == sequential_generate(tp, c, prompts,
                                              max_new_tokens=4, max_len=16,
                                              device="cpu"), plen


def test_prefill_mode_is_validated():
    with pytest.raises(ValueError, match="prefill_mode"):
        EngineConfig(prefill_mode="eager").validate()
    assert EngineConfig(prefill_mode="exact").validate().prefill_mode == \
        "exact"

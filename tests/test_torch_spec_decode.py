"""The port's speculative decoding against ``repro.serving``'s.

* The acceptance rule: the prefix law and ``speculative_accept`` equal to
  the reference's; the coupled emission keeps the target's marginal
  (chi-square), and a drafter equal to the target is always accepted.
* The verify window: ``dispatch.paged_attn_verify`` row t equals
  ``paged_attn_decode`` at length ``lengths + t`` bit for bit, and the
  reference's one-pass verify within 1e-5;
  ``paged_verify_step`` from the reference's own cache (``cache_from_jax``)
  gives its logits within 1e-5 (5e-5 on qat, as
  ``tests/test_torch_recurrent.py``) and ``select_state_snapshot`` its
  state rows within the same tolerance, on tiny granite and jamba.
* The engine: spec-on == spec-off (== the sequential oracle), greedy and
  seeded-sampled, on qat and sc_int, on tiny granite and jamba (whose MoE
  layers need cf >= E / k: 2.0 here); spec logprobs equal plain
  logprobs; the window falls back to plain decode near ``max_len`` and
  under pool pressure; ``EngineConfig`` validation.

The sampled lanes follow jax with ``jax_threefry_partitionable`` on; the
module fixture pins it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro.models import init_params as jinit_params
from repro.models import transformer as jtf
from repro.serving import sampling as jsampling
from repro_torch.configs import get_arch
from repro_torch.kernels import dispatch
from repro_torch.models import (init_paged_cache, paged_decode_step,
                                paged_verify_step, scatter_state_rows,
                                select_state_snapshot)
from repro_torch.serving import (EngineConfig, SamplingParams, ServeEngine,
                                 sequential_generate)
from repro_torch.serving import sampling
from repro_torch.serving.engine import _cfg_for_datapath
from repro_torch.tree import tree_map
from repro_torch.weights import cache_from_jax, from_jax
from port_fixtures import _one_torch_thread, _partitionable  # noqa: F401


ATOL = 1e-5
QAT_ATOL = 5e-5
COMMON = dict(dtype="float32", vocab_pad_multiple=32)
SCALE = {"granite-3-2b": dict(n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=2, d_ff=128, vocab_size=64),
         # REDUCED of tests/test_models_smoke.py: one whole period
         "jamba-1.5-large-398b": dict(n_layers=8, d_model=64, n_heads=4,
                                      n_kv_heads=2, d_ff=96, vocab_size=131,
                                      n_experts=4, n_experts_per_tok=2,
                                      mamba_d_state=8, moe_group_size=16,
                                      moe_capacity_factor=2.0)}
ARCHS = tuple(SCALE)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]
SAMPLED = [SamplingParams(temperature=0.9, top_k=8, seed=42 + i)
           for i in range(len(PROMPTS))]
ENGINE = dict(max_slots=4, max_len=64, page_size=8)


def _cfgs(arch):
    return (jget_arch(arch).scaled(attn_q_chunk=8, **COMMON, **SCALE[arch]),
            get_arch(arch).scaled(**COMMON, **SCALE[arch]))


_MODELS: dict = {}


def _model(arch):
    """The reference's params (mamba's ``conv_w`` at 10x its draw, so that
    the SSM state is live: ``tests/test_torch_recurrent.py``) and the
    port's copy."""
    if arch not in _MODELS:
        jc, c = _cfgs(arch)
        jp = jinit_params(jax.random.key(0), jc)
        periods = {name: dict(pp, mixer=dict(
            pp["mixer"], conv_w=pp["mixer"]["conv_w"] * 10))
            if "conv_w" in pp["mixer"] else pp
            for name, pp in jp["periods"].items()}
        jp = dict(jp, periods=periods)
        _MODELS[arch] = jp, from_jax(jax.tree.map(np.asarray, jp), c,
                                     device="cpu")
    return _MODELS[arch]


_RUNS: dict = {}


def _run(arch, datapath, spec, sps=None, max_new=8, draft_len=3, **kw):
    """The engine's requests over PROMPTS (memoized: several tests share
    a spec-off baseline)."""
    key = (arch, datapath, spec, tuple(sps) if sps else None, max_new,
           draft_len, tuple(sorted(kw.items())))
    if key not in _RUNS:
        _, tp = _model(arch)
        eng = ServeEngine(tp, _cfgs(arch)[1], datapath=datapath,
                          spec_decode=spec, draft_len=draft_len,
                          device="cpu", **{**ENGINE, **kw})
        for p, sp in zip(PROMPTS, sps or [None] * len(PROMPTS)):
            eng.submit(p, max_new_tokens=max_new, sampling=sp)
        done = sorted(eng.run_to_completion(), key=lambda r: r.rid)
        assert len(done) == len(PROMPTS)
        _RUNS[key] = done, eng
    return _RUNS[key]


def _tokens(done):
    return [r.generated for r in done]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# the acceptance rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,i,seed", [(1, 0, 0), (1, 1, 1), (4, 0, 2),
                                      (4, 2, 3), (4, 4, 4), (8, 7, 5),
                                      (8, 3, 6), (8, 8, 7)])
def test_accept_prefix_law(k, i, seed):
    """m is the first index where draft and target differ (k if nowhere);
    differences after the first do not count.  Equal to the
    reference's."""
    rng = np.random.default_rng(seed)
    draft = rng.integers(0, 64, size=(1, k)).astype(np.int32)
    target = draft.copy()
    if i < k:
        target[0, i] = (target[0, i] + 1 + rng.integers(0, 62)) % 64
        target[0, i + 1:] = rng.integers(0, 64, size=k - i - 1)
    m = sampling.speculative_accept(_t(draft), _t(target))
    assert m.dtype == torch.int32 and int(m[0]) == min(i, k)
    assert int(m[0]) == int(jsampling.speculative_accept(
        jnp.asarray(draft), jnp.asarray(target))[0])


def test_accept_is_per_lane():
    draft = torch.tensor([[5, 6, 7], [5, 6, 7], [5, 6, 7]])
    target = torch.tensor([[5, 6, 7], [5, 9, 7], [9, 6, 7]])
    assert sampling.speculative_accept(draft, target).tolist() == [3, 1, 0]


def test_coupled_emission_preserves_target_marginal():
    """Draft and target draws share the Gumbel noise of (seed, position):
    the emitted token is always the target's draw, whose marginal is the
    target's softmax (chi-square over 8 bins, 24.32 the 99.9% point), a
    drafter equal to the target agrees always, and an unrelated drafter
    agrees far more often than independent draws would."""
    V, N = 8, 4096
    rng = np.random.default_rng(7)
    lt = rng.normal(size=V).astype(np.float32) * 1.5
    ld = rng.normal(size=V).astype(np.float32) * 1.5
    samp = sampling.pack_sampling([SamplingParams(temperature=1.0, seed=s)
                                   for s in range(N)])
    pos = torch.full((N,), 11)
    tau = sampling.sample_tokens(_t(lt).expand(N, V), pos, samp, V).numpy()
    d = sampling.sample_tokens(_t(ld).expand(N, V), pos, samp, V).numpy()
    assert np.array_equal(
        sampling.sample_tokens(_t(lt).expand(N, V), pos, samp, V).numpy(),
        tau)
    p = np.exp(lt - lt.max())
    p /= p.sum()
    obs = np.bincount(tau, minlength=V).astype(np.float64)
    chi2 = float(((obs - N * p) ** 2 / (N * p)).sum())
    assert chi2 < 24.32, (chi2, obs.tolist())
    pd = np.exp(ld - ld.max())
    pd /= pd.sum()
    assert float((d == tau).mean()) > float((pd * p).sum()) + 0.1


# ---------------------------------------------------------------------------
# the verify window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
def test_verify_ref_rows_equal_decode_ref(fmt):
    """Query t of the window is a decode at length lengths + t, bit for
    bit, and the window equals the reference's ``paged_attn_verify_ref``."""
    from repro.core.kv_quant import kv_quant as jkv_quant
    rng = np.random.default_rng(11)
    S, T, Hkv, G, D, page, maxp = 3, 4, 2, 2, 16, 4, 4
    N = S * maxp + 1
    kv = rng.normal(size=(2, N, page, Hkv, D)).astype(np.float32)
    pools = {}
    for name, val in zip("kv", kv):
        qd = {k: np.asarray(v) for k, v in jkv_quant(jnp.asarray(val),
                                                      fmt).items()}
        pools[f"{name}_pages"] = qd["q"]
        for part in ("scale", "resid"):
            if part in qd:
                pools[f"{name}_{part}"] = qd[part]
    aux = {k: v for k, v in pools.items() if not k.endswith("pages")}
    tables = (1 + rng.permutation(S * maxp).reshape(S, maxp)).astype(
        np.int32)
    lengths = np.array([0, 5, 11], np.int32)
    q = rng.normal(size=(S, T, Hkv, G, D)).astype(np.float32)
    taux = {k: _t(v) for k, v in aux.items()}
    got = dispatch.paged_attn_verify(
        _t(q), _t(pools["k_pages"]), _t(pools["v_pages"]), _t(tables),
        _t(lengths), kv_format=fmt, kv_aux=taux)
    want = jref.paged_attn_verify_ref(
        jnp.asarray(q), jnp.asarray(pools["k_pages"]),
        jnp.asarray(pools["v_pages"]), jnp.asarray(tables),
        jnp.asarray(lengths), kv_format=fmt,
        kv_aux={k: jnp.asarray(v) for k, v in aux.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    for t in range(T):
        row = dispatch.paged_attn_decode(
            _t(q[:, t]), _t(pools["k_pages"]), _t(pools["v_pages"]),
            _t(tables), _t(lengths + t), kv_format=fmt, kv_aux=taux)
        np.testing.assert_array_equal(got[:, t].numpy(), row.numpy())


def _jsnap_layer(jsnaps, cfg, i):
    """Layer i's snapshot leaves (T, S, ...) from the reference's
    ``{"p{j}": leaves (n_periods, T, S, ...)}``."""
    P = len(cfg.period)
    return jax.tree.map(lambda a: np.asarray(a)[i // P],
                        jsnaps[f"p{i % P}"])


@pytest.mark.parametrize("datapath,fmt", [("qat", "fp"), ("sc_int", "int8"),
                                          ("sc_int_approx", "sc")])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_verify_step_equals_reference(arch, datapath, fmt):
    """Two lanes prefilled by the reference (5 and 8 tokens, slots 1 and
    0), then a window of 4 tokens verified from the reference's cache:
    the logits, and each lane's state snapshot at its accepted prefix,
    against the reference's."""
    jp, tp = _model(arch)
    jc, c = _cfgs(arch)
    jc, c = (_jcfg_for(jc, datapath), _cfg_for_datapath(c, datapath))
    tol = QAT_ATOL if datapath == "qat" else ATOL
    V = c.vocab_size
    page, G, L, maxp, T = 4, 2, 8, 4, 4
    n = G * maxp + 1
    rng = np.random.default_rng(3)
    toks = rng.integers(0, V, (G, L)).astype(np.int32)
    plens = np.array([5, 8], np.int32)
    tables = (1 + np.arange(G * maxp).reshape(G, maxp)).astype(np.int32)
    slots = np.array([1, 0], np.int32)
    win = rng.integers(0, V, (G, T)).astype(np.int32)
    m = np.array([2, 0], np.int32)
    prefill = jax.jit(jtf.paged_prefill, static_argnames=("cfg", "chunk"))
    verify = jax.jit(jtf.paged_verify_step, static_argnames=("cfg",))
    with jdispatch.backend_scope("reference"), \
            jdispatch.attn_backend_scope("reference"):
        jcache = jtf.init_paged_cache(jc, 3, n, page, fmt)
        _, jcache = prefill(jp, jcache, toks, tables, plens, cfg=jc,
                            chunk=4, slot_ids=slots)
        cache = cache_from_jax(jax.tree.map(np.asarray, jcache), c,
                               device="cpu")
        jl, _, jsnaps = verify(jp, jcache, win, slots, tables, plens,
                               cfg=jc)
        jrows = jtf.select_state_snapshot(jsnaps, jnp.asarray(m))
    with torch.inference_mode():
        tl, cache, snaps = paged_verify_step(tp, cache, _t(win), _t(slots),
                                             _t(tables), _t(plens), c)
        rows = select_state_snapshot(snaps, _t(m))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=tol)
    for i, (e, r) in enumerate(zip(snaps, rows)):
        want = _jsnap_layer(jsnaps, c, i)
        wrow = jax.tree.map(lambda a: np.asarray(a)[i // len(c.period)],
                            jrows[f"p{i % len(c.period)}"])
        tree_map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), b, rtol=0, atol=tol), e, want)
        tree_map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), b, rtol=0, atol=tol), r, wrow)


def _jcfg_for(jc, datapath):
    if datapath == "qat":
        return jc
    q = dataclasses.replace(jc.quant, mode="sc_int",
                            int_approx=datapath == "sc_int_approx")
    return jc.scaled(quant=q)


@pytest.mark.parametrize("arch", ARCHS)
def test_verify_logits_equal_plain_decode_steps(arch):
    """From one cache, the window's logits row t equals the logits of the
    decode step after window tokens 0..t (each step on its own copy of the
    cache, the recurrent rows advanced one token at a time), and the
    snapshot of token t equals that step's state rows."""
    _, tp = _model(arch)
    c = _cfg_for_datapath(_cfgs(arch)[1], "sc_int")
    page, S, maxp, T = 4, 2, 4, 4
    rng = np.random.default_rng(5)
    cache = init_paged_cache(c, S, S * maxp + 1, page, "int8", device="cpu")
    tables = _t((1 + np.arange(S * maxp).reshape(S, maxp)).astype(np.int32))
    slots = torch.tensor([1, 0], dtype=torch.int32)
    lengths = torch.tensor([3, 6], dtype=torch.int32)
    win = _t(rng.integers(0, c.vocab_size, (S, T)).astype(np.int32))
    with torch.inference_mode():
        for t in range(6):          # fill the cache with a few tokens
            _, cache = paged_decode_step(
                tp, cache, win[:, 0], slots, tables,
                torch.tensor([min(t, 3), t], dtype=torch.int32), c)
        plain = tree_map(torch.clone, cache)
        vl, _, snaps = paged_verify_step(tp, cache, win, slots, tables,
                                         lengths, c)
        for t in range(T):
            lg, plain = paged_decode_step(tp, plain, win[:, t], slots,
                                          tables, lengths + t, c)
            np.testing.assert_allclose(vl[:, t].numpy(), lg.numpy(),
                                       rtol=0, atol=1e-6)
            snap = select_state_snapshot(snaps, torch.full((S,), t))
            want = [{k: v[slots.long()] for k, v in e.items()
                     if not k.endswith(("pages", "scale", "resid"))}
                    for e in plain["layers"]]
            tree_map(lambda a, b: np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=0, atol=1e-6), snap, want)
        # committing a snapshot writes the rows the plain steps left
        scatter_state_rows(cache, select_state_snapshot(
            snaps, torch.full((S,), T - 1)), slots)
        tree_map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), b.numpy(), rtol=0, atol=1e-6),
            [{k: v for k, v in e.items() if "pages" not in k}
             for e in cache["layers"]],
            [{k: v for k, v in e.items() if "pages" not in k}
             for e in plain["layers"]])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("datapath", ["qat", "sc_int"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_spec_equals_plain_and_sequential(datapath, sampled):
    sps = SAMPLED if sampled else None
    on, eng = _run("granite-3-2b", datapath, True, sps)
    off, _ = _run("granite-3-2b", datapath, False, sps)
    assert _tokens(on) == _tokens(off)
    ref = sequential_generate(_model("granite-3-2b")[1],
                              _cfgs("granite-3-2b")[1], PROMPTS,
                              max_new_tokens=8, max_len=64,
                              datapath=datapath, sampling=sps, device="cpu")
    assert _tokens(on) == ref
    st = eng.spec_stats
    assert st["rounds"] >= 1 and st["emitted_tokens"] >= st["rounds"]
    assert st["accepted_tokens"] <= st["draft_tokens"]
    assert st["tokens_per_round"] >= 1.0
    assert st["emitted_tokens"] == sum(len(g) - 1 for g in _tokens(on))


@pytest.mark.parametrize("datapath", ["qat", "sc_int"])
def test_spec_sampled_hybrid_jamba(datapath):
    """mamba, attention, MoE and dense layers in one model: the window's
    attention and the recurrent snapshots' rollback."""
    on, _ = _run("jamba-1.5-large-398b", datapath, True, SAMPLED, max_new=6)
    off, _ = _run("jamba-1.5-large-398b", datapath, False, SAMPLED,
                  max_new=6)
    assert _tokens(on) == _tokens(off)


def test_spec_greedy_hybrid_jamba_accepts_with_a_perfect_drafter():
    """A drafter equal to the target is always accepted on jamba too, and
    the recurrent rows then carry the last accepted token's state."""
    _, tp = _model("jamba-1.5-large-398b")
    c = _cfgs("jamba-1.5-large-398b")[1]
    eng = ServeEngine(tp, c, datapath="sc_int", spec_decode=True,
                      draft_len=3, device="cpu", **ENGINE)
    eng.cfg_draft = eng.cfg
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=7)
    got = _tokens(sorted(eng.run_to_completion(), key=lambda r: r.rid))
    off, _ = _run("jamba-1.5-large-398b", "sc_int", False, max_new=7)
    assert got == _tokens(off)
    assert eng.spec_stats["acceptance_rate"] == 1.0


def test_draft_equals_target_accepts_everything():
    """Pointing the drafter at the target's datapath: every draft is
    accepted, and the 7 tokens after prefill take ceil(7 / 4) = 2
    rounds."""
    _, tp = _model("granite-3-2b")
    eng = ServeEngine(tp, _cfgs("granite-3-2b")[1], datapath="qat",
                      spec_decode=True, draft_len=3, device="cpu", **ENGINE)
    eng.cfg_draft = eng.cfg
    for p, sp in zip(PROMPTS, SAMPLED):
        eng.submit(p, max_new_tokens=8, sampling=sp)
    got = _tokens(sorted(eng.run_to_completion(), key=lambda r: r.rid))
    off, _ = _run("granite-3-2b", "qat", False, SAMPLED)
    assert got == _tokens(off)
    st = eng.spec_stats
    assert st["acceptance_rate"] == 1.0
    assert st["rounds"] == 2
    assert st["emitted_tokens"] == 7 * len(PROMPTS)


def test_spec_logprobs_equal_plain_logprobs():
    sps = [SamplingParams(logprobs=2),
           SamplingParams(temperature=0.9, top_k=8, seed=5, logprobs=2),
           SamplingParams(logprobs=3)]
    on, _ = _run("granite-3-2b", "qat", True, sps, max_new=6)
    off, _ = _run("granite-3-2b", "qat", False, sps, max_new=6)
    for a, b in zip(on, off):
        assert a.generated == b.generated
        assert len(a.logprobs) == len(b.logprobs) == len(a.generated)
        for x, y in zip(a.logprobs, b.logprobs):
            assert x["logprob"] == pytest.approx(y["logprob"], abs=1e-6)
            assert [t for t, _ in x["top"]] == [t for t, _ in y["top"]]


def test_spec_window_fallback_near_max_len():
    """Lanes within draft_len + 1 of max_len take plain decode steps, and
    stop where spec-off stops."""
    on, _ = _run("granite-3-2b", "qat", True, max_new=32, max_len=16)
    off, _ = _run("granite-3-2b", "qat", False, max_new=32, max_len=16)
    assert _tokens(on) == _tokens(off)
    assert [len(g) for g in _tokens(on)] == [16 - len(p) for p in PROMPTS]


def test_spec_under_pool_pressure_never_preempts_for_a_window():
    prompts = PROMPTS + [[10, 11, 12, 13, 14]]
    _, tp = _model("granite-3-2b")
    outs = []
    for spec in (True, False):
        eng = ServeEngine(tp, _cfgs("granite-3-2b")[1], datapath="qat",
                          spec_decode=spec, draft_len=3, max_slots=4,
                          max_len=64, page_size=8, num_pages=9,
                          device="cpu")
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        done = eng.run_to_completion()
        assert len(done) == len(prompts)
        outs.append(_tokens(sorted(done, key=lambda r: r.rid)))
    assert outs[0] == outs[1]


def test_engine_config_validation():
    with pytest.raises(ValueError, match="draft_len"):
        EngineConfig(draft_len=0).validate()
    with pytest.raises(ValueError, match="sc_int_approx"):
        EngineConfig(spec_decode=True, datapath="sc_int_approx").validate()
    EngineConfig(spec_decode=True, datapath="sc_int",
                 draft_len=1).validate()
    _, tp = _model("granite-3-2b")
    with pytest.raises(ValueError, match="draft_len"):
        ServeEngine(tp, _cfgs("granite-3-2b")[1], spec_decode=True,
                    draft_len=0, device="cpu")
    eng = ServeEngine(tp, _cfgs("granite-3-2b")[1],
                      config=EngineConfig(spec_decode=True, draft_len=2),
                      device="cpu")
    assert eng.spec_decode and eng.draft_len == 2
    assert eng.cfg_draft.quant.int_approx

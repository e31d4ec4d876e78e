"""The port's seeded sampling and logprobs (``repro_torch.serving.sampling``
and the engine's use of it) against ``repro.serving``.

* The key schedule: ``prng.lane_keys`` / ``prng.uniform`` bit-equal to
  ``fold_in(PRNGKey(seed), position)`` / ``jax.random.uniform`` over a
  grid of seeds (2**31, 2**32 + 5 and negative seeds among them) and
  positions.
* The sampler on seeded random logits: ``filter_logits`` keeps the
  reference's sets (kept values within 1e-6 relative), the Gumbel noise
  within 1e-6 relative of the reference's (2.5e-7 absolute where the
  noise crosses 0: ``log`` of a value within an ulp or two of 1 there),
  ``sample_tokens`` draws the same tokens on rows whose best and
  second-best perturbed logits are more than 1e-4 apart (every row of
  the grid here), ``token_logprobs`` within 1e-5 and the same top ids;
  plus the reference's laws (``tests/test_sampling.py``).
* The engine on tiny granite-3-2b (``tests/test_sampling.py``'s ``CFG``
  and ``SAMPLED``): its tokens equal the JAX engine's on the three
  datapaths, batched == sequential, the retrace buckets, preemption, a
  mixed greedy / sampled batch, logprobs, and an all-greedy batch runs
  no sampler op.

The port follows jax with ``jax_threefry_partitionable`` on; the module
fixture pins it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServeEngine as JServeEngine
from repro.serving import sampling as jsampling
from repro.serving import sequential_generate as jsequential_generate
from repro.serving.engine import _cfg_for_datapath as _jcfg_for_datapath
from repro.serving.engine import \
    _paged_sequential_generate as _jpaged_sequential_generate
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.models import forward
from repro_torch.serving import (SamplingParams, ServeEngine,
                                 sequential_generate)
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import sampling
from repro_torch.weights import from_jax
from port_fixtures import _one_torch_thread, _partitionable  # noqa: F401


SCALE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=64, vocab_pad_multiple=32, dtype="float32")
JCFG = jget_arch("granite-3-2b").scaled(attn_q_chunk=8, **SCALE)
CFG = get_arch("granite-3-2b").scaled(**SCALE)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12, 13, 14]]
SAMPLED_KW = [dict(temperature=0.9, top_p=0.8, top_k=16, seed=100 + i)
              for i in range(len(PROMPTS))]
SAMPLED = [SamplingParams(**kw) for kw in SAMPLED_KW]
PAIRS = [("qat", "fp"), ("sc_int", "int8"), ("sc_int_approx", "sc")]
SEEDS = [0, 1, 7, 2 ** 31, 2 ** 31 + 7, 2 ** 32 + 5, -1, -2 ** 31,
         123456789]
POSITIONS = [0, 1, 3, 31, 1000, 2 ** 20, 2 ** 31 - 1]
FIELDS = ("temperature", "top_k", "top_p", "min_p", "seed", "logprobs")
VALUE_RTOL = 1e-6       # float32 values computed in another op order
LOGPROB_ATOL = 1e-5
GUMBEL_ATOL = 2.5e-7    # two float32 ulps of 1, where -log(-log u) ~ 0
DRAW_MARGIN = 1e-4      # least gap between the best two perturbed logits


def _jsp(sp):
    return JSamplingParams(**{f: getattr(sp, f) for f in FIELDS})


def _replace(sp, **kw):
    return SamplingParams(**{**{f: getattr(sp, f) for f in FIELDS}, **kw})


def _packed(sps):
    return sampling.pack_sampling(sps), jsampling.pack_sampling(
        [_jsp(sp) for sp in sps])


def _random_params(rng, n):
    return [SamplingParams(temperature=float(rng.uniform(0.2, 2.0)),
                           top_k=int(rng.integers(0, 40)),
                           top_p=float(rng.uniform(0.2, 1.0)),
                           min_p=float(rng.uniform(0.0, 0.2)),
                           seed=int(rng.integers(-2 ** 40, 2 ** 40)))
            for _ in range(n)]


def _kept(row):
    return set(np.flatnonzero(np.isfinite(np.asarray(row))).tolist())


def _filter_one(row, sp):
    samp = sampling.pack_sampling([sp])
    return sampling.filter_logits(
        torch.tensor(np.asarray(row, np.float32))[None], samp["temperature"],
        samp["top_k"], samp["top_p"], samp["min_p"])[0]


@pytest.fixture(scope="module")
def params():
    jp = jinit_params(jax.random.key(0), JCFG)
    return jp, from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")


def _tokens(done):
    return [r.generated for r in sorted(done, key=lambda r: r.rid)]


def _run_engine(tp, sps, prompts=PROMPTS, max_new=5, eos_id=None, **kw):
    eng = ServeEngine(tp, CFG, device="cpu",
                      **{**dict(max_slots=3, max_len=32, page_size=8), **kw})
    for p, sp in zip(prompts, sps):
        eng.submit(p, max_new_tokens=max_new, eos_id=eos_id, sampling=sp)
    done = eng.run_to_completion()
    assert len(done) == len(prompts)
    return sorted(done, key=lambda r: r.rid)


# ---------------------------------------------------------------------------
# the key schedule
# ---------------------------------------------------------------------------

def test_lane_keys_and_uniform_equal_jax_random():
    seeds = np.array([np.uint32(s & 0xFFFFFFFF).astype(np.int32)
                      for s in SEEDS])
    s, p = np.meshgrid(seeds, np.array(POSITIONS, np.int32), indexing="ij")
    s, p = s.reshape(-1), p.reshape(-1)
    want = np.asarray(jsampling.lane_keys(jnp.asarray(s), jnp.asarray(p)))
    got = sampling.lane_keys(torch.tensor(s), torch.tensor(p))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for n in (1, 64, 131):
        u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (n,), jnp.float32))(jnp.asarray(want)))
        got_u = prng.uniform(got, n).numpy()
        np.testing.assert_array_equal(got_u.view(np.int32),
                                      u.view(np.int32))
        assert got_u.min() >= 0.0 and got_u.max() < 1.0


@pytest.mark.parametrize("seed", [2 ** 31, -5, 2 ** 32 + 9])
def test_pack_sampling_seeds_as_the_reference(seed):
    """Seeds congruent mod 2**32 name one stream, packed to int32 as the
    reference packs them."""
    sp = SamplingParams(temperature=1.0, seed=seed)
    got, want = _packed([sp, SamplingParams()])
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["seed"].dtype == torch.int32
    same = SamplingParams(temperature=1.0, seed=seed + 2 ** 32)
    assert sampling.pack_sampling([same])["seed"][0] == got["seed"][0]


# ---------------------------------------------------------------------------
# the sampler against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid():
    """24 rows of 200 seeded random logits (scale 3) under random
    controls, plus lanes with each filter alone and a greedy lane."""
    rng = np.random.default_rng(0)
    sps = _random_params(rng, 20) + [
        SamplingParams(temperature=0.7, top_k=5, seed=3),
        SamplingParams(temperature=1.3, top_p=0.5, seed=4),
        SamplingParams(temperature=1.0, min_p=0.1, seed=5),
        SamplingParams(top_k=3, seed=6)]
    logits = (rng.normal(size=(len(sps), 200)) * 3).astype(np.float32)
    pos = rng.integers(0, 5000, len(sps)).astype(np.int32)
    return logits, pos, sps


def test_filter_logits_keeps_the_reference_sets(grid):
    logits, _, sps = grid
    ts, js = _packed(sps)
    want = np.asarray(jsampling.filter_logits(
        jnp.asarray(logits), js["temperature"], js["top_k"], js["top_p"],
        js["min_p"]))
    got = sampling.filter_logits(torch.tensor(logits), ts["temperature"],
                                 ts["top_k"], ts["top_p"],
                                 ts["min_p"]).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=VALUE_RTOL)
    # every filter bites somewhere on this grid
    assert 0 < fin.sum() < fin.size


def test_gumbel_noise_within_tolerance_of_the_reference(grid):
    _, pos, sps = grid
    ts, js = _packed(sps)
    V = 200
    keys = jsampling.lane_keys(js["seed"], jnp.asarray(pos))
    u = jax.vmap(lambda k: jax.random.uniform(k, (V,), jnp.float32))(keys)
    want = np.asarray(-jnp.log(-jnp.log(jnp.maximum(
        u, jnp.finfo(jnp.float32).tiny))))
    tu = prng.uniform(sampling.lane_keys(ts["seed"], torch.tensor(pos)), V)
    got = (-torch.log(-torch.log(torch.clamp_min(
        tu, torch.finfo(torch.float32).tiny)))).numpy()
    np.testing.assert_allclose(got, want, rtol=VALUE_RTOL, atol=GUMBEL_ATOL)


def test_sample_tokens_and_logprobs_equal_the_reference(grid):
    logits, pos, sps = grid
    sps = [_replace(sp, logprobs=4) for sp in sps]
    ts, js = _packed(sps)
    V = logits.shape[1]
    want = np.asarray(jsampling.sample_tokens(jnp.asarray(logits),
                                              jnp.asarray(pos), js, V))
    got = sampling.sample_tokens(torch.tensor(logits), torch.tensor(pos),
                                 ts, V)
    assert got.dtype == torch.int32
    # the draws are not decided by a near-tie on this grid
    masked = np.asarray(jsampling.filter_logits(
        jnp.asarray(logits), js["temperature"], js["top_k"], js["top_p"],
        js["min_p"]))
    keys = jsampling.lane_keys(js["seed"], jnp.asarray(pos))
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (V,), jnp.float32))(keys))
    pert = np.sort(masked - np.log(-np.log(np.maximum(u, 1e-38))), -1)
    sampled = np.asarray(js["temperature"]) > 0
    assert (pert[sampled, -1] - pert[sampled, -2]).min() > DRAW_MARGIN
    np.testing.assert_array_equal(got.numpy(), want)
    jl = jsampling.token_logprobs(jnp.asarray(logits), jnp.asarray(want),
                                  js, V, 4)
    tl = sampling.token_logprobs(torch.tensor(logits), got, ts, V, 4)
    np.testing.assert_array_equal(tl[1].numpy(), np.asarray(jl[1]))
    for a, b in ((tl[0], jl[0]), (tl[2], jl[2])):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], atol=LOGPROB_ATOL)


def test_logprob_rows_are_distributions(grid):
    """Each row's logsumexp is 0, and a sampled lane's tokens outside the
    kept set score -inf."""
    logits, _, sps = grid
    ts, _ = _packed(sps)
    V = logits.shape[1]
    lt = torch.tensor(logits)
    toks = sampling.greedy_tokens(lt, V)
    _, ids, lps = sampling.token_logprobs(lt, toks, ts, V, V)
    lse = torch.logsumexp(lps, dim=-1)
    np.testing.assert_allclose(lse.numpy(), 0.0, atol=1e-5)
    masked = sampling.filter_logits(lt, ts["temperature"], ts["top_k"],
                                    ts["top_p"], ts["min_p"])
    for s, sp in enumerate(sps):
        finite = set(ids[s][torch.isfinite(lps[s])].tolist())
        if sp.greedy:
            assert len(finite) == V
        else:
            assert finite == _kept(masked[s])


def test_top_k_ties_go_to_the_lower_id():
    """``jax.lax.top_k`` breaks ties to the lower index; so does the
    port's top list."""
    row = np.zeros((1, 16), np.float32)
    row[0, [3, 9, 12]] = 2.0
    row[0, [1, 5]] = 1.0
    samp = sampling.pack_sampling([SamplingParams()])
    jsamp = jsampling.pack_sampling([JSamplingParams()])
    toks = np.array([3], np.int32)
    _, ids, _ = sampling.token_logprobs(torch.tensor(row),
                                        torch.tensor(toks), samp, 16, 6)
    _, jids, _ = jsampling.token_logprobs(jnp.asarray(row),
                                          jnp.asarray(toks), jsamp, 16, 6)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert ids[0].tolist() == [3, 9, 12, 1, 5, 0]


# ---------------------------------------------------------------------------
# the reference's laws (tests/test_sampling.py)
# ---------------------------------------------------------------------------

def test_params_validation():
    for bad in (dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5), dict(min_p=-0.2), dict(min_p=1.1),
                dict(logprobs=-1)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    assert SamplingParams().greedy
    assert not SamplingParams(temperature=0.5).greedy


def test_temperature_zero_is_exact_argmax():
    logits = torch.tensor(np.random.default_rng(0).normal(size=(5, 48)),
                          dtype=torch.float32)
    samp = sampling.pack_sampling([SamplingParams(top_k=3, top_p=0.5,
                                                  min_p=0.3, seed=s)
                                   for s in range(5)])
    got = sampling.sample_tokens(logits, torch.arange(5), samp, 48)
    np.testing.assert_array_equal(got.numpy(),
                                  torch.argmax(logits, -1).numpy())


def test_top_k1_equals_greedy_at_any_temperature():
    logits = torch.tensor(np.random.default_rng(1).normal(size=(6, 40)),
                          dtype=torch.float32)
    for temp in (0.3, 1.0, 7.5):
        samp = sampling.pack_sampling([SamplingParams(
            temperature=temp, top_k=1, seed=s) for s in range(6)])
        got = sampling.sample_tokens(logits, torch.arange(6), samp, 40)
        np.testing.assert_array_equal(got.numpy(),
                                      torch.argmax(logits, -1).numpy())


def test_top_p_mass_boundary_ties_all_kept():
    probs = np.full(8, 1e-9)
    probs[[1, 3, 4, 6]] = 0.25
    kept = _kept(_filter_one(np.log(probs), SamplingParams(temperature=1.0,
                                                           top_p=0.5)))
    assert kept == {1, 3, 4, 6}


def test_top_p_prefix_rule():
    row = np.log(np.array([0.5, 0.3, 0.2]))
    assert _kept(_filter_one(row, SamplingParams(temperature=1.0,
                                                 top_p=0.6))) == {0, 1}


def test_min_p_thresholds_against_best():
    row = np.log(np.array([0.5, 0.3, 0.12, 0.04, 0.04]))
    assert _kept(_filter_one(row, SamplingParams(temperature=1.0,
                                                 min_p=0.1))) == {0, 1, 2}


def test_top_k_boundary_ties_all_kept():
    row = np.array([3.0, 1.0, 2.0, 2.0, 0.5, 2.0])
    assert _kept(_filter_one(row, SamplingParams(temperature=1.0,
                                                 top_k=2))) == {0, 2, 3, 5}


def test_temperature_extremes():
    logits = torch.linspace(0.0, 8.0, 32)[None]
    cold, hot = set(), set()
    for pos in range(40):
        p = torch.tensor([pos])
        cold.add(int(sampling.sample_tokens(logits, p, sampling.pack_sampling(
            [SamplingParams(temperature=1e-4, seed=3)]), 32)[0]))
        hot.add(int(sampling.sample_tokens(logits, p, sampling.pack_sampling(
            [SamplingParams(temperature=1e4, top_k=4, seed=3)]), 32)[0]))
    assert cold == {31}
    assert hot <= set(range(28, 32)) and len(hot) > 1


def test_same_seed_position_same_draw_any_lane_any_width():
    row = torch.tensor(np.random.default_rng(2).normal(size=24),
                       dtype=torch.float32)
    sp = SamplingParams(temperature=1.2, top_p=0.95, seed=42)
    pos = torch.full((8,), 9)
    wide = sampling.sample_tokens(row.expand(8, 24), pos,
                                  sampling.pack_sampling([sp] * 8), 24)
    assert len(set(wide.tolist())) == 1
    one = sampling.sample_tokens(row[None], pos[:1],
                                 sampling.pack_sampling([sp]), 24)
    assert int(one[0]) == int(wide[0])


def test_positions_advance_the_stream():
    row = torch.zeros((1, 16))
    sp = sampling.pack_sampling([SamplingParams(temperature=1.0, seed=0)])
    toks = {int(sampling.sample_tokens(row, torch.tensor([t]), sp, 16)[0])
            for t in range(32)}
    assert len(toks) > 4


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_tokens(params):
    """The JAX engine's sampled tokens on each pair (one run a pair)."""
    jp, _ = params
    out = {}
    for datapath, fmt in PAIRS:
        eng = JServeEngine(jp, JCFG, datapath=datapath, kv_format=fmt,
                           max_slots=3, max_len=32, page_size=8,
                           bsn_backend="reference", attn_backend="reference")
        for p, kw in zip(PROMPTS, SAMPLED_KW):
            eng.submit(p, max_new_tokens=5, sampling=JSamplingParams(**kw))
        out[datapath] = _tokens(eng.run_to_completion())
    return out


@pytest.mark.parametrize("datapath,fmt", PAIRS)
def test_engine_tokens_equal_reference_engine(params, reference_tokens,
                                              datapath, fmt):
    """The port engine's sampled tokens equal the JAX engine's.  On the
    qat pair a draw decided by an exact tie on the fake-quant lattice may
    part from the reference's (ROADMAP Queue 3 item 10); then the raw
    logits at the first differing token must hold such a tie among the
    kept tokens in the port, and the port's own oracle must give the
    port's tokens."""
    _, tp = params
    got = _tokens(_run_engine(tp, SAMPLED, datapath=datapath,
                              kv_format=fmt))
    want = reference_tokens[datapath]
    if got == want:
        return
    assert datapath == "qat", (got, want)
    seq = sequential_generate(tp, CFG, PROMPTS, max_new_tokens=5,
                              max_len=32, datapath=datapath, kv_format=fmt,
                              sampling=SAMPLED, device="cpu")
    assert got == seq
    for prompt, g, w in zip(PROMPTS, got, want):
        if g == w:
            continue
        i = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        with torch.inference_mode():
            lg = forward(tp, {"tokens": torch.tensor([prompt + g[:i]])},
                         CFG, mode="prefill")[0][0, -1, :CFG.vocab_size]
        vals, counts = torch.unique(lg, return_counts=True)
        assert (counts > 1).any(), "differs without a lattice tie"


@pytest.mark.parametrize("datapath,fmt", PAIRS)
def test_sampled_batched_equals_sequential_per_datapath(params, datapath,
                                                        fmt):
    _, tp = params
    got = _tokens(_run_engine(tp, SAMPLED, datapath=datapath,
                              kv_format=fmt))
    ref = sequential_generate(tp, CFG, PROMPTS, max_new_tokens=5,
                              max_len=32, datapath=datapath, kv_format=fmt,
                              sampling=SAMPLED, device="cpu")
    assert got == ref
    greedy = sequential_generate(tp, CFG, PROMPTS, max_new_tokens=5,
                                 max_len=32, datapath=datapath,
                                 kv_format=fmt, device="cpu")
    assert got != greedy, "sampling degenerated to greedy"


def test_mixed_greedy_and_sampled_batch(params):
    _, tp = params
    sps = [None, SAMPLED[1], SamplingParams(), SAMPLED[3]]
    got = _tokens(_run_engine(tp, sps, max_slots=4))
    ref = sequential_generate(tp, CFG, PROMPTS, max_new_tokens=5,
                              max_len=32, sampling=sps, device="cpu")
    assert got == ref
    with pytest.raises(ValueError, match="entries"):
        sequential_generate(tp, CFG, PROMPTS, max_new_tokens=5, max_len=32,
                            sampling=sps[:2], device="cpu")


def test_seed_stream_invariant_across_retrace_buckets(params):
    _, tp = params
    a = _tokens(_run_engine(tp, SAMPLED, max_slots=4, page_size=16))
    b = _tokens(_run_engine(tp, SAMPLED, max_slots=2, page_size=4,
                            prefill_chunk=4))
    assert a == b


def test_seed_stream_invariant_under_preemption(params):
    """A pool too small for both requests preempts and re-prefills one;
    its stream replays the same tokens, and its logprobs are cleared with
    its tokens, so each token keeps one record."""
    _, tp = params
    prompts = [[1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13]]
    sps = [SamplingParams(temperature=1.1, top_p=0.9, seed=5, logprobs=2),
           SamplingParams(temperature=0.7, top_k=8, seed=6, logprobs=2)]
    eng = ServeEngine(tp, CFG, max_slots=2, max_len=24, page_size=8,
                      num_pages=5, datapath="sc_int", kv_format="int8",
                      device="cpu")
    preempted = []
    grow = eng._grow_or_preempt

    def watch(active):
        before = [eng.slots[i] for i in active]
        out = grow(active)
        preempted.extend(r for r in before if r._table is None)
        return out
    eng._grow_or_preempt = watch
    for p, sp in zip(prompts, sps):
        eng.submit(p, max_new_tokens=12, sampling=sp)
    done = sorted(eng.run_to_completion(), key=lambda r: r.rid)
    assert preempted, "the pool never forced a preemption"
    ref = sequential_generate(tp, CFG, prompts, max_new_tokens=12,
                              max_len=24, datapath="sc_int",
                              kv_format="int8", sampling=sps, device="cpu")
    assert [r.generated for r in done] == ref
    for r in done:
        assert len(r.logprobs) == len(r.generated)


def test_same_seed_same_prompt_reproduces(params):
    _, tp = params
    sps = [SamplingParams(temperature=1.0, seed=9),
           SamplingParams(temperature=1.0, seed=9),
           SamplingParams(temperature=1.0, seed=10)]
    got = _tokens(_run_engine(tp, sps, prompts=[[1, 2, 3]] * 3))
    assert got[0] == got[1]
    assert got[0] != got[2]


def test_eos_scenario_of_queue3_item5(params):
    """``tests/test_sampling.py::test_eos_stops_sampled_requests`` through
    the port and through both reference oracles (ROADMAP Queue 3 item 5).
    Under ``top_k=1`` every token tied at the row's maximum is kept, and
    the first row of ``[1, 2, 3]`` on qat holds an exact lattice tie
    (ids 27 and 46 at 1.82).  The port's float64 products keep the tie on
    the dense and the paged path alike, so its engine and both its oracles
    draw the same token; the reference's dense and paged prefills break
    the tie in different ways whenever their float32 sums round apart."""
    jp, tp = params
    sp = SamplingParams(temperature=1.0, top_k=1, seed=0)
    with torch.inference_mode():
        row = forward(tp, {"tokens": torch.tensor([PROMPTS[0]])}, CFG,
                      mode="prefill")[0][0, -1, :CFG.vocab_size]
    assert (row == row.max()).sum() > 1, "no tie at the maximum"
    dense = sequential_generate(tp, CFG, [PROMPTS[0]], max_new_tokens=8,
                                max_len=32, sampling=[sp], device="cpu")
    paged = engine_mod._paged_sequential_generate(
        tp, CFG, [PROMPTS[0]], 8, None, 32, "fp", 8, torch.device("cpu"),
        [sp])
    assert dense == paged
    eos = dense[0][2]
    got = _tokens(_run_engine(tp, [sp], prompts=[PROMPTS[0]], max_new=8,
                              max_slots=2, eos_id=eos))
    seq = sequential_generate(tp, CFG, [PROMPTS[0]], max_new_tokens=8,
                              max_len=32, eos_id=eos, sampling=[sp],
                              device="cpu")
    assert got == seq
    assert got[0][-1] == eos and len(got[0]) == 3
    # the reference's two oracles: each draws one of the tied tokens first
    jsp = [_jsp(sp)]
    jdense = jsequential_generate(jp, JCFG, [PROMPTS[0]], max_new_tokens=8,
                                  max_len=32, sampling=jsp)
    jpaged = _jpaged_sequential_generate(
        jp, _jcfg_for_datapath(JCFG, "qat"), [PROMPTS[0]], jsp, 8, None, 32,
        None, "fp", 8)
    tied = set(torch.nonzero(row == row.max())[:, 0].tolist())
    assert {jdense[0][0], jpaged[0][0]} <= tied
    assert dense[0][0] in tied


def test_all_greedy_batch_runs_no_sampler_op(params, monkeypatch):
    """A batch with no sampled lane and no logprobs takes the argmax
    alone: the sampler, the filters and the packing are never called, and
    the tokens are the greedy oracle's."""
    _, tp = params

    def boom(*a, **k):
        raise AssertionError("sampler op in an all-greedy batch")
    for name in ("sample_tokens", "token_logprobs", "pack_sampling"):
        monkeypatch.setattr(engine_mod, name, boom)
    monkeypatch.setattr(sampling, "filter_logits", boom)
    got = _tokens(_run_engine(tp, [None] * len(PROMPTS)))
    want = sequential_generate(tp, CFG, PROMPTS, max_new_tokens=5,
                               max_len=32, device="cpu")
    monkeypatch.undo()
    assert got == want


def test_logprob_bucket_and_records(params):
    """The top-list width is the batch's largest ask, padded to a power
    of two; each record is cropped to its request's own ask."""
    _, tp = params
    sps = [SamplingParams(logprobs=3),
           SamplingParams(temperature=0.9, top_k=8, seed=2, logprobs=1),
           None, SamplingParams(temperature=0.8, seed=4)]
    done = _run_engine(tp, sps, max_slots=4)
    assert engine_mod._lp_bucket([sp or SamplingParams() for sp in sps]) == 4
    for r, sp in zip(done, sps):
        n = sp.logprobs if sp else 0
        assert len(r.logprobs) == (len(r.generated) if n else 0)
        for tok, rec in zip(r.generated, r.logprobs):
            assert len(rec["top"]) == n
            if r.sampling.greedy:
                assert rec["top"][0][0] == tok
            assert rec["logprob"] <= 0.0


def test_engine_logprobs_match_dense_forward(params):
    """Greedy logprobs equal the log-softmax of one dense forward over
    the whole sequence; sampled lanes' equal the reference's
    ``token_logprobs`` of those logits."""
    _, tp = params
    sps = [SamplingParams(logprobs=4), SAMPLED[1],
           _replace(SAMPLED[2], logprobs=4), None]
    done = _run_engine(tp, sps, max_slots=4)
    for r, prompt, sp in zip(done, PROMPTS, sps):
        if not (sp and sp.logprobs):
            assert r.logprobs == []
            continue
        ids = torch.tensor([prompt + r.generated])
        with torch.inference_mode():
            lg = forward(tp, {"tokens": ids}, CFG,
                         mode="prefill")[0][0, :, :CFG.vocab_size]
        rows = lg[len(prompt) - 1:len(prompt) - 1 + len(r.generated)]
        jsamp = jsampling.pack_sampling([_jsp(sp)] * len(r.generated))
        jl = jsampling.token_logprobs(
            jnp.asarray(rows.numpy()), jnp.asarray(r.generated, jnp.int32),
            jsamp, CFG.vocab_size, 4)
        for i, rec in enumerate(r.logprobs):
            assert rec["logprob"] == pytest.approx(float(jl[0][i]),
                                                   abs=1e-4)
            assert [t for t, _ in rec["top"]] == np.asarray(
                jl[1][i]).tolist()

"""Mesh-sharded serving of the port: the tensor-parallel differential.

The port's ``ServeEngine(mesh=...)`` on CPU gloo ranks (one process a
rank, ``tests/mesh_worker.py``) must give the tokens of the port's
mesh-off engine and of the reference's mesh-off oracle, run here, on the
cells of ``tests/test_sharded_serving.py`` (its ``SCALE`` attention
config; the MoE and kernel-attention cells are in
``test_torch_mesh_moe.py``, the recurrent ones in
``test_torch_mesh_recurrent.py``, so that ``--dist loadfile`` spreads
them).  Two meshes: 2 ranks as (1, 2),
and 4 ranks as (2, 2), whose "data" axis splits each step's lanes.
Every rank must commit the same tokens.  A gather is a copy and no sum
spans ranks, so mesh-on equals mesh-off exactly: tokens, logprobs and
the sc_int q-domain sums bit for bit.  Against the reference, qat tokens
may part only at an exact tie of the fake-quant lattice (ROADMAP Queue 3
item 10; ``mesh_worker.assert_matches_reference``).  The reference's
8-device mesh cells are never used: five of them are red.
"""

import functools

import jax
import numpy as np
import pytest

import mesh_worker as mw
from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import sequential_generate as jsequential_generate
from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import fit_spec
from repro_torch.launch.mesh import (make_serving_mesh, mesh_chips,
                                     mesh_name, serving_rules)
from repro_torch.serving import EngineConfig
from port_fixtures import _one_torch_thread, _partitionable  # noqa: F401

# n_kv_heads=4 so that the pools shard over "model" (the reference's SCALE)
SCALE = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=64,
             vocab_pad_multiple=32, dtype="float32")
CFGS = {"attn": ("granite-3-2b", dict(n_layers=2)),
        # one KV head: "model" (2) cannot split it, so the pools and k / v
        # stay whole on every rank (the reference's uneven cell, at tp 2)
        "uneven": ("granite-3-2b", dict(n_layers=2, n_kv_heads=1))}
MESHES = {"1x2": (2, 1), "2x2": (4, 2)}           # world, data_parallel
DATAPATHS = ["qat", "sc_int", "sc_int_approx"]
SAMPLED = [dict(temperature=0.8, top_p=0.9, seed=11 + i) for i in range(3)]
LOGPROBS = [dict(logprobs=2),
            dict(temperature=0.8, top_p=0.9, seed=11, logprobs=2),
            dict(logprobs=2)]
COMPRESSED = [("int8", "qat"), ("int8", "sc_int"), ("sc", "sc_int")]


@functools.lru_cache(maxsize=None)
def _model(name):
    arch, kw = CFGS[name]
    jc = jget_arch(arch).scaled(attn_q_chunk=8, **{**SCALE, **kw})
    c = get_arch(arch).scaled(**{**SCALE, **kw})
    jp = jinit_params(jax.random.key(0), jc)
    return jc, c, jp, jax.tree.map(np.asarray, jp)


def _case(name="attn", **kw):
    _, c, _, pn = _model(name)
    return dict(cfg=c, params=pn, **kw)


@functools.lru_cache(maxsize=None)
def _cases():
    cases = {}
    for dp in DATAPATHS:
        cases[f"greedy-{dp}"] = _case(engine=dict(datapath=dp),
                                      sums=dp == "sc_int")
        cases[f"sampled-{dp}"] = _case(engine=dict(datapath=dp),
                                       sampling=SAMPLED)
    for fmt, dp in COMPRESSED:
        cases[f"compressed-{fmt}-{dp}"] = _case(
            engine=dict(datapath=dp, kv_format=fmt))
    cases["uneven"] = _case("uneven")
    for dp in ("qat", "sc_int"):
        cases[f"spec-{dp}"] = _case(engine=dict(
            datapath=dp, spec_decode=True, draft_len=3), max_new=6)
        cases[f"plain6-{dp}"] = _case(engine=dict(datapath=dp), max_new=6)
    cases["spec-sampled"] = _case(engine=dict(
        datapath="sc_int", spec_decode=True, draft_len=3), max_new=6,
        sampling=SAMPLED)
    cases["plain6-sampled"] = _case(engine=dict(datapath="sc_int"),
                                    max_new=6, sampling=SAMPLED)
    cases["logprobs"] = _case(engine=dict(
        datapath="qat", spec_decode=True, draft_len=3), max_new=5,
        sampling=LOGPROBS)
    # parameters cut by weights.from_jax(mesh=) before the engine
    cases["shard-first"] = _case(engine=dict(datapath="sc_int"),
                                 shard_first=True)
    return cases



@pytest.fixture(scope="module")
def ranks():
    """Each mesh's per-rank results, every case run in one start of the
    ranks; the reference's runs go meanwhile."""
    job = mw.Job(MESHES, _cases())
    mw.run_all([functools.partial(_reference, "attn", dp, sampled=smp)
                for dp in DATAPATHS for smp in (False, True)]
               + [functools.partial(_reference, "attn", dp, fmt)
                  for fmt, dp in COMPRESSED]
               + [functools.partial(_reference, "uneven", "qat")])
    return job.collect()


@functools.lru_cache(maxsize=None)
def _off(cid):
    return mw.serve(_cases()[cid])


def _on(ranks, mesh, cid):
    """The case's result on rank 0, after checking that every rank
    committed the same tokens and logprobs."""
    res = [r[cid] for r in ranks[mesh]]
    for r in res[1:]:
        assert r["generated"] == res[0]["generated"], (mesh, cid)
        assert r["logprobs"] == res[0]["logprobs"], (mesh, cid)
    return res[0]


@functools.lru_cache(maxsize=None)
def _reference(name, datapath, kv_format="fp", sampled=False):
    """The reference's mesh-off oracle."""
    jc, _, jp, _ = _model(name)
    sps = [JSamplingParams(**s) for s in SAMPLED] if sampled else None
    return jsequential_generate(jp, jc, mw.PROMPTS, max_new_tokens=4,
                                max_len=32, datapath=datapath,
                                kv_format=kv_format, sampling=sps)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("datapath", DATAPATHS)
def test_mesh_on_equals_mesh_off_equals_sequential(ranks, mesh, datapath):
    """The acceptance differential on the attention config: sharded ==
    unsharded (port) == the reference's oracle, on all three datapaths
    (the MoE config: ``test_torch_mesh_moe.py``)."""
    cid = f"greedy-{datapath}"
    got = _on(ranks, mesh, cid)["generated"]
    assert got == _off(cid)["generated"], (mesh, datapath)
    mw.assert_matches_reference(got, _reference("attn", datapath),
                                _cases()[cid], datapath)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("datapath", DATAPATHS)
def test_sampled_mesh_on_equals_mesh_off_equals_sequential(ranks, mesh,
                                                           datapath):
    """Seeded draws at temperature 0.8 / top-p 0.9: the logits are whole
    on every rank before the draw and the streams are keyed by (seed,
    position), so the mesh changes no token; equal to the reference's
    sampled oracle, and not its greedy tokens."""
    got = _on(ranks, mesh, f"sampled-{datapath}")["generated"]
    assert got == _off(f"sampled-{datapath}")["generated"]
    assert got == _reference("attn", datapath, sampled=True)
    assert got != _off(f"greedy-{datapath}")["generated"], \
        "sampling degenerated to greedy"


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("fmt,datapath", COMPRESSED)
def test_mesh_on_equals_mesh_off_compressed(ranks, mesh, fmt, datapath):
    """The compressed pools: quantize-on-scatter is per (position, head),
    so head-sharded pools change nothing."""
    cid = f"compressed-{fmt}-{datapath}"
    got = _on(ranks, mesh, cid)["generated"]
    assert got == _off(cid)["generated"]
    mw.assert_matches_reference(got, _reference("attn", datapath, fmt),
                                _cases()[cid], datapath)


@pytest.mark.parametrize("mesh", MESHES)
def test_kv_scale_and_residual_pools_shard_with_the_code_pages(ranks, mesh):
    """The scale and residual pools carry the code pages' KV-head split
    (a scale lives with its head's codes)."""
    shapes = _on(ranks, mesh, "compressed-sc-sc_int")["shapes"]
    full = _off("compressed-sc-sc_int")["shapes"]
    for leaf, hdim in (("k_pages", 2), ("k_resid", 2), ("k_scale", 2),
                       ("v_scale", 2)):
        key = f"cache/layers/0/{leaf}"
        assert shapes[key][hdim] * 2 == full[key][hdim] == SCALE[
            "n_kv_heads"], (mesh, leaf)


@pytest.mark.parametrize("mesh", MESHES)
def test_kv_pools_sharded_over_model_axis(ranks, mesh):
    """Pools shard their KV heads, wq its output columns, the embedding
    its vocabulary over "model" (and d_model over "data" on the (2, 2)
    mesh); pages and rows never."""
    shapes = _on(ranks, mesh, "greedy-qat")["shapes"]
    full = _off("greedy-qat")["shapes"]
    kp = "cache/layers/0/k_pages"
    assert shapes[kp] == (full[kp][0], full[kp][1], 2, full[kp][3])
    wq = "params/layers/0/mixer/wq/w"
    assert shapes[wq] == (full[wq][0], full[wq][1] // 2)
    assert shapes[wq[:-1] + "alpha_w"] == (full[wq][1] // 2,)
    table = "params/embed/table"
    dp = MESHES[mesh][1]
    assert shapes[table] == (full[table][0] // 2, full[table][1] // dp)


@pytest.mark.parametrize("mesh", MESHES)
def test_allocator_and_page_tables_ignore_the_mesh(ranks, mesh):
    """The host bookkeeping never sees the mesh: every step's page tables
    and free-page count are those of the mesh-off engine, on every
    rank."""
    for cid in ("greedy-qat", "sampled-sc_int", "spec-qat"):
        want = _off(cid)
        for r in ranks[mesh]:
            assert r[cid]["trace"] == want["trace"], (mesh, cid)
            assert r[cid]["num_pages"] == want["num_pages"]


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_commits_the_same_tokens(ranks, mesh):
    for cid in _cases():
        gens = [r[cid]["generated"] for r in ranks[mesh]]
        assert all(g == gens[0] for g in gens), (mesh, cid)
        assert len(gens[0]) == len(mw.PROMPTS)


def test_sc_int_sums_equal_mesh_off_bit_for_bit(ranks):
    """Every sc_int q-domain sum of the run (prefill and decode, every
    projection), each rank's output columns put back together, equals
    the mesh-off run's bit for bit (the (1, 2) mesh, whose lanes are
    not split)."""
    per_rank = [r["greedy-sc_int"]["sums"] for r in ranks["1x2"]]
    want = _off("greedy-sc_int")["sums"]
    got = mw.join_sums(per_rank)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert any(p.shape != w.shape for p, w in zip(per_rank[0], want))


@pytest.mark.parametrize("mesh", MESHES)
def test_from_jax_mesh_gives_this_ranks_block(ranks, mesh):
    """``weights.from_jax(..., mesh=)`` hands the engine blocks already
    cut: the engine keeps them as they are, with the same tokens."""
    got = _on(ranks, mesh, "shard-first")
    assert got["generated"] == _off("greedy-sc_int")["generated"]
    assert got["shapes"] == _on(ranks, mesh, "greedy-sc_int")["shapes"]


@pytest.mark.parametrize("mesh", MESHES)
def test_uneven_heads_degrade_to_replicated(ranks, mesh):
    """One KV head on a 2-way "model" axis: the pools and k / v stay
    whole (fit_spec), every rank attends with every head, and the tokens
    hold."""
    res = _on(ranks, mesh, "uneven")
    full = _off("uneven")
    kp = "cache/layers/0/k_pages"
    assert res["shapes"][kp] == full["shapes"][kp]
    assert res["shapes"][kp][2] == 1
    assert res["generated"] == full["generated"]
    mw.assert_matches_reference(res["generated"], _reference("uneven", "qat"),
                                _cases()["uneven"], "qat")


def test_mesh_engine_rejects_what_is_not_mesh_rules():
    """The mesh knob takes ``serving_rules(mesh)`` or None; the reference's
    rule against a pinned Pallas backend under a mesh has nothing to bind
    to in the port (no backend knob), so the port's config checks the
    knob's type instead."""
    with pytest.raises(ValueError, match="MeshRules"):
        EngineConfig(mesh=make_serving_mesh(1, 1)).validate()
    with pytest.raises(ValueError, match="MeshRules"):
        EngineConfig(mesh="model").validate()


def test_degenerate_mesh_equals_no_mesh():
    """A (1, 1) mesh, built with no process group at all, serves exactly
    like no mesh."""
    mesh = make_serving_mesh(model_parallel=1, data_parallel=1)
    assert (mesh_chips(mesh), mesh_name(mesh)) == (1, "1x1")
    rules = serving_rules(mesh)
    for cid in ("greedy-qat", "spec-sc_int"):
        got = mw.serve(_cases()[cid], rules)
        assert got["generated"] == _off(cid)["generated"]
        assert got["shapes"] == _off(cid)["shapes"]


def test_make_serving_mesh_raises_on_too_small_a_world():
    with pytest.raises(RuntimeError, match="needs 2 ranks, found 1"):
        make_serving_mesh(model_parallel=2)
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        make_serving_mesh(model_parallel=2, data_parallel=2)


def test_fit_spec_keeps_only_dividing_axes():
    mesh = make_serving_mesh(1, 1)
    assert fit_spec(("model", None), (4, 3), mesh) == ("model", None)
    assert fit_spec(("pod", "data"), (4, 4), mesh) == (None, "data")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("datapath", ["qat", "sc_int"])
def test_spec_decode_mesh_on_equals_mesh_off(ranks, mesh, datapath):
    """Drafting on sc_int_approx and verifying on the sharded target
    gives the mesh-off spec engine's tokens and the plain engine's."""
    got = _on(ranks, mesh, f"spec-{datapath}")["generated"]
    assert got == _off(f"spec-{datapath}")["generated"] \
        == _off(f"plain6-{datapath}")["generated"]
    assert got == _on(ranks, mesh, f"plain6-{datapath}")["generated"]


@pytest.mark.parametrize("mesh", MESHES)
def test_spec_decode_sampled_mesh_on_equals_mesh_off(ranks, mesh):
    got = _on(ranks, mesh, "spec-sampled")["generated"]
    assert got == _off("plain6-sampled")["generated"] \
        == _off("spec-sampled")["generated"]


@pytest.mark.parametrize("mesh", MESHES)
def test_logprobs_mesh_on_equals_mesh_off(ranks, mesh):
    """Logprob records (chosen and top-k), through speculative verify
    steps, equal the mesh-off engine's exactly."""
    got, want = _on(ranks, mesh, "logprobs"), _off("logprobs")
    assert got["generated"] == want["generated"]
    assert got["logprobs"] == want["logprobs"]
    assert all(len(lp) == len(g) for lp, g in zip(got["logprobs"],
                                                   got["generated"]))

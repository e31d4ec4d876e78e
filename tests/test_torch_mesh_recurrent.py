"""Mesh-sharded serving of the port: the recurrent cells.

As ``test_torch_mesh_serving.py`` (harness and rules:
``tests/mesh_worker.py``), on the reference's ``SCALE`` recurrent configs
(``tests/test_sharded_serving.py``): the jamba hybrid (mamba + attention
+ MoE in one period of 8 layers; mamba's ``d_inner`` 128 shards over
"model") and rwkv6 (4 wkv heads of 16 over "model"), with mamba's
``conv_w`` at 10x its draw so that the SSM state is live (as the port's
recurrent tests).  The chunked prefill's carried state stays in the
state rows' layout from chunk to chunk, and on the (2, 2) mesh every
layer's new rows of all lanes are gathered over "data" before the
scatter.  Mesh-on equals mesh-off exactly, and the reference's oracle up
to qat lattice ties (ROADMAP Queue 3 item 10).
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
from port_fixtures import _one_torch_thread, _partitionable  # noqa: F401

SCALE = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=64,
             vocab_pad_multiple=32, dtype="float32")
CFGS = {"jamba": ("jamba-1.5-large-398b",
                  dict(n_layers=8, mamba_d_state=8, n_experts=4,
                       n_experts_per_tok=2, moe_capacity_factor=2.0)),
        "rwkv": ("rwkv6-7b", dict(n_layers=2, rwkv_head_dim=16))}
MESHES = {"1x2": (2, 1), "2x2": (4, 2)}           # world, data_parallel
DATAPATHS = ["qat", "sc_int", "sc_int_approx"]
SAMPLED = [dict(temperature=0.8, top_p=0.9, seed=11 + i) for i in range(3)]


def _model_cfgs(name):
    arch, kw = CFGS[name]
    return (jget_arch(arch).scaled(attn_q_chunk=8, **{**SCALE, **kw}),
            get_arch(arch).scaled(**{**SCALE, **kw}))


@functools.lru_cache(maxsize=None)
def _model(name):
    jc, c = _model_cfgs(name)
    jp = mw.live_ssm(jinit_params(jax.random.key(0), jc))
    return jc, c, jp, jax.tree.map(np.asarray, jp)


def _case(name, **kw):
    _, c, _, pn = _model(name)
    return dict(cfg=c, params=pn, **kw)


@functools.lru_cache(maxsize=None)
def _cases():
    """Built on first use, not at import: every xdist worker imports every
    test file to collect it."""
    return {**{f"jamba-{dp}": _case("jamba", engine=dict(datapath=dp))
               for dp in DATAPATHS},
            "rwkv-greedy": _case("rwkv"),
            "rwkv-sampled": _case("rwkv", engine=dict(datapath="sc_int"),
                                  sampling=SAMPLED),
            "rwkv-greedy-sc_int": _case("rwkv",
                                        engine=dict(datapath="sc_int")),
            "rwkv-exact": _case("rwkv", engine=dict(prefill_mode="exact"))}


@functools.lru_cache(maxsize=None)
def _reference(name, datapath="qat", sampled=False):
    """The reference's mesh-off oracle."""
    jc, _, jp, _ = _model(name)
    sps = [JSamplingParams(**s) for s in SAMPLED] if sampled else None
    return jsequential_generate(jp, jc, mw.PROMPTS, max_new_tokens=4,
                                max_len=32, datapath=datapath, sampling=sps)


@pytest.fixture(scope="module")
def ranks():
    """Each mesh's per-rank results, every case run in one start of the
    ranks; the reference's runs go meanwhile."""
    job = mw.Job(MESHES, _cases())
    mw.run_all([functools.partial(_reference, "jamba", dp)
                for dp in DATAPATHS]
               + [functools.partial(_reference, "rwkv"),
                  functools.partial(_reference, "rwkv", "sc_int", True)])
    return job.collect()


@functools.lru_cache(maxsize=None)
def _off(cid):
    return mw.serve(_cases()[cid])


def _on(ranks, mesh, cid):
    res = [r[cid] for r in ranks[mesh]]
    for r in res[1:]:
        assert r["generated"] == res[0]["generated"], (mesh, cid)
        assert r["trace"] == res[0]["trace"], (mesh, cid)
    return res[0]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("datapath", DATAPATHS)
def test_recurrent_chunked_mesh_on_equals_mesh_off(ranks, mesh, datapath):
    """The jamba hybrid through the batched chunked paged prefill under
    the mesh: sharded == unsharded == the reference's oracle, every
    datapath."""
    cid = f"jamba-{datapath}"
    got = _on(ranks, mesh, cid)["generated"]
    assert got == _off(cid)["generated"], (mesh, datapath)
    mw.assert_matches_reference(got, _reference("jamba", datapath),
                                _cases()[cid], datapath)


@pytest.mark.parametrize("mesh", MESHES)
def test_recurrent_state_rows_shard_over_channels(ranks, mesh):
    """mamba's ``h`` / conv tail over ``d_inner``, rwkv6's ``s`` over its
    heads, the token shifts whole; rows never."""
    jam = _on(ranks, mesh, "jamba-qat")["shapes"]
    jfull = _off("jamba-qat")["shapes"]
    h, conv = "cache/layers/0/h", "cache/layers/0/conv"
    assert jam[h] == (jfull[h][0], jfull[h][1] // 2, jfull[h][2])
    assert jam[conv] == (jfull[conv][0], jfull[conv][1], jfull[conv][2] // 2)
    rw = _on(ranks, mesh, "rwkv-greedy")["shapes"]
    rfull = _off("rwkv-greedy")["shapes"]
    s = "cache/layers/0/s"
    assert rw[s] == (rfull[s][0], rfull[s][1] // 2, *rfull[s][2:])
    for key in ("cache/layers/0/shift", "cache/layers/0/cmix/shift"):
        assert rw[key] == rfull[key]


@pytest.mark.parametrize("mesh", MESHES)
def test_recurrent_sampled_mesh_on_equals_mesh_off(ranks, mesh):
    """Seeded draws over the chunked recurrent prefill (rwkv6: the time
    and channel mixes' state rows).  On sc_int, not the reference cell's
    qat: there the lattice ties of Queue 3 item 10 order top-p's
    candidates differently in the two packages, so the kept set, and the
    draw, may part from the reference's at a tie."""
    got = _on(ranks, mesh, "rwkv-sampled")["generated"]
    assert got == _off("rwkv-sampled")["generated"]
    assert got == _reference("rwkv", "sc_int", True)
    assert got != _off("rwkv-greedy-sc_int")["generated"], \
        "sampling degenerated to greedy"


@pytest.mark.parametrize("mesh", MESHES)
def test_recurrent_exact_oracle_sharded_matches_sequential(ranks, mesh):
    """``prefill_mode="exact"`` under the mesh: the dense prefill runs on
    each rank's heads and its state goes into the rank's rows, giving
    the chunked engine's tokens and the reference's oracle's."""
    got = _on(ranks, mesh, "rwkv-exact")["generated"]
    assert got == _off("rwkv-exact")["generated"] \
        == _on(ranks, mesh, "rwkv-greedy")["generated"]
    mw.assert_matches_reference(got, _reference("rwkv"), _cases()["rwkv-exact"],
                                "qat")

"""Mesh-sharded serving of the port: the expert-parallel cells, and the
paged-attention kernel cell.

As ``test_torch_mesh_serving.py`` (whose harness and rules these cells
share, ``tests/mesh_worker.py``), on the reference's ``SCALE`` MoE
config (``tests/test_sharded_serving.py``: dbrx, 4 experts top-2,
capacity factor 2 = E / k, so no token drops) and its attention config:
2 ranks as (1, 2) and 4 as (2, 2).  Under the mesh a rank owns E / 2
whole experts (one batched product over them), and on the (2, 2) mesh
each expert's output channels split over "data" with the hidden layer
gathered before ``w_down``; every token goes through the routing of the
unsharded call.  Mesh-on equals mesh-off exactly and the reference's
oracle up to qat lattice ties (ROADMAP Queue 3 item 10).
"""

import functools

import jax
import numpy as np
import pytest

import mesh_worker as mw
from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.serving import ServeEngine as JServeEngine
from repro.serving import sequential_generate as jsequential_generate
from repro_torch.configs import get_arch
from port_fixtures import _one_torch_thread, _partitionable  # noqa: F401

SCALE = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=64,
             vocab_pad_multiple=32, dtype="float32")
CFGS = {"attn": ("granite-3-2b", dict(n_layers=2)),
        "moe": ("dbrx-132b", dict(n_layers=2, n_experts=4,
                                  n_experts_per_tok=2,
                                  moe_capacity_factor=2.0))}
MESHES = {"1x2": (2, 1), "2x2": (4, 2)}           # world, data_parallel
DATAPATHS = ["qat", "sc_int", "sc_int_approx"]


@functools.lru_cache(maxsize=None)
def _model(name):
    arch, kw = CFGS[name]
    jc = jget_arch(arch).scaled(attn_q_chunk=8, **{**SCALE, **kw})
    c = get_arch(arch).scaled(**{**SCALE, **kw})
    jp = jinit_params(jax.random.key(0), jc)
    return jc, c, jp, jax.tree.map(np.asarray, jp)


@functools.lru_cache(maxsize=None)
def _cases():
    """Built on first use, not at import: every xdist worker imports every
    test file to collect it."""
    return {f"{name}-{dp}": dict(cfg=_model(name)[1], params=_model(name)[3],
                                 engine=dict(datapath=dp))
            for name in CFGS for dp in DATAPATHS}


@functools.lru_cache(maxsize=None)
def _reference(datapath):
    jc, _, jp, _ = _model("moe")
    return jsequential_generate(jp, jc, mw.PROMPTS, max_new_tokens=4,
                                max_len=32, datapath=datapath)


@functools.lru_cache(maxsize=None)
def _kernel_engine(datapath):
    """The reference's mesh-off engine pinned to its paged-attention
    Pallas kernel (interpret mode)."""
    jc, _, jp, _ = _model("attn")
    jeng = JServeEngine(jp, jc, datapath=datapath,
                        attn_backend="pallas-interpret", **mw.ENGINE)
    for p in mw.PROMPTS:
        jeng.submit(p, max_new_tokens=4)
    return [r.generated for r in sorted(jeng.run_to_completion(),
                                        key=lambda r: r.rid)]


@pytest.fixture(scope="module")
def ranks():
    """Each mesh's per-rank results, every case run in one start of the
    ranks; the reference's runs go meanwhile."""
    job = mw.Job(MESHES, _cases())
    mw.run_all([functools.partial(f, dp) for dp in DATAPATHS
                for f in (_reference, _kernel_engine)])
    return job.collect()


@functools.lru_cache(maxsize=None)
def _off(cid):
    return mw.serve(_cases()[cid])


def _on(ranks, mesh, cid):
    res = [r[cid] for r in ranks[mesh]]
    for r in res[1:]:
        assert r["generated"] == res[0]["generated"], (mesh, cid)
    return res[0]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("datapath", DATAPATHS)
def test_moe_mesh_on_equals_mesh_off_equals_sequential(ranks, mesh,
                                                       datapath):
    """The acceptance differential on the MoE config (the attention
    config's: ``test_torch_mesh_serving.py``)."""
    cid = f"moe-{datapath}"
    got = _on(ranks, mesh, cid)["generated"]
    assert got == _off(cid)["generated"], (mesh, datapath)
    mw.assert_matches_reference(got, _reference(datapath), _cases()[cid],
                                datapath)


@pytest.mark.parametrize("mesh", MESHES)
def test_experts_are_whole_per_rank(ranks, mesh):
    """A rank holds E / 2 experts, each whole along its contraction: the
    (1, 2) mesh keeps every expert's d_ff and d_model, the (2, 2) mesh
    splits each expert's output channels (``w_up``'s d_ff, ``w_down``'s
    d_model) over "data"; the router stays whole."""
    shapes = _on(ranks, mesh, "moe-sc_int")["shapes"]
    full = _off("moe-sc_int")["shapes"]
    dp = MESHES[mesh][1]
    ffn = "params/layers/0/ffn/"
    E, D, F = full[ffn + "w_up/w"]
    assert shapes[ffn + "w_up/w"] == (E // 2, D, F // dp)
    assert shapes[ffn + "w_down/w"] == (E // 2, F, D // dp)
    assert shapes[ffn + "w_up/alpha_w"] == (E // 2, 1, F // dp)
    assert shapes[ffn + "router"] == full[ffn + "router"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("datapath", DATAPATHS)
def test_kernel_attention_mesh_on_equals_mesh_off(ranks, mesh, datapath):
    """Each rank runs the paged-attention dispatch (the CUDA kernels on
    the card, their plain versions here) on its own heads, where the
    reference's mesh serves its XLA gather: mesh-on equals the
    reference's mesh-off engine pinned to its Pallas kernel (interpret
    mode)."""
    got = _on(ranks, mesh, f"attn-{datapath}")["generated"]
    mw.assert_matches_reference(got, _kernel_engine(datapath),
                                _cases()[f"attn-{datapath}"], datapath)


@functools.lru_cache(maxsize=None)
def _kernel_engine(datapath):
    jc, _, jp, _ = _model("attn")
    jeng = JServeEngine(jp, jc, datapath=datapath,
                        attn_backend="pallas-interpret", **mw.ENGINE)
    for p in mw.PROMPTS:
        jeng.submit(p, max_new_tokens=4)
    return [r.generated for r in sorted(jeng.run_to_completion(),
                                        key=lambda r: r.rid)]

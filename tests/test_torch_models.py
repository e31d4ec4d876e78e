"""The port's model layers and the paged prefill / decode step against
the JAX reference, on parameters carried over by ``weights.from_jax``.

Tiny granite-3-2b (2 layers, d_model 64, float32), the reference's
``kernels/ref.py`` attention on the JAX side.  Tolerances:

* ``dense_apply`` / norm / rope: ``atol=1e-5`` (float32; the port
  accumulates products and RMSNorm's mean square in float64);
* logits: ``atol=1e-5`` on the sc_int datapaths, whose projections are
  exact integer sums, and on qat.  The qat fake-quant lattice turns a
  one-ulp difference in a K/V value into a whole level of its int8 code
  now and then, so the decode step is compared on the SAME cache: the
  port continues from the reference's post-prefill pools.
* pools after prefill: fp within ``atol=1e-5``; int8 / sc codes within
  one level and scales within ``rtol=1e-5`` (same one-ulp cause).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import sc_layers as jsc
from repro.kernels import dispatch as jdispatch
from repro.models import common as jcommon
from repro.models import init_params as jinit_params
from repro.models import transformer as jtf
from repro_torch.configs import get_arch
from repro_torch.core.sc_layers import SCQuantConfig
from repro_torch.models import common, init_paged_cache, paged_decode_step
from repro_torch.models import paged_prefill
from repro_torch.weights import from_jax
from port_fixtures import _one_torch_thread  # noqa: F401


SCALE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=64, vocab_pad_multiple=32, dtype="float32")
JCFG = jget_arch("granite-3-2b").scaled(attn_q_chunk=8, **SCALE)
CFG = get_arch("granite-3-2b").scaled(**SCALE)
PAIRS = [("qat", "fp"), ("qat", "int8"), ("sc_int", "fp"),
         ("sc_int", "int8"), ("sc_int", "sc"), ("sc_int_approx", "fp"),
         ("sc_int_approx", "int8"), ("sc_int_approx", "sc")]
ATOL = 1e-5


@pytest.fixture(scope="module")
def params():
    jp = jinit_params(jax.random.key(0), JCFG)
    return jp, from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _with_datapath(jcfg, cfg, datapath):
    if datapath == "qat":
        return jcfg, cfg
    kw = dict(mode="sc_int", int_approx=datapath == "sc_int_approx")
    return (jcfg.scaled(quant=dataclasses.replace(jcfg.quant, **kw)),
            cfg.scaled(quant=dataclasses.replace(cfg.quant, **kw)))


def test_from_jax_unstacks_layers_and_keeps_scales(params):
    jp, tp = params
    assert len(tp["layers"]) == CFG.n_layers
    for i, lp in enumerate(tp["layers"]):
        jl = jax.tree.map(lambda a: np.asarray(a)[i], jp["periods"]["p0"])
        np.testing.assert_array_equal(lp["mixer"]["wq"]["w"].numpy(),
                                      jl["mixer"]["wq"]["w"])
        np.testing.assert_array_equal(lp["ffn"]["w_down"]["alpha_w"].numpy(),
                                      jl["ffn"]["w_down"]["alpha_w"])
        assert float(lp["alpha_r1"]) == float(jl["alpha_r1"])
        assert float(lp["mixer"]["wo"]["alpha_a"]) == \
            float(jl["mixer"]["wo"]["alpha_a"])
    np.testing.assert_array_equal(tp["lm_head"]["w"].numpy(),
                                  np.asarray(jp["lm_head"]["w"]))


def test_from_jax_carries_bfloat16():
    a = np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3)
    from repro_torch.weights import to_torch
    t = to_torch(a, torch.device("cpu"))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("mode", ["none", "sc_qat", "sc_int",
                                  "sc_int_approx"])
def test_dense_apply_matches(params, mode):
    jp, tp = params
    jq = jsc.SCQuantConfig(mode="sc_int" if mode == "sc_int_approx"
                           else mode, int_approx=mode == "sc_int_approx")
    tq = SCQuantConfig(mode=jq.mode, int_approx=jq.int_approx)
    x = np.random.default_rng(1).standard_normal((3, 5, 64)) \
        .astype(np.float32)
    p = tp["layers"][1]["mixer"]["wq"]
    jw = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[1]),
                      jp["periods"]["p0"]["mixer"]["wq"])
    with jdispatch.backend_scope("reference"):
        want = np.asarray(jcommon.dense_apply(jw, jnp.asarray(x), jq))
    got = common.dense_apply(p, _t(x), tq).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_norm_and_rope_match():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        common.norm_apply({"scale": _t(scale)}, _t(x), "rmsnorm").numpy(),
        np.asarray(jcommon.norm_apply({"scale": jnp.asarray(scale)},
                                      jnp.asarray(x), "rmsnorm")),
        rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        common.apply_rope(_t(x), _t(pos), 16, 1.0, 1e4).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 16,
                                      1.0, 1e4)),
        rtol=0, atol=ATOL)


def _port_cache(jcache, n_layers):
    return {"layers": [{k: _t(np.asarray(v)[i])
                        for k, v in jcache["periods"]["p0"].items()}
                       for i in range(n_layers)]}


def _assert_pools_close(jcache, cache, fmt):
    for i, layer in enumerate(cache["layers"]):
        for k, v in layer.items():
            want = np.asarray(jcache["periods"]["p0"][k])[i]
            got = v.numpy()
            if fmt == "fp":
                np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
            elif k.endswith("_scale"):
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
            else:
                assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("datapath,fmt", PAIRS)
def test_paged_prefill_then_decode_logits_match(params, datapath, fmt):
    jp, tp = params
    jcfg, cfg = _with_datapath(JCFG, CFG, datapath)
    page, G, L, maxp = 4, 2, 8, 4
    n = G * maxp + 1
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 64, (G, L)).astype(np.int32)
    plens = np.array([5, 8], np.int32)
    tables = (1 + np.arange(G * maxp).reshape(G, maxp)).astype(np.int32)
    slots = np.arange(G, dtype=np.int32)
    prefill = jax.jit(jtf.paged_prefill, static_argnames=("cfg", "chunk"))
    decode = jax.jit(jtf.paged_decode_step, static_argnames=("cfg",))
    with jdispatch.backend_scope("reference"), \
            jdispatch.attn_backend_scope("reference"):
        jcache = jtf.init_paged_cache(jcfg, G, n, page, fmt)
        jl, jcache = prefill(jp, jcache, toks, tables, plens, cfg=jcfg,
                             chunk=4, slot_ids=slots)
        nxt = np.asarray(jnp.argmax(jl[:, :64], -1)).astype(np.int32)
        jl2, jcache2 = decode(jp, jcache, nxt, slots, tables, plens,
                              cfg=jcfg)
    cache = init_paged_cache(cfg, G, n, page, fmt, device="cpu")
    tl, cache = paged_prefill(tp, cache, _t(toks), _t(tables), _t(plens),
                              cfg, chunk=4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    _assert_pools_close(jcache, cache, fmt)
    # the decode step continues from the reference's own pools
    cache = _port_cache(jcache, CFG.n_layers)
    tl2, cache = paged_decode_step(tp, cache, _t(nxt), _t(slots),
                                   _t(tables), _t(plens), cfg)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=0,
                               atol=ATOL)
    _assert_pools_close(jcache2, cache, fmt)

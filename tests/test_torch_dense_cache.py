"""The port's dense (unpaged) serving path against the JAX reference:
``forward(mode="prefill")``, ``prefill``, ``init_cache``, ``decode_step``
and ``attention.attn_decode``; ``weights.dense_cache_from_jax``; and
``paging.kv_page_bytes`` / ``slots_per_gib``.  The dense fp oracle of
``sequential_generate`` and ``ServeEngine(prefill_mode="exact")`` are held
in ``tests/test_torch_dense_oracle.py``, which shares this file's models
and helpers.

Models are ``REDUCED`` of ``tests/test_models_smoke.py`` (float32,
parameters from the reference's ``init_params`` carried over by
``weights.from_jax``; mamba's ``conv_w`` at 10x the reference's draw
where tokens are compared, so that the SSM state is live, as
``tests/test_torch_recurrent_serving.py``).  Tolerances:

* prefill + teacher-forced decode against the training forward (the
  reference's ``test_prefill_decode_matches_forward``): 2e-4;
* ``prefill`` logits and cache entries, ``decode_step`` logits from the
  reference's own cache: 1e-5 with quantization off and under sc_int,
  5e-5 under sc_qat (whose fake-quant lattice passes a one-ulp difference
  on as a whole level now and then, as ``tests/test_torch_recurrent.py``),
  times the largest magnitude of the compared tensor where it exceeds 1
  (rwkv's state reaches ~6; tiny jamba's float32 logits through eight
  layers part by 1.7e-5 at |logit| ~ 2); ``attn_decode``: 1e-5;
* page accounting: equal, and equal to the bytes of the port's pools.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import attention as jattention
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.serving.engine import _pad_prefill_cache as _jpad_prefill_cache
from repro.serving.paging import kv_page_bytes as jkv_page_bytes
from repro.serving.paging import slots_per_gib as jslots_per_gib
from repro_torch.configs import get_arch
from repro_torch.models import (attention, decode_step, forward, init_cache,
                                prefill)
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import _pad_prefill_cache
from repro_torch.serving.paging import kv_page_bytes, slots_per_gib
from repro_torch.weights import dense_cache_from_jax, from_jax, tree_to_torch
from port_fixtures import _one_torch_thread  # noqa: F401

TOL = {"none": 1e-5, "sc_int": 1e-5, "sc_qat": 5e-5}
# tests/test_models_smoke.py
REDUCED = {
    "granite-3-2b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=131),
    "rwkv6-7b": dict(n_layers=2, d_model=64, d_ff=128, vocab_size=131,
                     n_heads=4, n_kv_heads=4, rwkv_head_dim=16),
    "jamba-1.5-large-398b": dict(n_layers=8, d_model=64, n_heads=4,
                                 n_kv_heads=2, d_ff=96, vocab_size=131,
                                 n_experts=4, n_experts_per_tok=2,
                                 mamba_d_state=8, moe_group_size=16,
                                 moe_capacity_factor=2.0),
    "qwen3-moe-235b-a22b": dict(n_layers=2, d_model=64, n_heads=4,
                                n_kv_heads=2, d_ff=48, vocab_size=131,
                                n_experts=8, n_experts_per_tok=2,
                                moe_group_size=16, moe_capacity_factor=4.0)}
COMMON = dict(dtype="float32", mamba_chunk=8, vocab_pad_multiple=32)
ARCHS = tuple(REDUCED)
SERVED = ("granite-3-2b", "rwkv6-7b", "jamba-1.5-large-398b")
B, S = 2, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _cfgs(arch, mode="sc_qat"):
    jc = jget_arch(arch).scaled(attn_q_chunk=8, attn_kv_chunk=8, **COMMON,
                                **REDUCED[arch])
    c = get_arch(arch).scaled(**COMMON, **REDUCED[arch])
    if mode == "none":
        return (jc.scaled(quant=jc.quant.with_mode("none")),
                c.scaled(quant=c.quant.with_mode("none")))
    if mode == "sc_int":
        return (jc.scaled(quant=dataclasses.replace(jc.quant, mode="sc_int")),
                c.scaled(quant=dataclasses.replace(c.quant, mode="sc_int")))
    return jc, c


def _live_ssm(jp):
    periods = {name: dict(pp, mixer=dict(pp["mixer"],
                                         conv_w=pp["mixer"]["conv_w"] * 10))
               if "conv_w" in pp["mixer"] else pp
               for name, pp in jp["periods"].items()}
    return dict(jp, periods=periods)


def _tokens_np(c, seed=0):
    return np.random.default_rng(seed).integers(
        0, c.vocab_size, (B, S)).astype(np.int32)


def _close(got, want, tol, msg=""):
    """|got - want| <= tol * max(1, max |want|) (module docstring)."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= tol, (msg, err)


# ---------------------------------------------------------------------------
# the dense entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The port of the reference's test: teacher-forced training-forward
    logits == prefill of the first half + one decode_step a token of the
    rest (attention's K / V cache, mamba's and rwkv's state).  Mamba's
    conv taps are scaled by ``_live_ssm``: at the init scale every SSM
    input rounds to level 0 under sc_qat and the state would stay zero."""
    jc, c = _cfgs(arch)
    tp = from_jax(_np(_live_ssm(jinit_params(jax.random.key(1), jc))), c,
                  device="cpu")
    toks = _t(_tokens_np(c))
    with torch.no_grad():
        ref, _ = forward(tp, {"tokens": toks}, c)
        half = S // 2
        logits, cache = prefill(tp, {"tokens": toks[:, :half]}, c)
        np.testing.assert_allclose(logits[:, -1].numpy(),
                                   ref[:, half - 1].numpy(), rtol=2e-4,
                                   atol=2e-4)
        cache = _pad_prefill_cache(cache, S)       # the reference's grow
        for i in range(half, S):
            logits, cache = decode_step(tp, cache, toks[:, i:i + 1], c)
            np.testing.assert_allclose(logits[:, 0].numpy(),
                                       ref[:, i].numpy(), rtol=2e-4,
                                       atol=2e-4, err_msg=f"{arch} {i}")
    assert int(cache["pos"]) == S


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_has_the_reference_shapes(arch):
    jc, c = _cfgs(arch)
    jcache = jinit_cache(jc, 3, 10)
    cache = init_cache(c, 3, 10, device="cpu")
    assert cache["pos"].dtype == torch.int32 and int(cache["pos"]) == 0
    for i, e in enumerate(cache["layers"]):
        je = jcache["periods"][f"p{i % len(c.period)}"]
        want = jax.tree.map(lambda a: (a.shape[1:], str(a.dtype)), je)
        got = jax.tree.map(lambda a: (tuple(a.shape),
                                      str(a.dtype).split(".")[-1]), e,
                           is_leaf=lambda a: isinstance(a, torch.Tensor))
        assert got == want, i
        assert not any(bool(a.any()) for a in jax.tree.leaves(
            e, is_leaf=lambda a: isinstance(a, torch.Tensor)))


@pytest.mark.parametrize("mode", ["none", "sc_int", "sc_qat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, mode):
    """``prefill``: logits and every cache entry against the reference's;
    then two ``decode_step``s continuing from the reference's own cache
    (``dense_cache_from_jax``): logits and the new cache."""
    jc, c = _cfgs(arch, mode)
    jp = _live_ssm(jinit_params(jax.random.key(2), jc))
    tp = from_jax(_np(jp), c, device="cpu")
    toks = _tokens_np(c, 3)
    tol = TOL[mode]
    # 2 x 8 prompt tokens: whole MoE dispatch groups of 16 in the reference
    jl, jcache = jprefill(jp, {"tokens": jnp.asarray(toks[:, :8])}, jc)
    with torch.no_grad():
        tl, cache = prefill(tp, {"tokens": _t(toks[:, :8])}, c)
    _close(tl.numpy(), jl, tol)
    want = dense_cache_from_jax(_np(jcache), c, device="cpu")
    assert int(cache["pos"]) == int(want["pos"]) == 8
    for i, (e, we) in enumerate(zip(cache["layers"], want["layers"])):
        assert jax.tree.structure(e) == jax.tree.structure(we), i
        for a, w in zip(jax.tree.leaves(e), jax.tree.leaves(we)):
            _close(a.numpy(), w.numpy(), tol, i)
    jcache = _jpad_prefill_cache(jcache, 16)
    cache = dense_cache_from_jax(_np(jcache), c, device="cpu")
    for i in (8, 9):
        jl, jcache = jdecode_step(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                                  jc)
        with torch.no_grad():
            tl, cache = decode_step(tp, cache, _t(toks[:, i:i + 1]), c)
        _close(tl.numpy(), jl, tol, i)
        # continue the next step from the reference's cache again
        cache = dense_cache_from_jax(_np(jcache), c, device="cpu")
    assert int(cache["pos"]) == 10


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_attn_decode_matches_reference(pos):
    """The layer alone: a (2, 12, Hkv, Dh) cache holding random K / V,
    the new token written at ``pos`` and attended with the later
    positions masked; y and both caches within 1e-5."""
    jc, c = _cfgs("granite-3-2b", "none")
    rng = np.random.default_rng(pos)
    jp = jattention.attn_init(jax.random.key(3), jc)
    tp = tree_to_torch(_np(jp), "cpu")
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    kc = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    jy, jk, jv = jattention.attn_decode(jp, jnp.asarray(x), jc,
                                        jnp.asarray(kc), jnp.asarray(vc),
                                        jnp.asarray(pos, jnp.int32))
    y, k, v = attention.attn_decode(tp, _t(x), c, _t(kc), _t(vc),
                                    torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", SERVED)
def test_forward_prefill_mode_returns_hidden_and_cache(arch):
    """``return_hidden`` gives the final normed hidden state, and the cache
    entries are those of ``prefill``."""
    _, c = _cfgs(arch)
    from repro_torch.models import init_params
    tp = init_params(c, torch.Generator().manual_seed(0), "cpu")
    toks = {"tokens": _t(_tokens_np(c))}
    with torch.no_grad():
        h, aux, entries = forward(tp, toks, c, mode="prefill",
                                  return_hidden=True)
        logits, cache = prefill(tp, toks, c)
    assert h.shape == (B, S, c.d_model)
    assert logits.shape == (B, S, c.padded_vocab)
    assert bool(torch.isfinite(aux)) and len(entries) == c.n_layers
    for a, b in zip(jax.tree.leaves(entries), jax.tree.leaves(
            cache["layers"])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="mode"):
        forward(tp, toks, c, mode="decode")


# ---------------------------------------------------------------------------
# page accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
@pytest.mark.parametrize("page,hkv,dh,dbytes", [(16, 8, 64, 2),
                                                (4, 2, 16, 4),
                                                (8, 8, 128, 2)])
def test_page_accounting_matches_reference(fmt, page, hkv, dh, dbytes):
    assert kv_page_bytes(page, hkv, dh, fmt, dbytes) == \
        jkv_page_bytes(page, hkv, dh, fmt, dbytes)
    for max_len, layers in ((256, 1), (4096, 40), (33, 3)):
        assert slots_per_gib(max_len, page, hkv, dh, fmt, dbytes, layers) \
            == jslots_per_gib(max_len, page, hkv, dh, fmt, dbytes, layers)


@pytest.mark.parametrize("datapath,fmt", [("qat", "fp"), ("qat", "int8"),
                                          ("sc_int", "sc")])
def test_pool_bytes_match_page_accounting(datapath, fmt):
    """Each attention layer's pools hold ``num_pages * kv_page_bytes``
    bytes (the reference's ``test_pool_device_bytes_match_page_
    accounting``)."""
    _, c = _cfgs("granite-3-2b")
    from repro_torch.models import init_params
    tp = init_params(c, torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(tp, c, max_slots=2, max_len=32, page_size=8,
                      datapath=datapath, kv_format=fmt, device="cpu")
    per_page = kv_page_bytes(8, c.n_kv_heads, c.head_dim, fmt,
                             torch.finfo(getattr(torch, c.dtype)).bits // 8)
    for e in eng.cache["layers"]:
        got = sum(v.numel() * v.element_size() for k, v in e.items()
                  if k.startswith(("k_", "v_")))
        assert got == eng.allocator.num_pages * per_page


def test_unknown_kv_format_is_refused():
    with pytest.raises(ValueError, match="kv_format"):
        kv_page_bytes(8, 2, 16, "fp4")

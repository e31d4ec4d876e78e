"""The recurrent mixers on the port's serving path against the JAX
reference: mamba (``models/mamba.py``), rwkv6's time mix and channel mix
(``models/rwkv6.py``), their state rows in the paged cache, and the
rwkv6-7b and jamba-1.5-large-398b models through the engine.

Sizes are the reference's own: ``MAMBA_CFG`` / ``RWKV_CFG`` of
``tests/test_recurrent_prefill.py`` for the mixers, ``REDUCED`` of
``tests/test_models_smoke.py`` for the models; float32, inputs from numpy
seeds, parameters carried over by ``weights.tree_to_torch`` /
``from_jax``.  The reference's zero-initialised leaves (``maa*``, ``u``,
``mk`` / ``mr``, ``conv_b``) get small random values in the mixer tests,
so that every term of the recurrences is exercised; in the model tests
mamba's ``conv_w`` is 10x the reference's draw: at the reference's scale
every input of ``x_proj`` rounds to activation level 0 on every serving
datapath, so B, C and dt are constants and the SSM state stays zero.
Tolerances:

* mixer outputs and states against the reference: ``atol=1e-5`` with
  quantization off and under sc_int (float32; the port takes its
  products in float64 and its readout sums in another order);
* the carried token shift (a gathered input row) bit for bit, and the
  conv tail bit for bit under sc_int, whose ``in_proj`` output is the
  reference's to the bit (exact integer sums, the same float32 rescale);
* chunk-split invariance, masked padding and a fully masked chunk: the
  port against itself, bit for bit (the serving contract);
* grouped layernorm: ``atol=1e-5``;
* prefill and decode logits: ``atol=1e-5``, or ``5e-5`` under the qat
  datapath, whose fake-quant lattice passes a one-ulp difference on as a
  whole level now and then (as ``tests/test_torch_archs.py``); the
  decode continues from the reference's own cache (``cache_from_jax``);
The engines' tokens on the same models are in
``tests/test_torch_recurrent_serving.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LayerSpec as JLayerSpec
from repro.configs import get_arch as jget_arch
from repro.kernels import dispatch as jdispatch
from repro.launch.train import reduced_config as jreduced_config
from repro.models import common as jcommon
from repro.models import init_params as jinit_params
from repro.models import mamba as jmamba
from repro.models import rwkv6 as jrwkv6
from repro.models import transformer as jtf
from repro_torch.configs import LayerSpec, get_arch
from repro_torch.launch.train import reduced_config
from repro_torch.models import (common, forward, gather_state_rows,
                                init_paged_cache, init_params, mamba,
                                paged_decode_step, paged_prefill, rwkv6,
                                scatter_state_rows)
from repro_torch.weights import cache_from_jax, from_jax, tree_to_torch
from port_fixtures import _one_torch_thread  # noqa: F401


ATOL = 1e-5
QAT_ATOL = 5e-5
ARCHS = ("rwkv6-7b", "jamba-1.5-large-398b")
PAIRS = [("qat", "fp"), ("sc_int", "int8"), ("sc_int_approx", "sc")]

# tests/test_recurrent_prefill.py
MIXER_SCALE = {
    "jamba-1.5-large-398b": dict(
        period=(("mamba", "dense"),), n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=64, vocab_pad_multiple=32,
        dtype="float32", mamba_d_state=8),
    "rwkv6-7b": dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=64, vocab_pad_multiple=32, dtype="float32",
        rwkv_head_dim=16)}
B, S = 2, 13                 # S coprime with every split size below
# tests/test_models_smoke.py (REDUCED), float32
REDUCED = {
    "rwkv6-7b": dict(n_layers=2, d_model=64, d_ff=128, vocab_size=131,
                     n_heads=4, n_kv_heads=4, rwkv_head_dim=16),
    "jamba-1.5-large-398b": dict(n_layers=8, d_model=64, n_heads=4,
                                 n_kv_heads=2, d_ff=96, vocab_size=131,
                                 n_experts=4, n_experts_per_tok=2,
                                 mamba_d_state=8, moe_group_size=16,
                                 moe_capacity_factor=2.0)}
COMMON = dict(dtype="float32", vocab_pad_multiple=32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _with_mode(cfg, mode):
    if mode == "sc_int_approx":
        return cfg.scaled(quant=dataclasses.replace(
            cfg.quant, mode="sc_int", int_approx=True))
    return cfg.scaled(quant=cfg.quant.with_mode(mode))


def _mixer_cfgs(arch, mode):
    kw = dict(MIXER_SCALE[arch])
    period = kw.pop("period", None)
    jc, c = jget_arch(arch).scaled(**kw), get_arch(arch).scaled(**kw)
    if period:
        jc = jc.scaled(period=tuple(JLayerSpec(*s) for s in period))
        c = c.scaled(period=tuple(LayerSpec(*s) for s in period))
    return _with_mode(jc, mode), _with_mode(c, mode)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_carry_the_reference_fields():
    fields = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "head_dim", "norm", "ffn_act", "ffn_gated",
              "n_experts", "n_experts_per_tok", "moe_capacity_factor",
              "moe_group_size", "padded_vocab", "mamba_expand",
              "mamba_d_state", "mamba_d_conv", "mamba_dt_rank",
              "mamba_chunk", "rwkv_head_dim", "rwkv_lora_w",
              "rwkv_wkv_impl", "rwkv_chunk", "mamba_d_inner", "dt_rank",
              "opt_state_dtype", "quant")
    for arch in ARCHS:
        want, got = jget_arch(arch), get_arch(arch)
        for f in fields:
            w, g = getattr(want, f), getattr(got, f)
            if f == "quant":
                w, g = dataclasses.asdict(w), dataclasses.asdict(g)
            assert g == w, (arch, f)
        assert [(s.mixer, s.ffn) for s in got.period] == \
            [(s.mixer, s.ffn) for s in want.period]
        for kind in ("attn", "mamba", "rwkv6"):
            assert got.has_mixer(kind) == want.has_mixer(kind)
        for kind in ("dense", "moe", "rwkv_cmix"):
            assert got.has_ffn(kind) == want.has_ffn(kind)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor,seq", [(8, 256), (16, 32), (64, 16)])
def test_reduced_config_matches_the_reference(arch, factor, seq):
    want = jreduced_config(jget_arch(arch), factor, seq)
    got = reduced_config(get_arch(arch), factor, seq)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "head_dim", "n_experts", "n_experts_per_tok",
              "moe_group_size", "attn_q_chunk", "mamba_d_inner", "dt_rank",
              "rwkv_head_dim", "dtype"):
        assert getattr(got, f) == getattr(want, f), (arch, f)


@pytest.mark.parametrize("groups", [4, 16])
@pytest.mark.parametrize("bias", [True, False])
def test_grouped_layernorm_matches(groups, bias):
    rng = np.random.default_rng(groups)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32)}
    if bias:
        p["bias"] = rng.standard_normal(64).astype(np.float32)
    want = jcommon.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), "layernorm", eps=1e-5,
                              groups=groups)
    got = common.norm_apply({k: _t(v) for k, v in p.items()}, _t(x),
                            "layernorm", eps=1e-5, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 64])
def test_sum_fixed_is_the_sum(n):
    x = np.random.default_rng(n).standard_normal((3, n, 5)) \
        .astype(np.float32)
    got = common.sum_fixed(_t(x).double(), 1).numpy()
    np.testing.assert_allclose(got, x.astype(np.float64).sum(1), rtol=0,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

_ZERO_INIT = ("maa_x", "maa", "u", "mk", "mr", "conv_b")


def _perturb(p, rng):
    """Small random values on the reference's zero-initialised leaves."""
    return {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)
                            * 0.3) if k in _ZERO_INIT else v)
            for k, v in p.items()}


MIXERS = ("mamba", "rwkv_tmix", "rwkv_cmix")


def _mixer(name, mode):
    """(reference fn, port fn, reference params, port params, zero state
    as numpy) of one mixer; each fn is ``fn(p, x, state, valid=None)``
    for a prefill chunk and ``fn(p, x, state, decode=True)`` for one
    token."""
    arch = "jamba-1.5-large-398b" if name == "mamba" else "rwkv6-7b"
    jc, c = _mixer_cfgs(arch, mode)
    key = jax.random.key(7)
    rng = np.random.default_rng(11)
    if name == "mamba":
        jp = _perturb(jmamba.mamba_init(key, jc), rng)
        st = _np(jmamba.mamba_state_init(jc, B))
        mods = (jmamba.mamba_prefill_chunk, jmamba.mamba_decode,
                mamba.mamba_prefill_chunk, mamba.mamba_decode)
    elif name == "rwkv_tmix":
        jp = _perturb(jrwkv6.rwkv_tmix_init(key, jc), rng)
        st = _np(jrwkv6.rwkv_state_init(jc, B))
        mods = (jrwkv6.rwkv_tmix_prefill_chunk, jrwkv6.rwkv_tmix_decode,
                rwkv6.rwkv_tmix_prefill_chunk, rwkv6.rwkv_tmix_decode)
    else:
        jp = _perturb(jrwkv6.rwkv_cmix_init(key, jc), rng)
        st = {"shift": np.zeros((B, jc.d_model), np.float32)}
        mods = (jrwkv6.rwkv_cmix_prefill_chunk, jrwkv6.rwkv_cmix_decode,
                rwkv6.rwkv_cmix_prefill_chunk, rwkv6.rwkv_cmix_decode)
    jpre, jdec, tpre, tdec = mods

    def jfn(p, x, state, valid=None, decode=False):
        state = jax.tree.map(jnp.asarray, state)
        with jdispatch.backend_scope("reference"):
            if decode:
                return jdec(p, jnp.asarray(x), jc, state)
            return jpre(p, jnp.asarray(x), jc, state,
                        valid=None if valid is None else jnp.asarray(valid))

    def tfn(p, x, state, valid=None, decode=False):
        state = tree_to_torch(state, "cpu") \
            if not isinstance(next(iter(state.values())), torch.Tensor) \
            else state
        x = x if isinstance(x, torch.Tensor) else _t(x)
        if decode:
            return tdec(p, x, c, state)
        return tpre(p, x, c, state,
                    valid=None if valid is None else _t(valid))
    return jfn, tfn, jp, tree_to_torch(_np(jp), "cpu"), st


def _x(seed, n=S):
    return np.random.default_rng(seed).standard_normal((B, n, 64)) \
        .astype(np.float32)


def _state(jfn, jp, st0):
    """A nontrivial state: the reference's after a prompt of S tokens."""
    return _np(jfn(jp, _x(3), st0)[1])


def _close(got, want, atol):
    for k in want:
        if isinstance(want[k], dict):
            _close(got[k], want[k], atol)
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=atol, err_msg=k)


def _equal(a, b):
    for k in a:
        if isinstance(a[k], dict):
            _equal(a[k], b[k])
        else:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("mode", ["none", "sc_int"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", MIXERS)
def test_prefill_chunk_matches_reference(name, masked, mode):
    """Output and state of one chunk from a nontrivial state, with and
    without right padding (lane 0 holds 5 real tokens, lane 1 all 13)."""
    jfn, tfn, jp, tp, st0 = _mixer(name, mode)
    st = _state(jfn, jp, st0)
    x = _x(4)
    valid = np.stack([np.arange(S) < 5, np.ones(S, bool)]) if masked \
        else None
    jy, jst = jfn(jp, x, st, valid)
    ty, tst = tfn(tp, x, st, valid)
    rows = (slice(None), slice(0, 5)) if masked else (slice(None),)
    np.testing.assert_allclose(ty.numpy()[rows], np.asarray(jy)[rows],
                               rtol=0, atol=ATOL)
    _close(tst, _np(jst), ATOL)
    shift = tst.get("shift", tst.get("cmix", {}).get("shift"))
    if shift is not None:           # a gathered input row: bit for bit
        np.testing.assert_array_equal(shift.numpy(), np.asarray(jst["shift"]))
    if "conv" in tst and mode == "sc_int":
        np.testing.assert_array_equal(tst["conv"].numpy(),
                                      np.asarray(jst["conv"]))


@pytest.mark.parametrize("mode", ["none", "sc_int"])
@pytest.mark.parametrize("name", MIXERS)
def test_decode_matches_reference(name, mode):
    jfn, tfn, jp, tp, st0 = _mixer(name, mode)
    st = _state(jfn, jp, st0)
    x = _x(5, 1)
    jy, jst = jfn(jp, x, st, decode=True)
    ty, tst = tfn(tp, x, st, decode=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=ATOL)
    _close(tst, _np(jst), ATOL)
    if "shift" in tst:
        np.testing.assert_array_equal(tst["shift"].numpy(),
                                      np.asarray(jst["shift"]))
    if "conv" in tst and mode == "sc_int":
        np.testing.assert_array_equal(tst["conv"].numpy(),
                                      np.asarray(jst["conv"]))


@pytest.mark.parametrize("name", MIXERS)
@pytest.mark.parametrize("csize", [1, 4, S - 1])
def test_chunk_split_is_bit_exact(name, csize):
    """Any split of a prompt into chunks, the state threaded, gives the
    one-shot call's output and state bit for bit (sc_qat, the mixers'
    default: its lattice turns any difference into a whole level)."""
    _, tfn, _, tp, st0 = _mixer(name, "sc_qat")
    x = _t(_x(6))
    y1, st1 = tfn(tp, x, st0)
    st, ys = st0, []
    for a in range(0, S, csize):
        y, st = tfn(tp, x[:, a:a + csize], st)
        ys.append(y)
    assert torch.equal(torch.cat(ys, dim=1), y1)
    _equal(st, st1)


@pytest.mark.parametrize("name", MIXERS)
def test_masked_padding_is_inert(name):
    """Garbage past ``valid`` touches neither the state nor the valid
    rows' outputs, and a masked run's state is the truncated run's."""
    _, tfn, _, tp, st0 = _mixer(name, "sc_qat")
    n = 5
    x = _t(_x(6))
    x2 = x.clone()
    x2[:, n:] = _t(_x(7))[:, n:]
    valid = np.broadcast_to(np.arange(S) < n, (B, S)).copy()
    y1, st1 = tfn(tp, x, st0, valid)
    y2, st2 = tfn(tp, x2, st0, valid)
    _equal(st1, st2)
    assert torch.equal(y1[:, :n], y2[:, :n])
    _, st3 = tfn(tp, x[:, :n], st0)
    _equal(st1, st3)


@pytest.mark.parametrize("name", MIXERS)
def test_fully_masked_chunk_leaves_the_state(name):
    jfn, tfn, jp, tp, st0 = _mixer(name, "sc_qat")
    st_in = tfn(tp, _x(3), st0)[1]
    _, st_out = tfn(tp, _x(9), st_in, np.zeros((B, S), bool))
    _equal(st_in, st_out)


# ---------------------------------------------------------------------------
# the models on the paged cache
# ---------------------------------------------------------------------------

def _model_cfgs(arch, datapath="qat"):
    jc = jget_arch(arch).scaled(attn_q_chunk=8, **COMMON, **REDUCED[arch])
    c = get_arch(arch).scaled(**COMMON, **REDUCED[arch])
    if datapath != "qat":
        kw = dict(mode="sc_int", int_approx=datapath == "sc_int_approx")
        jc = jc.scaled(quant=dataclasses.replace(jc.quant, **kw))
        c = c.scaled(quant=dataclasses.replace(c.quant, **kw))
    return jc, c


def _live_ssm(jp):
    """The reference's parameters with mamba's ``conv_w`` at 10x its init
    draw, so that the SSM's inputs pass the activation quantizer (see the
    module docstring)."""
    periods = {name: dict(pp, mixer=dict(pp["mixer"],
                                         conv_w=pp["mixer"]["conv_w"] * 10))
               if "conv_w" in pp["mixer"] else pp
               for name, pp in jp["periods"].items()}
    return dict(jp, periods=periods)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jc, c = _model_cfgs(request.param)
    jp = _live_ssm(jinit_params(jax.random.key(0), jc))
    return request.param, jp, from_jax(_np(jp), c, device="cpu")


def test_from_jax_carries_the_recurrent_leaves(model):
    arch, jp, tp = model
    _, c = _model_cfgs(arch)
    assert len(tp["layers"]) == c.n_layers
    for i, lp in enumerate(tp["layers"]):
        j = i % len(c.period)
        jl = jax.tree.map(lambda a: np.asarray(a)[i // len(c.period)],
                          jp["periods"][f"p{j}"])
        flat_j = jax.tree_util.tree_flatten_with_path(jl)[0]
        assert len(flat_j) == len(jax.tree.leaves(
            jax.tree.map(lambda _: 0, {k: v for k, v in lp.items()})))
        for path, want in flat_j:
            got = lp
            for part in path:
                got = got[part.key]
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=str(path))
    if arch == "rwkv6-7b":
        mixer = tp["layers"][0]["mixer"]
        assert mixer["maa"].shape == (5, 64)
        assert mixer["tm_w2"].shape == (5, 32, 64)
        assert set(mixer["ln_x"]) == {"scale", "bias"}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_cache_have_the_reference_shapes(arch):
    jc, c = _model_cfgs(arch)
    jp = jinit_params(jax.random.key(0), jc)
    tp = init_params(c, torch.Generator().manual_seed(0), "cpu")
    for i, lp in enumerate(tp["layers"]):
        jl = jp["periods"][f"p{i % len(c.period)}"]
        want = jax.tree.map(lambda a: (a.shape[1:], str(a.dtype)), jl)
        got = jax.tree.map(lambda a: (tuple(a.shape),
                                      str(a.dtype).split(".")[-1]),
                           lp, is_leaf=lambda a: isinstance(a, torch.Tensor))
        assert got == want, i
    jcache = jtf.init_paged_cache(jc, 3, 9, 4, "int8")
    cache = init_paged_cache(c, 3, 9, 4, "int8", device="cpu")
    for i, e in enumerate(cache["layers"]):
        je = jcache["periods"][f"p{i % len(c.period)}"]
        want = jax.tree.map(lambda a: (a.shape[1:], str(a.dtype)), je)
        got = jax.tree.map(lambda a: (tuple(a.shape),
                                      str(a.dtype).split(".")[-1]),
                           e, is_leaf=lambda a: isinstance(a, torch.Tensor))
        assert got == want, i


def test_state_rows_gather_and_scatter():
    """Rows move by slot; the padded lanes' duplicate scratch index never
    reaches a live row."""
    _, c = _model_cfgs("jamba-1.5-large-398b")
    cache = init_paged_cache(c, 3, 5, 4, device="cpu")
    slots = torch.tensor([2, 0, 3, 3], dtype=torch.int32)   # 3 = scratch
    rows = gather_state_rows(cache, slots)
    assert rows[4] == {} and rows[0]["h"].shape[0] == 4
    new = [{k: torch.full_like(v, float(i + 1)) for k, v in r.items()}
           for i, r in enumerate(rows)]
    for r in new:
        if r:
            r["h"][1] = -1.0
    scatter_state_rows(cache, new, slots)
    e = cache["layers"][0]
    assert bool((e["h"][2] == 1).all()) and bool((e["h"][0] == -1).all())
    assert bool((e["h"][1] == 0).all())           # untouched live row
    assert bool((e["conv"][1] == 0).all())


def test_prefill_without_slot_ids_raises():
    _, c = _model_cfgs("rwkv6-7b")
    tp = init_params(c, torch.Generator().manual_seed(0), "cpu")
    cache = init_paged_cache(c, 1, 3, 4, device="cpu")
    with pytest.raises(ValueError, match="slot_ids"):
        paged_prefill(tp, cache, torch.zeros((1, 4), dtype=torch.int32),
                      torch.ones((1, 1), dtype=torch.int32),
                      torch.tensor([3], dtype=torch.int32), c, chunk=4)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_refuses_recurrent_layers(arch):
    """Named for the refusal it held while the training forward could not
    run a recurrent layer.  That forward now runs them (held against the
    reference in ``tests/test_torch_recurrent_train.py``); what it still
    refuses on these configs is a mode other than "train" or
    "prefill"."""
    _, c = _model_cfgs(arch)
    tp = init_params(c, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    for mode in ("decode", "paged_prefill"):
        with pytest.raises(ValueError, match="mode"):
            forward(tp, batch, c, mode=mode)


@pytest.mark.parametrize("datapath,fmt", PAIRS)
def test_paged_prefill_then_decode_logits_match(model, datapath, fmt):
    """Two prompts (5 and 8 tokens) prefilled in chunks of 4 into slots 1
    and 0 of a 3-slot cache, then one decode step continuing from the
    reference's own cache; logits and the state rows against the
    reference's."""
    arch, jp, tp = model
    jc, c = _model_cfgs(arch, datapath)
    tol = QAT_ATOL if datapath == "qat" else ATOL
    page, G, L, maxp = 4, 2, 8, 4
    n = G * maxp + 1
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 131, (G, L)).astype(np.int32)
    plens = np.array([5, 8], np.int32)
    tables = (1 + np.arange(G * maxp).reshape(G, maxp)).astype(np.int32)
    slots = np.array([1, 0], np.int32)
    prefill = jax.jit(jtf.paged_prefill, static_argnames=("cfg", "chunk"))
    decode = jax.jit(jtf.paged_decode_step, static_argnames=("cfg",))
    with jdispatch.backend_scope("reference"), \
            jdispatch.attn_backend_scope("reference"):
        jcache = jtf.init_paged_cache(jc, 3, n, page, fmt)
        jl, jcache = prefill(jp, jcache, toks, tables, plens, cfg=jc,
                             chunk=4, slot_ids=slots)
        nxt = np.asarray(jnp.argmax(jl[:, :131], -1)).astype(np.int32)
        jl2, jcache2 = decode(jp, jcache, nxt, slots, tables, plens,
                              cfg=jc)
    cache = init_paged_cache(c, 3, n, page, fmt, device="cpu")
    tl, cache = paged_prefill(tp, cache, _t(toks), _t(tables), _t(plens),
                              c, chunk=4, slot_ids=_t(slots))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=tol)
    want = cache_from_jax(_np(jcache), c, device="cpu")
    for e, we in zip(cache["layers"], want["layers"]):
        for k in ("h", "s", "conv", "shift"):
            if k in e:
                np.testing.assert_allclose(e[k].numpy(), we[k].numpy(),
                                           rtol=0, atol=tol, err_msg=k)
    # the decode step continues from the reference's own cache
    cache = cache_from_jax(_np(jcache), c, device="cpu")
    tl2, cache = paged_decode_step(tp, cache, _t(nxt), _t(slots),
                                   _t(tables), _t(plens), c)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=0,
                               atol=tol)
    want = cache_from_jax(_np(jcache2), c, device="cpu")
    for e, we in zip(cache["layers"], want["layers"]):
        for k in ("h", "s", "conv", "shift"):
            if k in e:
                np.testing.assert_allclose(e[k].numpy(), we[k].numpy(),
                                           rtol=0, atol=tol, err_msg=k)

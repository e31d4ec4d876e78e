"""The vision and audio front ends against the JAX reference:
llava-next-34b (a vision stub: patch embeddings through two projections
ahead of the text, causal GQA) and hubert-xlarge (an audio stub: frames
through one projection, a bidirectional encoder, LayerNorm, ungated gelu,
no RoPE), at the reference's ``REDUCED`` sizes
(``tests/test_models_smoke.py``), float32, parameters carried over by
``weights.from_jax`` (the ``frontend`` leaves included), inputs made
with numpy from a seed.  Tolerances:

* the training forward's logits, the dense prefill's logits and cache
  and the decode steps' logits: ``1e-5`` of the largest entry (at least
  1) without quantization and under sc_int, ``5e-5`` under sc_qat (the
  fake-quant lattice passes a one-ulp difference on as a whole level now
  and then, as ``tests/test_torch_dense_cache.py`` holds the decoders);
* loss within 1e-5 (5e-5 under sc_qat) and each gradient leaf within the
  same fraction of its largest entry, against ``jax.value_and_grad``,
  but for the LSQ and residual scales under sc_qat: 2e-4 (``LSQ_SCALE_TOL``,
  the LSQ gradient's jumps at the clip rails, ROADMAP Queue 3 item 7);
  one train step's metrics within 2e-5 relative, its params within 2e-5
  and AdamW's m / v as ``tests/test_torch_train.py`` holds granite's;
* the launcher's stub batches: the patch embeddings and frames within
  1e-6 (``prng.normal``'s erfinv is XLA's polynomial, not its bits).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_fixtures import _one_torch_thread, _partitionable  # noqa: F401
from repro.configs import get_arch as jget_arch
from repro.configs import llava_next_34b as jllava
from repro.launch.train import reduced_config as jreduced_config
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import transformer as jtf
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.serving import ServeEngine as JServeEngine
from repro.serving.engine import _pad_prefill_cache as _jpad_prefill_cache
from repro.train import build_train_step as jbuild_train_step
from repro.train import init_train_state as jinit_train_state
from repro_torch.configs import get_arch
from repro_torch.configs import llava_next_34b
from repro_torch.data import SyntheticLM
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import reduced_config, train_batch
from repro_torch.models import (batch_specs, decode_step, forward,
                                init_cache, init_paged_cache, init_params,
                                loss_fn, make_dummy_batch, paged_decode_step,
                                paged_prefill, paged_verify_step, prefill,
                                supports_paged_prefill)
from repro_torch.optim import warmup_cosine
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import _pad_prefill_cache
from repro_torch.train import build_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_paths
from repro_torch.weights import dense_cache_from_jax, from_jax

LLAVA, HUBERT = "llava-next-34b", "hubert-xlarge"
ARCHS = [LLAVA, HUBERT]
COMMON = dict(dtype="float32", vocab_pad_multiple=32)
# tests/test_models_smoke.py
REDUCED = {
    LLAVA: dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
                vocab_size=131),
    HUBERT: dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                 vocab_size=67),
}
TOL = {"none": 1e-5, "sc_int": 1e-5, "sc_qat": 5e-5}
# the gradient of an LSQ or residual scale (an ``alpha_*`` leaf) under
# sc_qat: the LSQ gradient jumps at the clip rails, so a one-ulp difference
# in one quantizer input moves a term of the scale's sum by qp x g (ROADMAP
# Queue 3 item 7); on these inputs llava's reach 7.2e-5 of the largest
LSQ_SCALE_TOL = 2e-4
B, S, N_IMG = 2, 16, 4          # llava: 4 image rows, then 12 text tokens


def _cfgs(arch, mode="sc_qat"):
    jc = jget_arch(arch).scaled(attn_q_chunk=8, attn_kv_chunk=8, **COMMON,
                                **REDUCED[arch])
    c = get_arch(arch).scaled(**COMMON, **REDUCED[arch])
    return (jc.scaled(quant=jc.quant.with_mode(mode)),
            c.scaled(quant=c.quant.with_mode(mode)))


@functools.lru_cache(maxsize=None)
def _jparams(arch, mode="sc_qat", seed=0):
    """The reference's parameters (jitted init, cached: tests share them)."""
    jc, _ = _cfgs(arch, mode)
    return jax.jit(jinit_params, static_argnums=1)(jax.random.key(seed), jc)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol, msg=""):
    """|got - want| <= tol * max(1, max |want|)."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= tol, (msg, err)


def _batch(arch, seed=0, train=False):
    """Numpy inputs of S positions: llava's N_IMG patch embeddings and S -
    N_IMG tokens, hubert's S frames; with ``train`` the targets and the
    launcher's loss mask (text positions only for llava)."""
    rng = np.random.default_rng(seed)
    c = REDUCED[arch]
    if arch == LLAVA:
        b = {"patch_embeds": (0.02 * rng.standard_normal((B, N_IMG, 1024)))
             .astype(np.float32),
             "tokens": rng.integers(0, c["vocab_size"], (B, S - N_IMG))
             .astype(np.int32)}
        mask = np.concatenate([np.zeros((B, N_IMG)), np.ones((B, S - N_IMG))],
                              1)
    else:
        b = {"frames": (0.1 * rng.standard_normal((B, S, 512)))
             .astype(np.float32)}
        mask = np.ones((B, S))
    if train:
        b["targets"] = rng.integers(0, c["vocab_size"], (B, S)) \
            .astype(np.int32)
        b["loss_mask"] = mask.astype(np.float32)
    return b


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: _t(v) for k, v in b.items()}


@pytest.fixture(scope="module", params=ARCHS)
def arch_params(request):
    _, c = _cfgs(request.param)
    jp = _jparams(request.param)
    return request.param, jp, from_jax(_np(jp), c, device="cpu")


# ---------------------------------------------------------------------------
# configs, parameters, batches
# ---------------------------------------------------------------------------

def test_configs_carry_the_reference_fields():
    fields = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "head_dim", "norm", "ffn_act", "ffn_gated",
              "rope_theta", "rope_fraction", "causal", "is_encoder",
              "frontend", "padded_vocab", "tie_embeddings", "logit_softcap")
    for arch in ARCHS:
        want, got = jget_arch(arch), get_arch(arch)
        for f in fields:
            assert getattr(got, f) == getattr(want, f), (arch, f)
    assert llava_next_34b.IMG_TOKENS == jllava.IMG_TOKENS == 2880
    assert get_arch(HUBERT).head_dim == 80
    assert get_arch(LLAVA).n_heads // get_arch(LLAVA).n_kv_heads == 7
    for arch in ARCHS + ["granite-3-2b", "jamba-1.5-large-398b"]:
        assert supports_paged_prefill(get_arch(arch)) == \
            jtf.supports_paged_prefill(jget_arch(arch)), arch


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor,seq", [(8, 256), (32, 16)])
def test_reduced_config_matches_the_reference(arch, factor, seq):
    want = jreduced_config(jget_arch(arch), factor, seq)
    got = reduced_config(get_arch(arch), factor, seq)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "head_dim", "frontend", "causal"):
        assert getattr(got, f) == getattr(want, f), (arch, f)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_frontend_shapes(arch):
    _, c = _cfgs(arch)
    jp = _jparams(arch)
    tp = init_params(c, torch.Generator().manual_seed(3), "cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp["frontend"])
    got = tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                   tp["frontend"])
    assert got == want
    # from_jax carries the frontend leaves exactly
    carried = from_jax(_np(jp), c, device="cpu")["frontend"]
    for name, leaf in jp["frontend"].items():
        for k, v in leaf.items():
            np.testing.assert_array_equal(carried[name][k].numpy(),
                                          np.asarray(v))


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS + ["granite-3-2b"])
def test_batch_specs_and_dummy_batch_match_the_reference(arch, kind):
    jc, c = get_arch(arch), jget_arch(arch)
    assert batch_specs(jc, kind) == jtf.batch_specs(c, kind)
    want = jtf.make_dummy_batch(c, 2, 32, kind)
    got = make_dummy_batch(jc, 2, 32, kind, device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(v, np.float32))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "sc_qat"])
def test_forward_logits_match_reference(arch_params, mode):
    arch, jp, tp = arch_params
    jc, c = _cfgs(arch, mode)
    b = _batch(arch, 1)
    want, _, _ = jax.jit(jtf.forward, static_argnums=2)(jp, _jbatch(b), jc)
    with torch.no_grad():
        got, aux = forward(tp, _tbatch(b), c)
    assert got.shape == (B, S, c.padded_vocab)
    _close(got.numpy(), want, TOL[mode])
    assert float(aux) == 0.0


def test_hubert_attends_both_ways():
    """Changing the last frame changes frame 0's logits (bidirectional),
    in both packages; llava's first text logits ignore later tokens."""
    _, c = _cfgs(HUBERT, "none")
    tp = from_jax(_np(_jparams(HUBERT, "none")), c, device="cpu")
    b = _tbatch(_batch(HUBERT, 2))
    with torch.no_grad():
        a, _ = forward(tp, b, c)
        b["frames"][:, -1] += 1.0
        z, _ = forward(tp, b, c)
    assert float((a[:, 0] - z[:, 0]).abs().max()) > 1e-4
    _, c = _cfgs(LLAVA, "none")
    tp = from_jax(_np(_jparams(LLAVA, "none")), c, device="cpu")
    b = _tbatch(_batch(LLAVA, 2))
    with torch.no_grad():
        a, _ = forward(tp, b, c)
        b["tokens"][:, -1] = (b["tokens"][:, -1] + 1) % 131
        z, _ = forward(tp, b, c)
    torch.testing.assert_close(a[:, :-1], z[:, :-1], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["none", "sc_int", "sc_qat"])
def test_llava_prefill_and_decode_match_reference(mode):
    """The dense ``prefill`` of image rows + text: logits and every cache
    entry against the reference's (``pos`` counts both); then two
    ``decode_step``s from the reference's own cache."""
    jc, c = _cfgs(LLAVA, mode)
    jp = _jparams(LLAVA, mode)
    tp = from_jax(_np(jp), c, device="cpu")
    b = _batch(LLAVA, 3)
    tol = TOL[mode]
    jl, jcache = jax.jit(jtf.prefill, static_argnums=2)(jp, _jbatch(b), jc)
    with torch.no_grad():
        tl, cache = prefill(tp, _tbatch(b), c)
    _close(tl.numpy(), jl, tol)
    want = dense_cache_from_jax(_np(jcache), c, device="cpu")
    assert int(cache["pos"]) == int(want["pos"]) == S
    for i, (e, we) in enumerate(zip(cache["layers"], want["layers"])):
        for k in ("k", "v"):
            _close(e[k].numpy(), we[k].numpy(), tol, (i, k))
    jcache = _jpad_prefill_cache(jcache, S + 4)
    cache = dense_cache_from_jax(_np(jcache), c, device="cpu")
    nxt = np.random.default_rng(4).integers(0, 131, (B, 2)).astype(np.int32)
    jdecode = jax.jit(jtf.decode_step, static_argnums=3)
    for t in range(2):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(nxt[:, t:t + 1]), jc)
        with torch.no_grad():
            tl, cache = decode_step(tp, cache, _t(nxt[:, t:t + 1]), c)
        _close(tl.numpy(), jl, tol, t)
        cache = dense_cache_from_jax(_np(jcache), c, device="cpu")
    assert int(cache["pos"]) == S + 2


def test_llava_decode_continues_the_forward():
    """Teacher-forced forward logits == prefill of the image and the first
    text tokens + one decode_step a token of the rest (port only)."""
    _, c = _cfgs(LLAVA, "none")
    tp = init_params(c, torch.Generator().manual_seed(5), "cpu")
    b = _tbatch(_batch(LLAVA, 5))
    with torch.no_grad():
        ref, _ = forward(tp, b, c)
        n = 6
        logits, cache = prefill(tp, {"patch_embeds": b["patch_embeds"],
                                     "tokens": b["tokens"][:, :n]}, c)
        cache = _pad_prefill_cache(cache, S)
        torch.testing.assert_close(logits[:, -1], ref[:, N_IMG + n - 1],
                                   rtol=1e-5, atol=1e-5)
        for i in range(n, S - N_IMG):
            logits, cache = decode_step(tp, cache, b["tokens"][:, i:i + 1],
                                        c)
            torch.testing.assert_close(logits[:, 0], ref[:, N_IMG + i],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["none", "sc_qat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, mode):
    """``loss_fn`` with the launcher's loss mask and every gradient leaf
    (the front end's projections and their LSQ scales included) against
    ``jax.value_and_grad(repro.models.loss_fn)``."""
    jc, c = _cfgs(arch, mode)
    jp = _jparams(arch, mode)
    b = _batch(arch, 6, train=True)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, _jbatch(b), jc), has_aux=True))(jp)
    tp = from_jax(_np(jp), c, device="cpu")
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(tp, _tbatch(b), c)
    # hubert's token table is never read: a zero gradient, as jax.grad's
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    tol = TOL[mode]
    assert abs(float(loss.detach()) - float(jl)) <= tol
    assert abs(float(metrics["ce"].detach()) - float(jm["ce"])) <= tol
    for g, (path, w) in zip(grads, tree_paths(from_jax(_np(jg), c,
                                                       device="cpu"))):
        err = float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
        lsq = path.rsplit("/", 1)[-1].startswith("alpha_")
        assert err <= (LSQ_SCALE_TOL if lsq else tol), (path, err)
        if arch == HUBERT and path == "embed/table":
            assert not bool(g.any())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One ``build_train_step`` step under sc_qat from the reference's
    initial state: metrics, params and the AdamW state leaf by leaf."""
    jc, c = _cfgs(arch)
    lr = lambda s: jwarmup_cosine(s + 1, 1e-3, 2, 10)      # noqa: E731
    jstate = jinit_train_state(_jparams(arch), jc)
    state = from_jax(_np(jstate), c, device="cpu")
    b = _batch(arch, 8, train=True)
    jstate, jm = jax.jit(jbuild_train_step(jc, lr))(jstate, _jbatch(b))
    state, m = build_train_step(c, lambda s: warmup_cosine(
        s + 1, 1e-3, 2, 10))(state, _tbatch(b))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-5)
    want = from_jax(_np(jstate), c, device="cpu")
    assert "frontend" in state.opt["m"]
    for a, w in zip(tree_leaves(state.params), tree_leaves(want.params)):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0, atol=2e-5)
    for key, tol in (("m", TOL["sc_qat"]), ("v", 2 * TOL["sc_qat"])):
        for a, w in zip(tree_leaves(state.opt[key]),
                        tree_leaves(want.opt[key])):
            err = float((a - w).abs().max() / w.abs().max().clamp(min=1e-30))
            assert err <= tol, (key, err)


# ---------------------------------------------------------------------------
# what neither package serves
# ---------------------------------------------------------------------------

def test_encoder_refusals_in_both_packages():
    jc, c = _cfgs(HUBERT)
    jp = _jparams(HUBERT)
    tp = from_jax(_np(jp), c, device="cpu")
    tok = jnp.zeros((2, 1), jnp.int32)
    with pytest.raises(AssertionError, match="no decode step"):
        jtf.decode_step(jp, jtf.init_cache(jc, 2, 8), tok, jc)
    jpc = jtf.init_paged_cache(jc, 2, 4, 4)
    one = jnp.zeros((2,), jnp.int32)
    with pytest.raises(AssertionError, match="no decode step"):
        jtf.paged_decode_step(jp, jpc, one, one, jnp.zeros((2, 1), jnp.int32),
                              one, jc)
    with pytest.raises(AssertionError, match="no decode step"):
        jtf.paged_verify_step(jp, jpc, jnp.zeros((2, 2), jnp.int32), one,
                              jnp.zeros((2, 1), jnp.int32), one, jc)
    with pytest.raises(AssertionError, match="served via forward"):
        JServeEngine(jp, jc, max_slots=2, max_len=16, page_size=4)
    t1 = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="no decode step"):
        init_cache(c, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="no decode step"):
        init_paged_cache(c, 2, 4, 4, device="cpu")
    cache = {"pos": torch.zeros((), dtype=torch.int32), "layers": []}
    with pytest.raises(ValueError, match="no decode step"):
        decode_step(tp, cache, torch.zeros((2, 1), dtype=torch.int32), c)
    with pytest.raises(ValueError, match="no decode step"):
        paged_decode_step(tp, {"layers": []}, t1, t1,
                          torch.zeros((2, 1), dtype=torch.int32), t1, c)
    with pytest.raises(ValueError, match="no decode step"):
        paged_verify_step(tp, {"layers": []}, torch.zeros((2, 2),
                                                          dtype=torch.int32),
                          t1, torch.zeros((2, 1), dtype=torch.int32), t1, c)
    with pytest.raises(ValueError, match="no paged prefill"):
        paged_prefill(tp, {"layers": []}, torch.zeros((2, 4),
                                                      dtype=torch.int32),
                      torch.zeros((2, 1), dtype=torch.int32), t1, c, chunk=4)
    with pytest.raises(ValueError, match="encoder"):
        ServeEngine(tp, c, max_slots=2, max_len=16, page_size=4,
                    device="cpu")


def test_the_engine_refuses_a_vision_stub_arch():
    """The reference builds a llava engine, but its prefill passes tokens
    only and fails on the missing patch embeddings; the port refuses at
    construction and serves llava through prefill / decode_step."""
    jc, c = _cfgs(LLAVA)
    jp = _jparams(LLAVA)
    jeng = JServeEngine(jp, jc, max_slots=2, max_len=16, page_size=4)
    jeng.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(Exception):
        jeng.run_to_completion()
    tp = from_jax(_np(jp), c, device="cpu")
    with pytest.raises(ValueError, match="not token prompts"):
        ServeEngine(tp, c, max_slots=2, max_len=16, page_size=4,
                    device="cpu")
    with pytest.raises(ValueError, match="no paged prefill"):
        paged_prefill(tp, {"layers": []}, torch.zeros((2, 4),
                                                      dtype=torch.int32),
                      torch.zeros((2, 1), dtype=torch.int32),
                      torch.zeros((2,), dtype=torch.int32), c, chunk=4)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _reference_batch(cfg, step, batch, seq):
    """The reference launcher's ``batch_fn`` (``repro/launch/train.py``),
    written out: its stub inputs from ``jax.random.normal``."""
    from repro.data import SyntheticLM as JSyntheticLM
    b = JSyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                     seed=0).batch(step, batch)
    d = jtf.make_dummy_batch(cfg, batch, seq, "train")
    d["targets"] = jnp.clip(b["targets"], 0, cfg.vocab_size - 1)
    if cfg.frontend == "vision_stub":
        n_img = d["patch_embeds"].shape[1]
        d["patch_embeds"] = 0.02 * jax.random.normal(
            jax.random.fold_in(jax.random.key(7), step),
            d["patch_embeds"].shape, jnp.float32)
        d["tokens"] = b["tokens"][:, :seq - n_img]
        d["loss_mask"] = jnp.concatenate(
            [jnp.zeros((batch, n_img), jnp.float32),
             jnp.ones((batch, seq - n_img), jnp.float32)], 1)
    else:
        d["frames"] = 0.1 * jax.random.normal(
            jax.random.fold_in(jax.random.key(8), step), d["frames"].shape,
            jnp.float32)
    return d


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("step", [0, 3])
def test_launcher_stub_batches_equal_the_reference(arch, step):
    jc, c = _cfgs(arch)
    want = _reference_batch(jc, step, 2, 32)
    got = train_batch(c, SyntheticLM(c.vocab_size, 32, seed=0), step, 2, 32)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        if k in ("patch_embeds", "frames"):
            np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_on_cpu(arch, capsys):
    _, hist = train_main(["--arch", arch, "--reduce", "32", "--steps", "2",
                          "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert f"[train] {arch}" in capsys.readouterr().out

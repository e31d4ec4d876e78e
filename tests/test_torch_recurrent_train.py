"""Training the recurrent mixers in the port against the JAX reference:
mamba's chunked associative scan (``mamba_train``, ``_conv_full``),
rwkv6's training time mix and channel mix with the token or the chunked
wkv (``rwkv_tmix_train``, ``rwkv_cmix_train``, ``_wkv_chunked``), and
tiny rwkv6-7b / jamba-1.5-large-398b through ``loss_fn``, one
``build_train_step`` step and the ``launch.train`` CLI.

Sizes are the reference's own: ``MIXER_SCALE`` of
``tests/test_torch_recurrent.py`` for the mixers (its zero-initialised
leaves perturbed), ``REDUCED`` of ``tests/test_models_smoke.py`` for the
models (mamba's ``conv_w`` at 10x the reference's draw, as the serving
tests: at the reference's scale the SSM's inputs all round to activation
level 0 under sc_qat and its gradients are float noise around zero).
Inputs come from numpy seeds; gradients from ``jax.vjp`` /
``jax.value_and_grad`` against ``torch.autograd``.  Tolerances, float32:

* mixer outputs, final states and every gradient leaf: ``1e-5`` with
  quantization off and ``5e-5`` under sc_qat (as ``tests/
  test_torch_train.py``), absolute for outputs and states, relative to
  the leaf's largest entry for gradients; under sc_qat the scalar LSQ
  scales' gradients within ``1e-3`` relative: each is one sum over every
  activation of its layer whose terms cancel to ~1e-3 of their
  magnitudes, so the float32 rounding of the incoming gradients (1e-6
  relative) reaches 2-5e-4 of the sum, with the forward bit-equal;
* the conv tail (a gathered input row) and ``_conv_full`` against
  ``_conv_window`` with a zero tail: bit for bit;
* the associative scan against ``jax.lax.associative_scan``: ``1e-6``
  relative (the same product tree; XLA may fuse a multiply-add);
* ``_wkv_chunked`` against the reference's: ``1e-5`` of the largest
  entry, and its gradient there with respect to the log-decay ``log w``
  (``w * dL/dw``: at a decay of 1e-11 the gradient with respect to ``w``
  itself is ``1 / w`` times a float32 cancellation, in the reference as
  in the port); against ``_wkv_scan``: the reference's
  ``tests/test_rwkv_chunked.py`` tolerances (1e-4; under extreme decay
  rtol 1e-3, atol 5e-4);
* models: loss within the mode's tolerance; gradients and AdamW's ``m``
  within ``5e-5`` of each leaf's largest entry with quantization off
  (mamba's ``a_log`` / ``dt`` gradients sum over every (token, channel,
  state) of eight layers: 2.3e-5 measured) and ``2e-4`` under sc_qat (the
  LSQ scales, as ``tests/test_torch_moe.py``'s train step); jamba's
  bfloat16 ``m`` within one bfloat16 ulp of the leaf's largest entry
  (2**-8); one AdamW step's parameters within ``2e-5``, as
  ``tests/test_torch_train.py``, except where the reference's gradient is
  below 1e-6: the first step is ``lr * g / (|g| + eps)``, and there the
  gradient's float32 rounding (2.3e-5 of the leaf's largest entry on
  jamba's SSM leaves) moves the step anywhere in ``[-lr, lr]``, so those
  entries are held within ``2 lr`` (1.0e-4 off on one of jamba's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch.train import reduced_config as jreduced_config
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import mamba as jmamba
from repro.models import rwkv6 as jrwkv6
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train import build_train_step as jbuild_train_step
from repro.train import init_train_state as jinit_train_state
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_arch
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import reduced_config
from repro_torch.models import forward, init_params, loss_fn, mamba, rwkv6
from repro_torch.optim import warmup_cosine
from repro_torch.train import build_train_step
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import from_jax, tree_to_torch
from port_fixtures import _one_torch_thread  # noqa: F401

TOL = {"none": 1e-5, "sc_qat": 5e-5}
LSQ_SCALE_TOL = 1e-3
MODEL_GRAD_TOL = {"none": 5e-5, "sc_qat": 2e-4}
ARCHS = ("rwkv6-7b", "jamba-1.5-large-398b")
# tests/test_recurrent_prefill.py, as tests/test_torch_recurrent.py
MIXER_SCALE = {
    "jamba-1.5-large-398b": dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=64, vocab_pad_multiple=32, dtype="float32",
        mamba_d_state=8),
    "rwkv6-7b": dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=64, vocab_pad_multiple=32, dtype="float32",
        rwkv_head_dim=16)}
# tests/test_models_smoke.py (REDUCED, COMMON)
REDUCED = {
    "rwkv6-7b": dict(n_layers=2, d_model=64, d_ff=128, vocab_size=131,
                     n_heads=4, n_kv_heads=4, rwkv_head_dim=16),
    "jamba-1.5-large-398b": dict(n_layers=8, d_model=64, n_heads=4,
                                 n_kv_heads=2, d_ff=96, vocab_size=131,
                                 n_experts=4, n_experts_per_tok=2,
                                 mamba_d_state=8, moe_group_size=16,
                                 moe_capacity_factor=2.0)}
COMMON = dict(dtype="float32", mamba_chunk=8, vocab_pad_multiple=32)
B, S = 2, 13
_ZERO_INIT = ("maa_x", "maa", "u", "mk", "mr", "conv_b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _mode(cfg, mode):
    return cfg.scaled(quant=cfg.quant.with_mode(mode))


def _x(seed, n=S, d=64):
    return np.random.default_rng(seed).standard_normal((B, n, d)) \
        .astype(np.float32)


def _rel(got, want):
    w = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - w).max()
                 / max(np.abs(w).max(), 1e-30))


# ---------------------------------------------------------------------------
# the mixers' training forms, outputs and gradients
# ---------------------------------------------------------------------------

def _mixer(name, mode, **kw):
    """(jax fn, port fn, reference params, port params, cfgs); each fn is
    ``fn(p, x) -> (out, carry)`` of the mixer's training form."""
    arch = "jamba-1.5-large-398b" if name == "mamba" else "rwkv6-7b"
    jc = _mode(jget_arch(arch).scaled(**MIXER_SCALE[arch], **kw), mode)
    c = _mode(get_arch(arch).scaled(**MIXER_SCALE[arch], **kw), mode)
    if name == "mamba":
        from repro.configs import LayerSpec as JLayerSpec
        from repro_torch.configs import LayerSpec
        jc = jc.scaled(period=(JLayerSpec("mamba", "dense"),))
        c = c.scaled(period=(LayerSpec("mamba", "dense"),))
    key = jax.random.key(7)
    rng = np.random.default_rng(11)
    init, jfn, tfn = {
        "mamba": (jmamba.mamba_init, jmamba.mamba_train, mamba.mamba_train),
        "rwkv_tmix": (jrwkv6.rwkv_tmix_init, jrwkv6.rwkv_tmix_train,
                      rwkv6.rwkv_tmix_train),
        "rwkv_cmix": (jrwkv6.rwkv_cmix_init, jrwkv6.rwkv_cmix_train,
                      rwkv6.rwkv_cmix_train)}[name]
    jp = {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)
                          * 0.3) if k in _ZERO_INIT else v)
          for k, v in init(key, jc).items()}
    if name == "mamba":
        jp["conv_w"] = jp["conv_w"] * 10
    return (lambda p, x: jfn(p, x, jc), lambda p, x: tfn(p, x, c), jp,
            tree_to_torch(_np(jp), "cpu"))


def _port_vjp(fn, tp, x, g):
    """(out, carry, grads of (params, x)) of ``sum(out * g)``."""
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    out, carry = fn(tp, xt)
    grads = torch.autograd.grad((out * _t(g)).sum(), leaves + [xt],
                                allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    it = iter(grads[:-1])
    return (out.detach(), tree_map(lambda a: a.detach(), carry),
            tree_map(lambda _: next(it), tp), grads[-1])


def _held(name, mode, x, **kw):
    """Run the mixer's training form forward and backward on both sides
    and hold outputs, carry and gradients within the mode's tolerance."""
    jfn, tfn, jp, tp = _mixer(name, mode, **kw)
    (jout, jcarry), vjp = jax.vjp(jfn, jp, jnp.asarray(x))
    g = np.random.default_rng(5).standard_normal(jout.shape) \
        .astype(np.float32)
    jcarry_ct = jax.tree.map(jnp.zeros_like, jcarry)
    jgp, jgx = vjp((jnp.asarray(g), jcarry_ct))
    out, carry, gp, gx = _port_vjp(tfn, tp, x, g)
    tol = TOL[mode]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=tol)
    for got, want in zip(jax.tree.leaves(carry), jax.tree.leaves(jcarry)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=tol)
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(_np(jgp))[0],
            tree_leaves(gp)):
        got = np.zeros_like(want) if got is None else got.numpy()
        lsq = mode == "sc_qat" and path[-1].key.startswith("alpha")
        assert _rel(got, want) <= (LSQ_SCALE_TOL if lsq else tol), \
            (path, _rel(got, want))
    assert _rel(gx.numpy(), jgx) <= tol
    return carry, jcarry


@pytest.mark.parametrize("mode", ["none", "sc_qat"])
@pytest.mark.parametrize("chunk,n", [(64, S), (4, S), (5, 16), (8, 1)])
def test_mamba_train_matches_reference(mode, chunk, n):
    """Chunks of 13 (one), 1 (S prime), 5 and a one-token sequence; the
    conv tail (the last k - 1 pre-conv inputs, zero-padded) bit for bit."""
    carry, jcarry = _held("mamba", mode, _x(1, n), mamba_chunk=chunk)
    np.testing.assert_array_equal(carry[1].numpy(), np.asarray(jcarry[1]))


@pytest.mark.parametrize("mode", ["none", "sc_qat"])
@pytest.mark.parametrize("impl,chunk", [("scan", 32), ("chunked", 4),
                                        ("chunked", 32)])
def test_rwkv_tmix_train_matches_reference(mode, impl, chunk):
    carry, jcarry = _held("rwkv_tmix", mode, _x(2), rwkv_wkv_impl=impl,
                          rwkv_chunk=chunk)
    np.testing.assert_array_equal(carry[1].numpy(), np.asarray(jcarry[1]))


@pytest.mark.parametrize("mode", ["none", "sc_qat"])
def test_rwkv_cmix_train_matches_reference(mode):
    carry, jcarry = _held("rwkv_cmix", mode, _x(3))
    np.testing.assert_array_equal(carry.numpy(), np.asarray(jcarry))


@pytest.mark.parametrize("n,k", [(1, 4), (2, 4), (3, 4), (13, 4), (13, 2)])
def test_conv_full_is_conv_window_with_a_zero_tail(n, k):
    """``_conv_window``'s docstring promise: the serving conv over a zero
    tail gives the training conv's output bit for bit."""
    cfg = get_arch("jamba-1.5-large-398b").scaled(mamba_d_conv=k)
    rng = np.random.default_rng(n + k)
    p = {"conv_w": _t(rng.standard_normal((64, k)).astype(np.float32)),
         "conv_b": _t(rng.standard_normal(64).astype(np.float32))}
    x = _t(_x(4, n))
    xcat = torch.cat([torch.zeros((B, k - 1, 64)), x], dim=1)
    assert torch.equal(mamba._conv_full(p, x, cfg),
                       mamba._conv_window(p, xcat, cfg))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 64])
def test_assoc_scan_follows_jax(n):
    """The odd / even recursion gives jax.lax.associative_scan's result
    for every length parity, and equals a sequential scan within float32
    rounding."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3)).astype(np.float32)
    b = rng.standard_normal((2, n, 3)).astype(np.float32)
    want = jax.lax.associative_scan(jmamba._assoc_combine,
                                    (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = mamba._assoc_scan((_t(a), _t(b)), 1)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-6
    h = np.zeros((2, 3), np.float32)
    for t in range(n):
        h = h * a[:, t] + b[:, t]
    np.testing.assert_allclose(got[1][:, -1].numpy(), h, rtol=1e-5,
                               atol=1e-6)


def _wkv_inputs(seed, w_strength=1.0, Bw=2, Sw=64, H=2, D=8):
    """tests/test_rwkv_chunked.py's inputs, drawn by jax.random there."""
    ks = jax.random.split(jax.random.key(seed), 5)
    r = jax.random.normal(ks[0], (Bw, Sw, H, D))
    k = jax.random.normal(ks[1], (Bw, Sw, H, D))
    v = jax.random.normal(ks[2], (Bw, Sw, H, D))
    w = jnp.exp(-jnp.exp(jax.random.normal(ks[3], (Bw, Sw, H, D))
                         * w_strength))
    u = jax.random.normal(ks[4], (H, D)) * 0.3
    return r, k, v, w, u


@pytest.mark.parametrize("seed,chunk", [(0, 8), (1, 16), (2, 32), (3, 64),
                                        (4, 5)])
def test_wkv_chunked_matches_reference_and_scan(seed, chunk):
    """Against the reference's ``_wkv_chunked`` (1e-5 of the largest
    entry) and against the port's token scan (the reference's 1e-4),
    from zero state."""
    r, k, v, w, u = _wkv_inputs(seed)
    s0 = jnp.zeros((2, 2, 8, 8), jnp.float32)
    jy, js = jrwkv6._wkv_chunked(r, k, v, w, u, s0, chunk)
    args = [_t(a) for a in (r, k, v, w, u, s0)]
    y, s = rwkv6._wkv_chunked(*args, chunk)
    assert _rel(y.numpy(), jy) <= 1e-5 and _rel(s.numpy(), js) <= 1e-5
    y1, s1 = rwkv6._wkv_scan(*args)
    np.testing.assert_allclose(y.numpy(), y1.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), s1.numpy(), rtol=1e-4, atol=1e-4)


def test_wkv_chunked_stable_under_extreme_decay():
    r, k, v, w, u = _wkv_inputs(7, w_strength=3.0)
    w = jnp.minimum(w, 0.01)                 # near-total forgetting
    args = [_t(a) for a in (r, k, v, w, u)] + [torch.zeros((2, 2, 8, 8))]
    y2, s2 = rwkv6._wkv_chunked(*args, 32)
    assert bool(torch.isfinite(y2).all()) and bool(torch.isfinite(s2).all())
    y1, _ = rwkv6._wkv_scan(*args)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-3, atol=5e-4)


def test_wkv_chunked_with_nonzero_initial_state():
    r, k, v, w, u = _wkv_inputs(3)
    s0 = jax.random.normal(jax.random.key(9), (2, 2, 8, 8)).astype(
        jnp.float32)
    args = [_t(a) for a in (r, k, v, w, u, s0)]
    y1, s1 = rwkv6._wkv_scan(*args)
    y2, s2 = rwkv6._wkv_chunked(*args, 16)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=1e-4, atol=1e-4)
    jy, js = jrwkv6._wkv_chunked(r, k, v, w, u, s0, 16)
    assert _rel(y2.numpy(), jy) <= 1e-5 and _rel(s2.numpy(), js) <= 1e-5


def test_wkv_chunked_gradients_match_jax():
    """Gradients of r, k, v, u and the initial state, and of the
    log-decay (``w * dL/dw``; module docstring), within 1e-5."""
    r, k, v, w, u = _wkv_inputs(5, Sw=24)
    s0 = jax.random.normal(jax.random.key(1), (2, 2, 8, 8)) * 0.1
    g = jax.random.normal(jax.random.key(2), r.shape)
    jgrads = list(jax.grad(lambda *a: jnp.sum(
        jrwkv6._wkv_chunked(*a, 8)[0] * g), argnums=range(6))(
            r, k, v, w, u, s0))
    args = [_t(a).requires_grad_() for a in (r, k, v, w, u, s0)]
    y, _ = rwkv6._wkv_chunked(*args, 8)
    grads = list(torch.autograd.grad((y * _t(g)).sum(), args))
    grads[3] = grads[3] * args[3].detach()
    jgrads[3] = jgrads[3] * w
    for got, want in zip(grads, jgrads):
        assert _rel(got.numpy(), want) <= 1e-5


def test_wkv_scan_without_valid_equals_the_all_true_mask():
    """Leaving out the select of an all-true mask changes no bit."""
    r, k, v, w, u = (_t(a) for a in _wkv_inputs(6, Sw=12))
    s0 = torch.randn((2, 2, 8, 8), generator=torch.Generator().manual_seed(0))
    y1, s1 = rwkv6._wkv_scan(r, k, v, w, u, s0)
    y2, s2 = rwkv6._wkv_scan(r, k, v, w, u, s0,
                             torch.ones((2, 12), dtype=torch.bool))
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


# ---------------------------------------------------------------------------
# the models: loss, gradients, a train step, the CLI
# ---------------------------------------------------------------------------

def _model_cfgs(arch, mode="sc_qat", **kw):
    jc = jget_arch(arch).scaled(attn_q_chunk=8, **COMMON, **REDUCED[arch],
                                **kw)
    c = get_arch(arch).scaled(**COMMON, **REDUCED[arch], **kw)
    return _mode(jc, mode), _mode(c, mode)


def _live_ssm(jp):
    """mamba's ``conv_w`` at 10x the reference's draw (module docstring)."""
    periods = {name: dict(pp, mixer=dict(pp["mixer"],
                                         conv_w=pp["mixer"]["conv_w"] * 10))
               if "conv_w" in pp["mixer"] else pp
               for name, pp in jp["periods"].items()}
    return dict(jp, periods=periods)


def _batch(seed=1, Bb=2, Sb=16):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 131, (Bb, Sb + 1)).astype(np.int32)
    return {"tokens": seq[:, :-1], "targets": seq[:, 1:],
            "loss_mask": np.ones((Bb, Sb), np.float32)}


def _port_grads(params, batch, cfg):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(params, {k: _t(v) for k, v in batch.items()},
                            cfg)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    it = iter(grads)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


MODELS = [("rwkv6-7b", dict(rwkv_wkv_impl="scan")),
          ("rwkv6-7b", dict(rwkv_wkv_impl="chunked", rwkv_chunk=4)),
          ("jamba-1.5-large-398b", {})]


@pytest.mark.parametrize("mode", ["none", "sc_qat"])
@pytest.mark.parametrize("arch,kw", MODELS,
                         ids=["rwkv6-scan", "rwkv6-chunked", "jamba"])
def test_loss_and_grads_match_jax(arch, kw, mode):
    """``loss_fn`` (CE and, on jamba, the MoE aux) and every parameter's
    gradient against ``jax.value_and_grad(repro.models.loss_fn)``."""
    jc, c = _model_cfgs(arch, mode, **kw)
    jp = _live_ssm(jinit_params(jax.random.key(0), jc))
    b = _batch()
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, {k: jnp.asarray(v) for k, v in b.items()},
                           jc), has_aux=True))(jp)
    loss, metrics, grads = _port_grads(from_jax(_np(jp), c, device="cpu"),
                                       b, c)
    assert abs(loss - float(jl)) <= TOL[mode]
    assert abs(metrics["aux"] - float(jm["aux"])) <= TOL[mode]
    want = from_jax(_np(jg), c, device="cpu")
    for got, w in zip(tree_leaves(grads), tree_leaves(want)):
        assert _rel(got.numpy(), w.numpy()) <= MODEL_GRAD_TOL[mode]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_matches_reference_logits(arch):
    """The training forward's logits, sc_qat, within 5e-5."""
    from repro.models import forward as jforward
    jc, c = _model_cfgs(arch)
    jp = _live_ssm(jinit_params(jax.random.key(2), jc))
    toks = _batch(2)["tokens"]
    jl, _, _ = jforward(jp, {"tokens": jnp.asarray(toks)}, jc)
    with torch.no_grad():
        tl, _ = forward(from_jax(_np(jp), c, device="cpu"),
                        {"tokens": _t(toks)}, c)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=TOL["sc_qat"])


# jamba's step on its registered sc_qat only: its jitted reference step
# is the slowest case of the file
STEP_CASES = [(a, kw, m) for a, kw in MODELS[:2] for m in ("none", "sc_qat")] \
    + [(*MODELS[2], "sc_qat")]


@pytest.mark.parametrize(
    "arch,kw,mode", STEP_CASES,
    ids=["rwkv6-scan-none", "rwkv6-scan-sc_qat", "rwkv6-chunked-none",
         "rwkv6-chunked-sc_qat", "jamba-sc_qat"])
def test_train_step_matches_reference(arch, kw, mode):
    """One ``build_train_step`` step (loss, clip, warmup-cosine AdamW,
    jamba's bfloat16 optimizer state) from the reference's initial state:
    loss, grad norm and lr within 2e-5 relative, every parameter within
    2e-5 (2 lr where the reference's gradient is below 1e-6), ``m``
    within the gradient tolerance (bfloat16: one ulp) of each leaf's
    largest entry."""
    jc, c = _model_cfgs(arch, mode, **kw)
    lr = lambda s: jwarmup_cosine(s + 1, 1e-3, 2, 10)      # noqa: E731
    jstate = jinit_train_state(_live_ssm(jinit_params(jax.random.key(7),
                                                      jc)), jc)
    state = from_jax(_np(jstate), c, device="cpu")
    assert state.opt["m"]["embed"]["table"].dtype == \
        getattr(torch, c.opt_state_dtype)
    b = _batch(6)
    jstate, jm = jax.jit(jbuild_train_step(jc, lr))(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    state, m = build_train_step(c, lambda s: warmup_cosine(
        s + 1, 1e-3, 2, 10))(state, {k: _t(v) for k, v in b.items()})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-5)
    want = from_jax(_np(jstate), c, device="cpu")
    lr1 = float(jm["lr"])
    for a, w, mw in zip(tree_leaves(state.params), tree_leaves(want.params),
                        tree_leaves(want.opt["m"])):
        g_small = mw.float().abs() < (1 - 0.9) * 1e-6     # m = (1 - b1) g
        tol = torch.where(g_small, 2 * lr1 + 2e-5, 2e-5)
        assert bool(((a.float() - w.float()).abs() <= tol).all())
    m_tol = MODEL_GRAD_TOL[mode] if c.opt_state_dtype == "float32" \
        else 2.0 ** -8
    for a, w in zip(tree_leaves(state.opt["m"]), tree_leaves(want.opt["m"])):
        assert _rel(a.float().numpy(), w.float().numpy()) <= m_tol


@pytest.mark.parametrize("arch,kw", MODELS,
                         ids=["rwkv6-scan", "rwkv6-chunked", "jamba"])
def test_remat_on_equals_off(arch, kw):
    """Per-period recomputation (and mamba's per-chunk recomputation
    inside it) changes no bit of the loss or the gradients."""
    out = []
    for remat in ("full", "none"):
        _, c = _model_cfgs(arch, remat=remat, **kw)
        p = init_params(c, torch.Generator().manual_seed(1), "cpu")
        out.append(_port_grads(p, _batch(3), c))
    assert out[0][0] == out[1][0]
    for a, b in zip(tree_leaves(out[0][2]), tree_leaves(out[1][2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor,seq", [(16, 32), (64, 16)])
def test_reduced_config_trains_as_the_reference_reduces(arch, factor, seq):
    """``reduced_config`` equals the reference's field by field, the
    optimizer-state dtype included (jamba keeps bfloat16)."""
    want = jreduced_config(jget_arch(arch), factor, seq)
    got = reduced_config(get_arch(arch), factor, seq)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "n_experts", "n_experts_per_tok",
              "moe_group_size", "mamba_chunk", "rwkv_head_dim",
              "rwkv_wkv_impl", "rwkv_chunk", "opt_state_dtype", "remat",
              "dtype"):
        assert getattr(got, f) == getattr(want, f), (arch, f)
    assert dataclasses.asdict(got.quant) == dataclasses.asdict(want.quant)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_and_resumes_on_cpu(arch, tmp_path, capsys):
    args = ["--arch", arch, "--reduce", "64", "--steps", "2", "--batch",
            "2", "--seq", "16", "--device", "cpu", "--ckpt-dir",
            str(tmp_path)]
    state, hist = train_main(args)
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert latest_step(str(tmp_path)) == 2
    cfg = reduced_config(get_arch(arch), 64, 16)
    assert state.opt["m"]["lm_head"]["w"].dtype == \
        getattr(torch, cfg.opt_state_dtype)
    _, hist = train_main(args[:5] + ["3"] + args[6:])
    assert "resumed from checkpoint step 2" in capsys.readouterr().out
    assert [h["step"] for h in hist] == [2]

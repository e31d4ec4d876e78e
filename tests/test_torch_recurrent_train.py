"""Training the recurrent mixers in the port against the JAX reference:
mamba's chunked associative scan (``mamba_train``, ``_conv_full``) and
rwkv6's training time mix and channel mix with the token or the chunked
wkv (``rwkv_tmix_train``, ``rwkv_cmix_train``, ``_wkv_chunked``).  Tiny
rwkv6-7b / jamba-1.5-large-398b through ``loss_fn``, one
``build_train_step`` step and the ``launch.train`` CLI are held in
``tests/test_torch_recurrent_train_model.py``, which shares this file's
constants (``REDUCED``: the models' sizes, those of
``tests/test_models_smoke.py``) and helpers.

Sizes are the reference's own: ``MIXER_SCALE`` of
``tests/test_torch_recurrent.py`` (its zero-initialised leaves
perturbed).  Inputs come from numpy seeds; gradients from ``jax.vjp``
against ``torch.autograd``.  Tolerances, float32:

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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import mamba as jmamba
from repro.models import rwkv6 as jrwkv6
from repro_torch.configs import get_arch
from repro_torch.models import mamba, rwkv6
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import tree_to_torch
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

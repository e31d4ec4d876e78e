"""The port's LSQ gradient and flash attention against the JAX reference:
the LSQ VJP and scale init, the plain version of the flash kernel against
the reference's pair scan (``models.attention.flash_attention``),
``kernels/ref.flash_attention_ref`` and the Pallas kernel in interpret
mode, its blocked backward against ``jax.grad`` through the scan, and the
attention layer's training forward.  The rest of the training path is
held in ``tests/test_torch_train.py``, whose configuration (tiny
granite-3-2b) and helpers this file shares (the two files are one suite,
cut in two so that two workers share it).  Each result within the
tolerance its test states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro.models import init_params as jinit_params
from repro_torch.core import quant
from repro_torch.kernels import build, dispatch, ref
from repro_torch.kernels.flash_attention import flash_attention_backward
from repro_torch.models import attention
from repro_torch.weights import from_jax
from port_fixtures import _one_torch_thread  # noqa: F401
from test_torch_train import CFG, JCFG, _np, _t


# ---------------------------------------------------------------------------
# the LSQ gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,alpha_shape,qn,qp", [
    ((64, 48), (48,), -1, 1),          # ternary weights, per channel
    ((64, 48), (), -1, 1),             # ternary weights, per tensor
    ((4, 16, 32), (), -4, 4),          # BSL-8 activations
    ((3, 40, 24), (), -8, 8),          # BSL-16 residual
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lsq_vjp_matches_jax(shape, alpha_shape, qn, qp, dtype):
    """``gx`` bit-equal; ``galpha`` (a float32 sum taken in another
    order) within 1e-6 of ``gscale * sum(|g| * max(|x/alpha|, qp))``, a
    bound on the sum of its terms' magnitudes.  Values reach far past
    both rails."""
    rng = np.random.default_rng(len(shape) + qp)
    x = (rng.standard_normal(shape) * 2 * qp).astype(np.float32)
    a = (np.abs(rng.standard_normal(alpha_shape)) + 0.5).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(lambda x, a: jquant.lsq_fake_quant(x, a, qn, qp),
                       jnp.asarray(x, jdt), jnp.asarray(a))
    jgx, jga = vjp(jnp.asarray(g, jdt))
    tx = _t(x).to(tdt).requires_grad_()
    ta = _t(a).requires_grad_()
    tout = quant.lsq_fake_quant(tx, ta, qn, qp)
    tout.backward(_t(g).to(tdt))
    assert tout.dtype == tdt and ta.grad.dtype == torch.float32
    np.testing.assert_array_equal(tout.detach().float().numpy(),
                                  np.asarray(out.astype(jnp.float32)))
    np.testing.assert_array_equal(tx.grad.float().numpy(),
                                  np.asarray(jgx.astype(jnp.float32)))
    # the terms' magnitudes, from the x the quantizer saw
    xs = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32)) / a
    terms = np.abs(np.asarray(jnp.asarray(g, jdt).astype(jnp.float32),
                              np.float64)) * np.maximum(np.abs(xs), qp)
    lead = tuple(range(terms.ndim - len(alpha_shape)))
    scale = terms.sum(axis=lead) / np.sqrt(x.size * qp)
    np.testing.assert_array_less(np.abs(ta.grad.numpy() - np.asarray(jga)),
                                 1e-6 * scale + 1e-12)
    assert ((xs < qn) | (xs > qp)).mean() > 0.1     # rails are exercised


def test_init_alpha_matches_jax():
    x = np.random.default_rng(0).standard_normal((32, 16)).astype(np.float32)
    for qp in (1, 4, 8):
        np.testing.assert_allclose(
            quant.init_alpha(_t(x), qp).numpy(),
            np.asarray(jquant.init_alpha(jnp.asarray(x), qp)), rtol=1e-7)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(seed, B, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, h, D)).astype(np.float32)
                 for h in (Hq, Hkv, Hkv))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,bq,bk,causal", [
    (1, 64, 4, 2, 16, 16, 16, True),
    (2, 128, 8, 2, 32, 32, 16, True),
    (1, 64, 4, 4, 16, 32, 32, False),
    (2, 64, 6, 3, 8, 16, 16, True),      # GQA group 2, non-pow2 heads
    # the main path's head widths: granite's D 64, hubert's D 80
    # (bidirectional), jamba's and llava's D 128 at GQA 8 and 7
    (1, 48, 4, 1, 64, 16, 16, True),
    (2, 40, 2, 2, 80, 8, 8, False),
    (1, 32, 8, 1, 128, 16, 16, True),
    (1, 24, 7, 1, 128, 8, 8, False),
])
def test_flash_plain_vs_pallas_and_ref(B, S, Hq, Hkv, D, bq, bk, causal):
    """The plain version against ``flash_attention_pallas`` (interpret) and
    the reference's plain oracle: the test_kernels tolerance, rtol 2e-4
    atol 2e-5 (float32 softmax, sums in another order); the LSE against
    ``logsumexp`` of the reference's logits within 1e-5."""
    q, k, v = _qkv(B * S + Hq, B, S, Hq, Hkv, D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got, lse = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal,
                                       return_lse=True)
    for want in (flash_attention_pallas(jq, jk, jv, causal=causal,
                                        block_q=bq, block_k=bk,
                                        interpret=True),
                 jref.flash_attention_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-5)
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D).astype(np.float64)
    logits = np.einsum("bqhgd,bkhd->bhgqk", qg, k) / np.sqrt(D)
    if causal:
        logits = np.where(np.tril(np.ones((S, S), bool)), logits, -np.inf)
    mx = logits.max(-1, keepdims=True)
    want_lse = (mx[..., 0] + np.log(np.exp(logits - mx).sum(-1)))
    np.testing.assert_allclose(lse.numpy(), want_lse.reshape(B, Hq, S),
                               rtol=1e-5, atol=1e-5)


def test_flash_plain_bf16_vs_pallas():
    """bfloat16 q/k/v: outputs within one bf16 ulp at |o| <= 2 (7.8e-3,
    so atol 1e-2), both sides computing in float32 and rounding once."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16)
               for a in _qkv(5, 2, 128, 8, 2, 32))
    want = flash_attention_pallas(q, k, v, block_q=32, block_k=32,
                                  interpret=True)
    tq, tk, tv = (_t(np.asarray(a.astype(jnp.float32))).bfloat16()
                  for a in (q, k, v))
    got = ref.flash_attention_ref(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=1e-2)


@pytest.mark.parametrize("S,chunk,causal", [
    (128, 32, True), (96, 32, False), (80, 32, True)])
def test_model_flash_matches_reference_scan(S, chunk, causal):
    """``models.attention.flash_attention`` ((B, S, Hkv, G, D) layout,
    q scaled in its own dtype) against the reference's pair scan at any
    chunk, the scan's gcd rule included (S=80): float32 within 2e-6."""
    q, k, v = _qkv(S, 2, S, 4, 2, 16)
    q = q.reshape(2, S, 2, 2, 16)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, chunk)
    got = attention.flash_attention(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_jax_grad_through_the_scan(causal):
    """The autograd function's gradients (plain forward, saved LSE,
    blocked backward) against ``jax.vjp`` of the reference's checkpointed
    pair scan: float32 within 1e-5."""
    B, S, Hkv, G, D = 2, 64, 2, 2, 16
    q, k, v = _qkv(11, B, S, Hkv * G, Hkv, D)
    q = q.reshape(B, S, Hkv, G, D)
    g = np.random.default_rng(12).standard_normal(q.shape).astype(
        np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(
        q, k, v, causal, 16), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    attention.flash_attention(tq, tk, tv, causal).backward(_t(g))
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def test_flash_backward_never_builds_the_whole_weights_matrix(monkeypatch):
    """Blocks of a few query rows (ragged last block) give the one-block
    gradient to float32 rounding."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = map(_t, _qkv(3, 1, 50, 4, 2, 16))
    _, lse = ref.flash_attention_ref(q, k, v, True, return_lse=True)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    whole = flash_attention_backward(q, k, v, lse, g, causal=True)
    monkeypatch.setattr(fa, "_BWD_BLOCK_ELEMS", 4 * 50 * 7)
    blocked = flash_attention_backward(q, k, v, lse, g, causal=True)
    for a, b in zip(blocked, whole):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_dispatch_flash_on_cpu_launches_nothing():
    build.reset_launches()
    q, k, v = map(_t, _qkv(4, 1, 16, 2, 1, 16))
    out = dispatch.flash_attention(q, k, v)
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v),
                               rtol=0, atol=0)
    assert build.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


def test_attn_train_matches_reference():
    """One attention layer's training forward (q/k/v/o projections under
    sc_qat, RoPE, flash attention): y and the K/V within 1e-5."""
    jp = jinit_params(jax.random.key(0), JCFG)
    p = from_jax(_np(jp), CFG, device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 16, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    jlp = jax.tree.map(lambda a: a[0], jp["periods"]["p0"]["mixer"])
    jy, (jk, jv) = jattn.attn_train(jlp, jnp.asarray(x), JCFG,
                                    jnp.asarray(pos))
    y, (k, v) = attention.attn_train(p["layers"][0]["mixer"], _t(x), CFG,
                                     _t(pos))
    for a, b in ((y, jy), (k, jk), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)

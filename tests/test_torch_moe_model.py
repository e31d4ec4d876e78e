"""The MoE models in the port against the JAX reference: tiny
qwen3-moe-235b-a22b / dbrx-132b through ``loss_fn``, one train step, the
port's engine against the JAX engine and against its own sequential
oracle.  ``moe_apply`` and the expert products are held in
``tests/test_torch_moe.py``, whose models (the reference's ``REDUCED``
sizes, float32, parameters carried over by ``weights.from_jax``) and
helpers this file shares (the two files are one suite, cut in two so that
two workers share it).  Tolerances:

* ``loss_fn``: loss within ``1e-5`` and every gradient leaf within
  ``1e-5`` (quantization off) / ``5e-5`` (sc_qat) of its largest entry,
  as ``tests/test_torch_train.py`` holds the dense model; one train step
  the same way, its AdamW state under sc_qat within ``2e-4`` (see the
  test);
* serving: greedy tokens equal, the port's engine against the JAX
  engine and against its own sequential oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.serving import ServeEngine as JServeEngine
from repro.train import build_train_step as jbuild_train_step
from repro.train import init_train_state as jinit_train_state
from repro_torch.models import loss_fn
from repro_torch.optim import warmup_cosine
from repro_torch.serving import ServeEngine, sequential_generate
from repro_torch.train import TrainState, build_train_step
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import from_jax
from port_fixtures import _one_torch_thread  # noqa: F401
from test_torch_moe import ARCHS, _cfgs, _np, _t, arch_params  # noqa: F401

PAIRS = [("qat", "fp"), ("sc_int", "int8"), ("sc_int_approx", "sc")]
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12, 13, 14]]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(seed=1, B=2, S=16):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 131, (B, S + 1)).astype(np.int32)
    return {"tokens": seq[:, :-1], "targets": seq[:, 1:],
            "loss_mask": np.ones((B, S), np.float32)}


def _max_rel_err(got_tree, want_tree):
    return max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
               for a, b in zip(tree_leaves(got_tree),
                               tree_leaves(want_tree)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,tol", [("none", 1e-5), ("sc_qat", 5e-5)])
def test_loss_and_grads_match_jax(arch, mode, tol):
    """``loss_fn`` (ce + 1e-2 aux) and every gradient leaf, the router's
    and the experts' included, against ``jax.value_and_grad``."""
    jc, c = _cfgs(arch, mode)
    jp = jinit_params(jax.random.key(0), jc)
    b = _batch()
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jloss_fn(p, {k: jnp.asarray(v) for k, v in b.items()},
                           jc), has_aux=True)(jp)
    params = from_jax(_np(jp), c, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, m = loss_fn(params, {k: _t(v) for k, v in b.items()}, c)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    gtree = tree_map(lambda _: next(it), params)
    assert float(m["aux"].detach()) > 0
    for key in ("loss", "ce", "aux"):
        assert abs(float(m[key]) - float(jm[key])) <= tol, key
    assert _max_rel_err(gtree, from_jax(_np(jg), c, device="cpu")) <= tol


# AdamW's m and v within tol / 2 tol of each leaf's largest entry.  Under
# sc_qat the scalar LSQ scales (alpha_a, alpha_r) take gradients summed
# over every element, with cancellation, and a fake-quant level flipped
# by a one-ulp input difference moves them (1.0e-4 on dbrx's
# layers/1/mixer/wq/alpha_a; every other leaf within 1e-5)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,tol", [("none", 1e-5), ("sc_qat", 2e-4)])
def test_train_step_matches_reference(arch, mode, tol):
    """One train step from the reference's ``TrainState`` (carried over by
    ``from_jax``): metrics, updated params and AdamW state."""
    jc, c = _cfgs(arch, mode)
    lr = lambda s: jwarmup_cosine(s + 1, 1e-3, 2, 10)      # noqa: E731
    jstate = jinit_train_state(jinit_params(jax.random.key(7), jc), jc)
    state = from_jax(_np(jstate), c, device="cpu")
    assert isinstance(state, TrainState)
    b = _batch(6)
    jstate, jm = jax.jit(jbuild_train_step(jc, lr))(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    state, m = build_train_step(c, lambda s: warmup_cosine(
        s + 1, 1e-3, 2, 10))(state, {k: _t(v) for k, v in b.items()})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-5)
    assert float(m["aux"]) > 0
    want = from_jax(_np(jstate), c, device="cpu")
    for a, w in zip(tree_leaves(state.params), tree_leaves(want.params)):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0, atol=2e-5)
    assert _max_rel_err(state.opt["m"], want.opt["m"]) <= tol
    assert _max_rel_err(state.opt["v"], want.opt["v"]) <= 2 * tol


def test_grad_accum_reports_ce_and_aux():
    _, c = _cfgs("dbrx-132b", "none")
    jp = jinit_params(jax.random.key(1), _cfgs("dbrx-132b", "none")[0])
    from repro_torch.train import init_train_state
    state = init_train_state(from_jax(_np(jp), c, device="cpu"), c)
    _, m = build_train_step(c, lambda s: 1e-3, grad_accum=2)(
        state, {k: _t(v) for k, v in _batch(B=4).items()})
    assert set(m) >= {"loss", "ce", "aux"}
    np.testing.assert_allclose(float(m["loss"]),
                               float(m["ce"]) + 1e-2 * float(m["aux"]),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _tokens(done):
    return [r.generated for r in sorted(done, key=lambda r: r.rid)]


ENGINE = dict(max_slots=2, max_len=32, page_size=4)


@pytest.mark.parametrize("datapath,fmt", PAIRS)
def test_engine_tokens_equal_reference_engine(arch_params, datapath, fmt):
    """4 prompts through 2 slots on both engines (the reference's
    ``"reference"`` backends)."""
    arch, jp, tp = arch_params
    jc, c = _cfgs(arch)
    jeng = JServeEngine(jp, jc, datapath=datapath, kv_format=fmt,
                        bsn_backend="reference", attn_backend="reference",
                        **ENGINE)
    eng = ServeEngine(tp, c, datapath=datapath, kv_format=fmt, device="cpu",
                      **ENGINE)
    for p in PROMPTS:
        jeng.submit(p, max_new_tokens=5)
        eng.submit(p, max_new_tokens=5)
    assert _tokens(eng.run_to_completion()) == \
        _tokens(jeng.run_to_completion())


@pytest.mark.parametrize("datapath,fmt", PAIRS)
def test_engine_tokens_equal_sequential_generate(arch_params, datapath, fmt):
    """Batched == one request at a time, with a chunked prefill (chunk 4)
    and another page size on the oracle's side; the batched expert
    products run at other row counts than the oracle's."""
    arch, _, tp = arch_params
    _, c = _cfgs(arch)
    prompts = PROMPTS + [[3, 1, 4, 1, 5, 9, 2, 6]]
    eng = ServeEngine(tp, c, datapath=datapath, kv_format=fmt, device="cpu",
                      prefill_chunk=4, **ENGINE)
    for p in prompts:
        eng.submit(p, max_new_tokens=6)
    want = sequential_generate(tp, c, prompts, max_new_tokens=6, max_len=32,
                               datapath=datapath, kv_format=fmt, page_size=8,
                               device="cpu")
    assert _tokens(eng.run_to_completion()) == want

"""Training tiny rwkv6-7b / jamba-1.5-large-398b in the port against the
JAX reference: ``loss_fn``, the training forward, one
``build_train_step`` step, recompute, ``reduced_config`` and the
``launch.train`` CLI.  The mixers' training forms are held in
``tests/test_torch_recurrent_train.py``, whose constants and helpers this
file shares (the two files are one suite, cut in two so that two workers
share it).

Sizes are ``REDUCED`` of ``tests/test_models_smoke.py`` (mamba's
``conv_w`` at 10x the reference's draw, as the serving tests: at the
reference's scale the SSM's inputs all round to activation level 0 under
sc_qat and its gradients are float noise around zero).  Inputs come from
numpy seeds; gradients from ``jax.value_and_grad`` against
``torch.autograd``.  Tolerances, float32: loss within the mode's
tolerance; gradients and AdamW's ``m`` within ``5e-5`` of each leaf's
largest entry with quantization off (mamba's ``a_log`` / ``dt`` gradients
sum over every (token, channel, state) of eight layers: 2.3e-5 measured)
and ``2e-4`` under sc_qat (the LSQ scales, as
``tests/test_torch_moe.py``'s train step); jamba's bfloat16 ``m`` within
one bfloat16 ulp of the leaf's largest entry (2**-8); one AdamW step's
parameters within ``2e-5``, as ``tests/test_torch_train.py``, except
where the reference's gradient is below 1e-6: the first step is ``lr * g
/ (|g| + eps)``, and there the gradient's float32 rounding (2.3e-5 of the
leaf's largest entry on jamba's SSM leaves) moves the step anywhere in
``[-lr, lr]``, so those entries are held within ``2 lr`` (1.0e-4 off on
one of jamba's).
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
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train import build_train_step as jbuild_train_step
from repro.train import init_train_state as jinit_train_state
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_arch
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import reduced_config
from repro_torch.models import forward, init_params, loss_fn
from repro_torch.optim import warmup_cosine
from repro_torch.train import build_train_step
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import from_jax
from port_fixtures import _one_torch_thread  # noqa: F401
from test_torch_recurrent_train import (ARCHS, COMMON, MODEL_GRAD_TOL,
                                        REDUCED, TOL, _mode, _np, _rel, _t)


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

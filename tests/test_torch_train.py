"""The port's training path against the JAX reference.

Same inputs through both (numpy from a seed; JAX parameters and training
state carried over by ``weights.from_jax``), each result within the
tolerance its test states.  Tiny granite-3-2b: 2 layers, d_model 64,
float32, the configuration of ``tests/test_substrate.py``.  The LSQ
gradient and flash attention under it are held in
``tests/test_torch_train_flash.py``, which shares this file's
configuration and helpers (the two files are one suite, cut in two so
that two workers share it).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train import build_train_step as jbuild_train_step
from repro.train import init_train_state as jinit_train_state
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint, wait_for_saves)
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticLM
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import reduced_config
from repro_torch.models import init_params, loss_fn
from repro_torch.optim import (adamw_init, adamw_update,
                               clip_by_global_norm, global_norm,
                               warmup_cosine)
from repro_torch.train import (TrainState, build_train_step,
                               init_train_state, run_training)
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import from_jax
from port_fixtures import _one_torch_thread  # noqa: F401


SCALE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=64, vocab_pad_multiple=32, dtype="float32")
JCFG = jget_arch("granite-3-2b").scaled(attn_q_chunk=8, **SCALE)
CFG = get_arch("granite-3-2b").scaled(**SCALE)


def _cfgs(mode="sc_qat", **kw):
    jc, c = JCFG.scaled(**kw), CFG.scaled(**kw)
    return (jc.scaled(quant=jc.quant.with_mode(mode)),
            c.scaled(quant=c.quant.with_mode(mode)))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed=1, B=4, S=16):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, SCALE["vocab_size"], (B, S + 1)).astype(np.int32)
    return {"tokens": seq[:, :-1], "targets": seq[:, 1:],
            "loss_mask": np.ones((B, S), np.float32)}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: _t(v) for k, v in b.items()}


def _port_grads(params, batch, cfg):
    """(loss, metrics, grads) of the port's loss_fn; grads as a tree."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def _max_rel_err(got_tree, want_tree):
    """max over leaves of max|got - want| / max|want|."""
    errs = [float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
            for a, b in zip(tree_leaves(got_tree), tree_leaves(want_tree))]
    return max(errs)


# ---------------------------------------------------------------------------
# loss and its gradients
# ---------------------------------------------------------------------------

# quant none: float32 products summed in another order, 1e-5; sc_qat: the
# fake-quant lattice passes 1-ulp input differences on as whole quanta
# now and then (none seen on these inputs), so 5e-5
@pytest.mark.parametrize("mode,tol", [("none", 1e-5), ("sc_qat", 5e-5)])
@pytest.mark.parametrize("ce_chunks", [0, 4])
def test_loss_and_grads_match_jax(mode, tol, ce_chunks):
    """``loss_fn`` and every parameter's gradient (LSQ scales included)
    against ``jax.value_and_grad(repro.models.loss_fn)``: loss within
    ``tol`` absolute, each gradient leaf within ``tol`` of its largest
    entry; the chunked cross-entropy against the reference's own."""
    jc, c = _cfgs(mode, ce_chunks=ce_chunks)
    jp = jinit_params(jax.random.key(0), jc)
    b = _batch()
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jloss_fn(p, _jbatch(b), jc), has_aux=True)(jp)
    loss, metrics, grads = _port_grads(from_jax(_np(jp), c, device="cpu"),
                                       _tbatch(b), c)
    assert abs(float(loss) - float(jl)) <= tol
    assert abs(float(metrics["ce"]) - float(jm["ce"])) <= tol
    assert _max_rel_err(grads, from_jax(_np(jg), c, device="cpu")) <= tol


def test_grad_norm_grows_with_depth_in_both_packages():
    """Under sc_qat at random init the gradient norm grows with depth, in
    the reference as in the port (ROADMAP Queue 3 item 7): at d_model
    128, 12 layers give over 300x the 2-layer norm on both sides; the two
    packages agree within 5% at 2 layers and 2x at 12, where the LSQ
    gradient's jumps at the clip rails part them."""
    norms = {}
    for layers in (2, 12):
        kw = dict(SCALE, n_layers=layers, d_model=128, n_heads=2,
                  n_kv_heads=1, d_ff=512, vocab_size=256,
                  vocab_pad_multiple=64)
        jc = jget_arch("granite-3-2b").scaled(attn_q_chunk=32, **kw)
        c = get_arch("granite-3-2b").scaled(**kw)
        jp = jinit_params(jax.random.key(0), jc)
        b = _batch(0, B=2, S=32)
        jg = jax.jit(jax.grad(lambda p: jloss_fn(p, _jbatch(b), jc)[0]))(jp)
        jn = float(jnp.sqrt(sum(jnp.sum(jnp.square(x))
                                for x in jax.tree.leaves(jg))))
        _, _, g = _port_grads(from_jax(_np(jp), c, device="cpu"),
                              _tbatch(b), c)
        norms[layers] = (jn, float(global_norm(g)))
    for side in (0, 1):
        assert norms[12][side] > 300 * norms[2][side], norms
    assert 0.5 < norms[12][1] / norms[12][0] < 2, norms
    assert abs(norms[2][1] / norms[2][0] - 1) < 0.05, norms


@pytest.mark.parametrize("mode", ["none", "sc_qat"])
def test_remat_on_equals_off(mode):
    """Per-period recomputation changes no bit of the loss or gradients."""
    out = []
    for remat in ("full", "none"):
        _, c = _cfgs(mode, remat=remat)
        p = init_params(c, torch.Generator().manual_seed(1), "cpu")
        out.append(_port_grads(p, _tbatch(_batch(3)), c))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_leaves(out[0][2]), tree_leaves(out[1][2])):
        assert torch.equal(a, b)


def test_ce_chunks_equal_whole_logits():
    """Chunked cross-entropy == the whole-logits loss (quant none: under
    sc_qat the LSQ gradient scale of lm_head's activations depends on the
    chunk size, in the reference too): loss within 1e-6, grads 1e-5."""
    _, c0 = _cfgs("none")
    _, c4 = _cfgs("none", ce_chunks=3)           # 16 % 3 != 0 -> 2 chunks
    p = init_params(c0, torch.Generator().manual_seed(2), "cpu")
    l0, _, g0 = _port_grads(p, _tbatch(_batch(4)), c0)
    l4, _, g4 = _port_grads(p, _tbatch(_batch(4)), c4)
    assert abs(float(l0) - float(l4)) <= 1e-6
    assert _max_rel_err(g4, g0) <= 1e-5


def test_loss_mask_weights_the_mean():
    _, c = _cfgs("none")
    p = init_params(c, torch.Generator().manual_seed(0), "cpu")
    b = _tbatch(_batch(5))
    b["loss_mask"][:, 8:] = 0.0
    half = {k: v[:, :8] for k, v in b.items()}
    torch.testing.assert_close(loss_fn(p, b, c)[0], loss_fn(p, half, c)[0],
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# optimizer, clipping, schedules
# ---------------------------------------------------------------------------

def test_adamw_decreases_loss_on_quadratic():
    params = {"w": torch.tensor([2.0, -3.0])}
    opt = adamw_init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        params, opt = adamw_update(g, opt, params, 0.05, weight_decay=0.0)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(state_dtype):
    """Three AdamW steps on a tree of a matrix (decayed), a vector (not
    decayed) and a bf16 matrix: params, m, v within 1e-6 relative (bf16
    leaves: one bf16 ulp) and the same count."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 6), "scale": (6,), "wb": (4, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k == "wb" else jnp.float32)
          for k, v in params.items()}
    tp = {k: _t(v).to(torch.bfloat16 if k == "wb" else torch.float32)
          for k, v in params.items()}
    jo, to = jadamw_init(jp, state_dtype), adamw_init(tp, state_dtype)
    for i in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jg = {k: jnp.asarray(v, jp[k].dtype) for k, v in g.items()}
        tg = {k: _t(v).to(tp[k].dtype) for k, v in g.items()}
        lr = float(jwarmup_cosine(i + 1, 1e-2, 2, 10))
        jp, jo = jadamw_update(jg, jo, jp, lr)
        tp, to = adamw_update(tg, to, tp, lr)
    assert int(to["count"]) == int(jo["count"]) == 3
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        for k in shapes:
            w = np.asarray(want[k].astype(jnp.float32))
            rtol = 8e-3 if got[k].dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(got[k].float().numpy(), w,
                                       rtol=rtol, atol=1e-7)


def test_clip_by_global_norm():
    g = {"a": torch.ones(10) * 100.0, "b": [torch.zeros(3)]}
    clipped, norm = clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(norm), 100 * np.sqrt(10), rtol=1e-5)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    small, n2 = clip_by_global_norm({"a": torch.ones(4)}, 10.0)
    assert float(n2) == 2.0 and torch.equal(small["a"], torch.ones(4))


def test_warmup_cosine_shape_and_values():
    assert float(warmup_cosine(0, 1e-3, 10, 100)) == 0.0
    assert float(warmup_cosine(10, 1e-3, 10, 100)) == pytest.approx(1e-3)
    assert float(warmup_cosine(100, 1e-3, 10, 100)) == pytest.approx(1e-4)
    for s in (0, 3, 9, 10, 37, 99, 100, 150):
        np.testing.assert_allclose(
            warmup_cosine(torch.tensor(s, dtype=torch.int32), 3e-3, 10,
                          100).numpy(),
            np.asarray(jwarmup_cosine(s, 3e-3, 10, 100)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

# params after one AdamW step move by ~lr * sign(g); a gradient within
# float32 rounding of zero could flip its step, so params within 2e-5
# (4% of this lr).  m = 0.1 g and v = 0.05 g^2 of the clipped gradient:
# m within the gradient's tolerance of each leaf's largest entry, v
# within twice it (a square doubles the relative error)
@pytest.mark.parametrize("mode,tol", [("none", 1e-5), ("sc_qat", 5e-5)])
def test_train_step_matches_reference(mode, tol):
    """One ``build_train_step`` step (loss, clip, warmup-cosine AdamW)
    from the reference's initial state: the metrics, the updated params
    and the AdamW state leaf by leaf."""
    jc, c = _cfgs(mode)
    lr = lambda s: jwarmup_cosine(s + 1, 1e-3, 2, 10)      # noqa: E731
    jstate = jinit_train_state(jinit_params(jax.random.key(7), jc), jc)
    state = from_jax(_np(jstate), c, device="cpu")
    assert isinstance(state, TrainState)
    b = _batch(6, B=2)
    jstate, jm = jax.jit(jbuild_train_step(jc, lr))(jstate, _jbatch(b))
    state, m = build_train_step(c, lambda s: warmup_cosine(
        s + 1, 1e-3, 2, 10))(state, _tbatch(b))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-5)
    want = from_jax(_np(jstate), c, device="cpu")
    assert int(state.step) == int(want.step) == 1
    assert int(state.opt["count"]) == int(want.opt["count"]) == 1
    for a, w in zip(tree_leaves(state.params), tree_leaves(want.params)):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0, atol=2e-5)
    assert _max_rel_err(state.opt["m"], want.opt["m"]) <= tol
    assert _max_rel_err(state.opt["v"], want.opt["v"]) <= 2 * tol


def test_decay_mask_follows_the_reference_stacked_layout():
    """The reference decays ``p.ndim >= 2`` on layers stacked over a
    leading period axis: per-layer norms and per-channel alpha_w decay,
    per-layer scalars and the final norm do not."""
    p = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    from repro_torch.train.step import decay_mask
    from repro_torch.tree import tree_paths
    mask = dict(zip((k for k, _ in tree_paths(p)), decay_mask(p)))
    assert mask["layers/0/norm1/scale"] and mask["layers/1/mixer/wq/alpha_w"]
    assert mask["embed/table"] and mask["lm_head/w"]
    assert not mask["layers/0/alpha_r1"]
    assert not mask["layers/0/mixer/wq/alpha_a"]
    assert not mask["final_norm/scale"] and not mask["lm_head/alpha_w"]


def test_grad_accum_matches_single_batch():
    """grad_accum=4 == one batch without quantization (the reference's
    substrate test and tolerances)."""
    _, c = _cfgs("none")
    ds = SyntheticLM(vocab_size=c.vocab_size, seq_len=16, seed=3)
    batch = ds.batch(0, 8)
    out = []
    for accum in (1, 4):
        p = init_params(c, torch.Generator().manual_seed(7), "cpu")
        step = build_train_step(c, lambda s: 1e-3, grad_accum=accum)
        out.append(step(init_train_state(p, c), batch))
    (s1, m1), (s4, m4) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s4.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_grad_compress_is_not_ported_yet():
    """Named when ``grad_compress`` raised; it is ported now: the state
    carries an error leaf where the reference's has one (same None
    pattern as ``jinit_train_state(grad_compress=True)``), and a step runs
    and leaves a residual (tests/test_torch_compression.py holds the
    numbers against the reference)."""
    p = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    state = init_train_state(p, CFG, grad_compress=True)
    jstate = jinit_train_state(jinit_params(jax.random.key(0), JCFG), JCFG,
                               grad_compress=True)
    want = from_jax(_np(jstate), CFG, device="cpu").error
    assert tree_map(lambda e: tuple(e.shape), state.error) \
        == tree_map(lambda e: tuple(e.shape), want)
    step = build_train_step(CFG, lambda s: 1e-3, grad_compress=True)
    state, m = step(state, _tbatch(_batch(2, B=2)))
    assert np.isfinite(float(m["loss"]))
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(state.error))


def test_train_steps_lower_the_loss():
    """30 steps of the unquantized tiny model on the synthetic language
    take the loss down (a dead optimizer or a wrong gradient would not)."""
    _, c = _cfgs("none")
    ds = SyntheticLM(vocab_size=c.vocab_size, seq_len=16, seed=3)
    state = init_train_state(
        init_params(c, torch.Generator().manual_seed(0), "cpu"), c)
    step = build_train_step(c, lambda s: warmup_cosine(s, 3e-3, 5, 30))
    losses = []
    for i in range(30):
        state, m = step(state, ds.batch(i, 8))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


# ---------------------------------------------------------------------------
# checkpoints, the loop, data, the launcher
# ---------------------------------------------------------------------------

def _state(seed=0, cfg=CFG):
    return init_train_state(
        init_params(cfg, torch.Generator().manual_seed(seed), "cpu"), cfg)


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    state.params["layers"][0]["norm1"]["scale"] = torch.randn(64).bfloat16()
    save_checkpoint(str(tmp_path), 5, state, async_=False)
    assert latest_step(str(tmp_path)) == 5
    manifest = (tmp_path / "step_5" / "manifest.json").read_text()
    assert '"bfloat16"' in manifest
    restored = restore_checkpoint(str(tmp_path), 5, tree_map(
        torch.zeros_like, state))
    assert isinstance(restored, TrainState) and restored.error is None
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_ignores_partial(tmp_path):
    save_checkpoint(str(tmp_path), 3, _state(), async_=False)
    os.makedirs(tmp_path / "step_9.tmp")          # a writer that died
    os.makedirs(tmp_path / "step_7")              # no manifest
    assert latest_step(str(tmp_path)) == 3


def test_loop_restart_resumes_deterministically(tmp_path):
    """6 steps straight == 3 steps, a checkpoint, a fresh process's state
    resumed from it, 3 more steps."""
    ds = SyntheticLM(vocab_size=CFG.vocab_size, seq_len=16, seed=3)
    mk = lambda: build_train_step(CFG, lambda s: 1e-3)       # noqa: E731
    batch_fn = lambda step: ds.batch(step, 4)                 # noqa: E731
    quiet = dict(log_every=100, log_fn=lambda *_: None)
    sA, _ = run_training(mk(), _state(5), batch_fn, 6, ckpt_dir=None,
                         **quiet)
    ck = str(tmp_path / "run")
    os.makedirs(ck)
    run_training(mk(), _state(5), batch_fn, 3, ckpt_dir=ck, ckpt_every=3,
                 **quiet)
    wait_for_saves()
    assert latest_step(ck) == 3
    sB, hist = run_training(mk(), _state(5), batch_fn, 6, ckpt_dir=ck,
                            ckpt_every=100, **quiet)
    # as in the reference, the metrics' "step" (the step the update
    # started from) overrides the loop's count in the history
    assert hist[-1]["step"] == 5 and "sec_per_step" in hist[-1]
    for a, b in zip(tree_leaves(sA.params), tree_leaves(sB.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_data_deterministic():
    ds = SyntheticLM(vocab_size=CFG.vocab_size, seq_len=16, seed=3)
    b1, b2 = ds.batch(7, 8), ds.batch(7, 8)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], ds.batch(8, 8)["tokens"])
    assert b1["tokens"].dtype == torch.int32
    assert torch.equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])


def test_data_walks_the_reference_language():
    """The transition table is the reference's, and every step of the
    port's chains follows it."""
    from repro.data import SyntheticLM as JSyntheticLM
    ds = SyntheticLM(vocab_size=64, seq_len=32, seed=3)
    trans = JSyntheticLM(vocab_size=64, seq_len=32, seed=3)._transitions()
    np.testing.assert_array_equal(ds._transitions(), trans)
    b = ds.batch(0, 16)
    tok, tgt = b["tokens"].numpy(), b["targets"].numpy()
    assert all(tgt[i, t] in trans[tok[i, t]] for i in range(16)
               for t in range(32))


def test_reduced_config_matches_reference():
    from repro.launch.train import reduced_config as jreduced_config
    for factor, seq in ((8, 256), (16, 32), (1, 64)):
        want = jreduced_config(jget_arch("granite-3-2b"), factor, seq)
        got = reduced_config(get_arch("granite-3-2b"), factor, seq)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size", "vocab_pad_multiple", "dtype", "head_dim",
                  "attn_q_chunk", "remat", "ce_chunks", "opt_state_dtype"):
            assert getattr(got, f) == getattr(want, f), (factor, f)


def test_launch_train_runs_and_resumes_on_cpu(tmp_path, capsys):
    args = ["--arch", "granite-3-2b", "--reduce", "16", "--steps", "3",
            "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    _, hist = train_main(args)
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert latest_step(str(tmp_path)) == 3
    _, hist = train_main(args[:5] + ["5"] + args[6:])
    assert "resumed from checkpoint step 3" in capsys.readouterr().out
    assert [h["step"] for h in hist] == [3, 4]

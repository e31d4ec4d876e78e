"""int8 gradient compression and ``host_batch`` against the reference.

``repro_torch.distributed.compression`` against
``repro.distributed.compression``: the error-feedback round trip bit for
bit over three steps (same gradients, same layout), ``compressed_psum``
on two gloo ranks against the reference's formula (each rank's int8
levels summed in int32, times the largest scale), one
``build_train_step(grad_compress=True)`` step of tiny granite-3-2b
against the reference's at ``tests/test_torch_train.py``'s step
tolerances, and ``weights.from_jax`` of a compressed ``TrainState``.
``data.host_batch`` equals the reference's for 1, 2 and 4 hosts.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_worker as mw
from repro.configs import get_arch as jget_arch
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.data.synthetic import host_batch as jhost_batch
from repro.distributed import compression as jcomp
from repro.models import init_params as jinit_params
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train import build_train_step as jbuild_train_step
from repro.train import init_train_state as jinit_train_state
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticLM, host_batch
from repro_torch.distributed import compression
from repro_torch.optim import warmup_cosine
from repro_torch.train import TrainState, build_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_paths
from repro_torch.weights import from_jax
from port_fixtures import _one_torch_thread, _partitionable  # noqa: F401

SCALE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=64, vocab_pad_multiple=32, dtype="float32")


def _grads(seed, scale=1.0):
    """A gradient tree of mixed ranks and dtypes (float32 and bfloat16
    matrices, a stacked 3-d leaf, a vector and a scalar)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa
    return {"w": f(32, 48), "stack": f(3, 16, 8), "b": f(48), "s": f(),
            "h": f(24, 40).astype(jnp.bfloat16)}


def _t(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _n(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(jnp.bfloat16)
    return t.numpy()


def test_compress_decompress_bit_for_bit_over_three_steps():
    """The same gradients through both round trips, the error fed back
    three times: gradients' and errors' bits equal, None leaves (rank <
    2) untouched."""
    jg0 = {k: jnp.asarray(v) for k, v in _grads(0).items()}
    je = jcomp.init_error_state(jg0)
    te = compression.init_error_state({k: _t(v)
                                       for k, v in _grads(0).items()})
    assert {k for k, v in te.items() if v is None} == \
        {k for k, v in je.items() if v is None} == {"b", "s"}
    for step in range(3):
        g = _grads(step + 1, scale=10.0 ** (step - 1))
        jg, je = jcomp.compress_decompress(
            {k: jnp.asarray(v) for k, v in g.items()}, je)
        tg, te = compression.compress_decompress(
            {k: _t(v) for k, v in g.items()}, te)
        for k in g:
            assert tg[k].dtype == _t(g[k]).dtype
            np.testing.assert_array_equal(_n(tg[k]), np.asarray(jg[k]),
                                          err_msg=f"{k} step {step}")
            if je[k] is None:
                assert te[k] is None
            else:
                np.testing.assert_array_equal(te[k].numpy(),
                                              np.asarray(je[k]))


def test_quant_int8_levels_and_scale_bit_for_bit():
    g = _grads(5)["w"]
    jq, js = jcomp._quant_int8(jnp.asarray(g))
    tq, ts = compression._quant_int8(_t(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    zq, zs = compression._quant_int8(torch.zeros(4, 4))
    assert float(zs) == float(jcomp._quant_int8(jnp.zeros((4, 4)))[1])
    assert not zq.any()


def test_compressed_psum_on_two_ranks_equals_the_reference_formula():
    """Two gloo ranks: every rank gets sum_r q_r (int32) times max_r
    scale_r, as the reference's ``compressed_psum`` under shard_map."""
    grads = [_grads(11)["w"], _grads(12, scale=3.0)["w"]]
    got = mw.on_ranks(mw.psum, 2, grads)
    qs = [jcomp._quant_int8(jnp.asarray(g)) for g in grads]
    total = sum(np.asarray(q, np.int32) for q, _ in qs)
    scale = max(np.float32(s) for _, s in qs)
    want = total.astype(np.float32) * scale
    for r in got:
        np.testing.assert_array_equal(r, want)


def _cfgs():
    """The reference's and the port's tiny granite, quantization off."""
    jc = jget_arch("granite-3-2b").scaled(attn_q_chunk=8, **SCALE)
    c = get_arch("granite-3-2b").scaled(**SCALE)
    return (jc.scaled(quant=jc.quant.with_mode("none")),
            c.scaled(quant=c.quant.with_mode("none")))


def _batch(seed=6, B=2, S=16):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, SCALE["vocab_size"], (B, S + 1)).astype(np.int32)
    return {"tokens": seq[:, :-1], "targets": seq[:, 1:],
            "loss_mask": np.ones((B, S), np.float32)}


@functools.lru_cache(maxsize=None)
def _jstate():
    """The reference's compressed initial state of the unquantized tiny
    granite."""
    jc, _ = _cfgs()
    return jinit_train_state(jinit_params(jax.random.key(7), jc), jc,
                             grad_compress=True)


def test_from_jax_carries_a_compressed_train_state():
    _, c = _cfgs()
    state = from_jax(jax.tree.map(np.asarray, _jstate()), c, device="cpu")
    assert isinstance(state, TrainState) and state.error is not None
    assert state.error["final_norm"]["scale"] is None
    assert state.error["layers"][0]["norm1"]["scale"].shape == (c.d_model,)
    assert all(float(e.abs().max()) == 0 for e in tree_leaves(state.error))
    want = compression.init_error_state(state.params)
    assert tree_map(lambda e: tuple(e.shape), state.error) \
        == tree_map(lambda e: tuple(e.shape), want)


# the tolerances of tests/test_torch_train.py's step test, mode "none"
STEP_TOL = 1e-5


def test_train_step_with_grad_compress_matches_reference():
    """One step with ``grad_compress=True`` from the reference's initial
    state (warmup-cosine AdamW, clip, the int8 round trip with one scale
    for each stacked leaf of the reference): metrics, updated params,
    AdamW state and the new error state."""
    jc, c = _cfgs()
    lr = lambda s: jwarmup_cosine(s + 1, 1e-3, 2, 10)      # noqa: E731
    jstate = _jstate()
    state = from_jax(jax.tree.map(np.asarray, jstate), c, device="cpu")
    b = _batch()
    jstate, jm = jax.jit(jbuild_train_step(jc, lr, grad_compress=True))(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    state, m = build_train_step(c, lambda s: warmup_cosine(
        s + 1, 1e-3, 2, 10), grad_compress=True)(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-5)
    want = from_jax(jax.tree.map(np.asarray, jstate), c, device="cpu")
    for a, w in zip(tree_leaves(state.params), tree_leaves(want.params)):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0, atol=2e-5)
    for name in ("m", "v"):
        for a, w in zip(tree_leaves(state.opt[name]),
                        tree_leaves(want.opt[name])):
            tol = STEP_TOL if name == "m" else 2 * STEP_TOL
            assert float((a - w).abs().max()) \
                <= tol * max(float(w.abs().max()), 1e-30), name
    assert tree_map(lambda e: tuple(e.shape), state.error) \
        == tree_map(lambda e: tuple(e.shape), want.error)
    # the residual g - deq moves by the gradient's difference plus the
    # dequantized value's (the scale, max |g| / 127, moves with max |g|):
    # each within the gradient tolerance of the leaf's largest gradient,
    # which is 10x its first moment m after one step (b1 = 0.9)
    m = dict(tree_paths(want.opt["m"]))
    got = dict(tree_paths(state.error))
    for path, w in tree_paths(want.error):
        gmax = 10 * float(m[path].abs().max())
        assert float((got[path] - w).abs().max()) <= 2 * STEP_TOL * gmax, \
            path


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_host_batch_equals_reference(n_hosts):
    ds, jds = SyntheticLM(97, 12, seed=5), JSyntheticLM(97, 12, seed=5)
    rows = []
    for h in range(n_hosts):
        got = host_batch(ds, 3, 8, h, n_hosts)
        want = jhost_batch(jds, 3, 8, h, n_hosts)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        rows.append(got["tokens"])
    np.testing.assert_array_equal(torch.cat(rows).numpy(),
                                  ds.batch(3, 8)["tokens"].numpy())
    with pytest.raises(ValueError):
        host_batch(ds, 0, 6, 0, 4)


def test_launcher_grad_compress_flag(tmp_path):
    """``launch.train --grad-compress`` trains with an error state that
    the steps fill, and checkpoints it beside the parameters."""
    from repro_torch.launch.train import main as train_main
    state, history = train_main([
        "--arch", "granite-3-2b", "--reduce", "16", "--steps", "2",
        "--batch", "2", "--seq", "16", "--device", "cpu", "--grad-compress",
        "--ckpt-dir", str(tmp_path)])
    assert state.error is not None and history
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(state.error))
    assert any(p.name.startswith("error__") for p in
               (tmp_path / "step_2" / "proc_0").iterdir())

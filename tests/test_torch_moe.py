"""The port's mixture of experts (``models/moe.py``) against the JAX
reference, on parameters carried over by ``weights.from_jax``; inputs
from numpy with a seed.  The MoE models' training and serving are held in
``tests/test_torch_moe_model.py``, which shares this file's models and
helpers (the two files are one suite, cut in two so that two workers
share it).

Tiny qwen3-moe-235b-a22b (8 experts, top 2, qk_norm) and dbrx-132b (4
experts, top 2, LayerNorm) at the reference's ``REDUCED`` sizes
(``tests/test_models_smoke.py``), float32.  Tolerances:

* ``moe_apply``'s ``y`` within ``atol=1e-5`` and ``aux`` within ``1e-6``:
  float32 values whose router product, softmax and combine the port sums
  in float64 (the reference in float32); routing and capacity drops are
  the same integers on both sides;
* the sc_int expert products bit for bit: exact int32 sums, and the same
  float32 rescale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro_torch.configs import get_arch
from repro_torch.kernels import build, ops
from repro_torch.kernels.ref import ternary_matmul_ref
from repro_torch.models import moe
from repro_torch.tree import tree_map
from repro_torch.weights import from_jax
from port_fixtures import _one_torch_thread  # noqa: F401


COMMON = dict(dtype="float32", vocab_pad_multiple=32)
# the reference's REDUCED sizes; cf = E / k, so no token drops
REDUCED = {
    "qwen3-moe-235b-a22b": dict(n_layers=2, d_model=64, n_heads=4,
                                n_kv_heads=2, d_ff=48, vocab_size=131,
                                n_experts=8, n_experts_per_tok=2,
                                moe_group_size=16, moe_capacity_factor=4.0),
    "dbrx-132b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=96, vocab_size=131, n_experts=4,
                      n_experts_per_tok=2, moe_group_size=16,
                      moe_capacity_factor=2.0),
}
ARCHS = sorted(REDUCED)


def _cfgs(arch, mode="sc_qat", **kw):
    kw = {**COMMON, **REDUCED[arch], **kw}
    jc = jget_arch(arch).scaled(attn_q_chunk=8, **kw)
    c = get_arch(arch).scaled(**kw)
    return (jc.scaled(quant=jc.quant.with_mode(mode)),
            c.scaled(quant=c.quant.with_mode(mode)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module", params=ARCHS)
def arch_params(request):
    jc, c = _cfgs(request.param)
    jp = jinit_params(jax.random.key(0), jc)
    return request.param, jp, from_jax(_np(jp), c, device="cpu")


def _layer(jp, i):
    return jax.tree.map(lambda a: a[i], jp["periods"]["p0"])


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_from_jax_carries_router_experts_qk_norm_and_bias(arch_params):
    arch, jp, tp = arch_params
    for i, lp in enumerate(tp["layers"]):
        jl = _np(_layer(jp, i))
        f, jf = lp["ffn"], jl["ffn"]
        np.testing.assert_array_equal(f["router"].numpy(), jf["router"])
        for name in ("w_gate", "w_up", "w_down"):
            for leaf in ("w", "alpha_w", "alpha_a"):
                np.testing.assert_array_equal(f[name][leaf].numpy(),
                                              jf[name][leaf])
        assert f["w_up"]["w"].shape == (REDUCED[arch]["n_experts"], 64,
                                        REDUCED[arch]["d_ff"])
        if arch.startswith("qwen3"):
            for k in ("q_norm", "k_norm"):
                np.testing.assert_array_equal(
                    lp["mixer"][k]["scale"].numpy(),
                    jl["mixer"][k]["scale"])
        else:
            np.testing.assert_array_equal(lp["norm1"]["bias"].numpy(),
                                          jl["norm1"]["bias"])
    assert ("bias" in tp["final_norm"]) == arch.startswith("dbrx")


# ---------------------------------------------------------------------------
# moe_apply against the reference
# ---------------------------------------------------------------------------

def _drops(tp_ffn, x, cfg):
    """How many (token, slot) pairs exceed their expert's capacity."""
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    B, S, D = x.shape
    sg = min(cfg.moe_group_size, B * S)
    _, _, _, top_i = moe.route(tp_ffn["router"], x.reshape(-1, sg, D), k)
    counts = torch.nn.functional.one_hot(top_i, E).sum((1, 2))   # (G, E)
    cap = max(4, -(-int(-(-k * sg * cfg.moe_capacity_factor // E)) // 4) * 4)
    return int(torch.clamp(counts - cap, min=0).sum())


@pytest.mark.parametrize("mode", ["none", "sc_qat", "sc_int"])
@pytest.mark.parametrize("cf", ["no_drops", "drops"])
@pytest.mark.parametrize("batch_invariant", [True, False])
def test_moe_apply_matches_reference(arch_params, mode, cf, batch_invariant):
    """y and aux of one layer's MoE on 2 x 16 tokens (two groups of 16),
    at cf = E / k and at cf 0.5, where tokens drop."""
    arch, jp, tp = arch_params
    kw = {} if cf == "no_drops" else dict(moe_capacity_factor=0.5)
    jc, c = _cfgs(arch, mode, **kw)
    x = _x((2, 16, 64))
    if cf == "drops":
        assert _drops(tp["layers"][1]["ffn"], _t(x), c) > 0
    want_y, want_aux = jmoe.moe_apply(_layer(jp, 1)["ffn"], jnp.asarray(x),
                                      jc)
    y, aux = moe.moe_apply(tp["layers"][1]["ffn"], _t(x), c,
                           batch_invariant=batch_invariant)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=0,
                               atol=1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-6


def test_sc_int_expert_products_are_bit_exact(arch_params):
    """``_expert_matmul`` under sc_int: the int32 sums equal an int64 numpy
    einsum of the reference's codes, and the rescaled output equals the
    reference's ``_expert_matmul`` bit for bit."""
    arch, jp, tp = arch_params
    jc, c = _cfgs(arch, "sc_int")
    E = c.n_experts
    x = _x((E, 2, 8, 64), seed=4) * 3                        # (E, G, C, D)
    jw = _layer(jp, 0)["ffn"]["w_up"]
    want = np.asarray(jmoe._expert_matmul(jw, jnp.asarray(x), jc.quant,
                                          "egcd,edf->egcf"))
    got = moe._expert_matmul(tp["layers"][0]["ffn"]["w_up"],
                             _t(x.reshape(E, 16, 64)), c.quant)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    # the integer sums themselves
    half = c.quant.act_half
    aa = np.float32(jw["alpha_a"])
    x_q = np.clip(np.round(x / aa), -half, half).astype(np.int8)
    w_int = np.clip(np.round(np.asarray(jw["w"]) / np.asarray(jw["alpha_w"])),
                    -1, 1).astype(np.int8)
    sums = ops.ternary_matmul(_t(x_q.reshape(E, 16, 64)), _t(w_int))
    np.testing.assert_array_equal(
        sums.numpy().reshape(E, 2, 8, -1),
        np.einsum("egcd,edf->egcf", x_q.astype(np.int64),
                  w_int.astype(np.int64)))


def test_sc_int_approx_experts_keep_the_exact_accumulator(arch_params):
    """The reference's experts ignore ``int_approx``: so do the port's
    (the dense projections take the approximate adder, not the experts)."""
    arch, _, tp = arch_params
    _, c = _cfgs(arch, "sc_int")
    ca = c.scaled(quant=dataclasses.replace(c.quant, int_approx=True))
    x = _t(_x((c.n_experts, 12, 64), seed=5))
    p = tp["layers"][0]["ffn"]["w_gate"]
    build.reset_launches()
    assert torch.equal(moe._expert_matmul(p, x, ca.quant),
                       moe._expert_matmul(p, x, c.quant))
    assert build.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


# ---------------------------------------------------------------------------
# routing details
# ---------------------------------------------------------------------------

def test_top_k_ties_go_to_the_lower_expert():
    """Exact ties: all-equal logits (a zero router) and duplicated router
    columns.  ``jax.lax.top_k`` takes the lower index first; so does the
    port's stable sort, and the combined outputs agree."""
    E, k, D = 8, 3, 16
    x = _x((1, 6, D), seed=7)
    routers = [np.zeros((D, E), np.float32)]
    r = _x((D, E), seed=8)
    r[:, 5], r[:, 6] = r[:, 2], r[:, 2]          # experts 2, 5, 6 tie
    r[:, 7] = r[:, 0]                            # experts 0, 7 tie
    routers.append(r)
    firsts = []
    for router in routers:
        logits = jnp.asarray(x) @ jnp.asarray(router)
        _, want_i = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
        for bi in (True, False):
            _, _, _, top_i = moe.route(_t(router), _t(x), k,
                                       batch_invariant=bi)
            np.testing.assert_array_equal(top_i.numpy(), np.asarray(want_i))
        firsts.append(np.asarray(want_i)[0, 0].tolist())
    assert firsts[0] == [0, 1, 2]                # all tied: the lowest ids


def test_moe_apply_with_tied_router_matches_reference():
    jc, c = _cfgs("qwen3-moe-235b-a22b", "none")
    jp = jinit_params(jax.random.key(3), jc)
    jf = _layer(jp, 0)["ffn"]
    jf = dict(jf, router=jnp.zeros_like(jf["router"]))
    tf = tree_map(_t, _np(jf))
    x = _x((1, 16, 64), seed=9)
    want_y, _ = jmoe.moe_apply(jf, jnp.asarray(x), jc)
    y, _ = moe.moe_apply(tf, _t(x), c)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("e,m,k,n", [(8, 4, 64, 48), (4, 17, 96, 64),
                                     (1, 5, 33, 7)])
def test_batched_ternary_matmul_plain_equals_a_loop(e, m, k, n):
    """The batched plain version (``ternary_matmul_ref`` and the CPU side
    of ``ops.ternary_matmul``) equals a loop of single products and an
    int64 numpy product, over the full int8 range."""
    rng = np.random.default_rng(e * 100 + m)
    x = rng.integers(-128, 128, (e, m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (e, k, n)).astype(np.int8)
    x[0] = 0                                     # an empty expert
    got = ops.ternary_matmul(_t(x), _t(w))
    loop = torch.stack([ternary_matmul_ref(_t(x[i]), _t(w[i]))
                        for i in range(e)])
    assert got.dtype == torch.int32
    assert torch.equal(got, loop)
    assert torch.equal(ternary_matmul_ref(_t(x), _t(w)), loop)
    np.testing.assert_array_equal(
        got.numpy(), np.einsum("emk,ekn->emn", x.astype(np.int64),
                               w.astype(np.int64)))


def test_batched_ternary_matmul_refuses_thresholds():
    with pytest.raises(ValueError, match="one product"):
        ops.ternary_matmul(torch.zeros((2, 3, 8), dtype=torch.int8),
                           torch.zeros((2, 8, 4), dtype=torch.int8),
                           torch.zeros((4, 8), dtype=torch.int32))

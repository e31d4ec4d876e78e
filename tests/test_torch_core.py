"""The port's core numerics against the JAX reference (``repro.core``).

Same numpy inputs from a seed through both; integer outputs must match
bit for bit, float outputs within the tolerance each test states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bsn as jbsn
from repro.core import coding as jcoding
from repro.core import kv_quant as jkv
from repro.core import quant as jquant
from repro.core import residual as jresidual
from repro.core import sc_layers as jsc
from repro.kernels.approx_bsn import approx_bsn_pallas
from repro_torch.core import bsn, coding, kv_quant, quant, residual, sc_layers
from repro_torch.kernels.approx_bsn import approx_bsn_plain, validate_stages
from repro_torch.kernels.dispatch import approx_bsn


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# coding / residual / quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bsl", [2, 8, 16, 254])
def test_quantize_levels_bit_exact(bsl):
    rng = np.random.default_rng(bsl)
    x = (rng.standard_normal(4096) * bsl / 3).astype(np.float32)
    # exact .5 ties must round half to even on both sides
    x[:64] = np.arange(64, dtype=np.float32) - 31.5
    alpha = np.float32(0.75)
    want = np.asarray(jcoding.quantize_levels(jnp.asarray(x), alpha, bsl))
    got = coding.quantize_levels(_t(x), alpha, bsl).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [-3, -1, 0, 2])
def test_rescale_and_residual_add_bit_exact(n):
    rng = np.random.default_rng(7)
    v = rng.integers(-100, 100, 1000).astype(np.int32)
    c = rng.integers(-50, 50, 1000).astype(np.int32)
    np.testing.assert_array_equal(
        residual.rescale_q(_t(v), n).numpy(),
        np.asarray(jresidual.rescale_q(jnp.asarray(v), n)))
    np.testing.assert_array_equal(
        residual.residual_add_q(_t(c), _t(v), n).numpy(),
        np.asarray(jresidual.residual_add_q(jnp.asarray(c), jnp.asarray(v),
                                            n)))


def test_fake_quant_forward_matches():
    """lsq forward, ternary weights, thermometer activations: float32
    outputs agree exactly (same elementwise ops in the same order)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    a = np.float32(0.37)
    aw = (np.abs(rng.standard_normal(32)) * 0.5 + 0.1).astype(np.float32)
    pairs = [
        (quant.lsq_fake_quant(_t(x), _t(a), -8, 8),
         jquant.lsq_fake_quant(jnp.asarray(x), jnp.asarray(a), -8, 8)),
        (quant.ternary_weight_quant(_t(x), _t(aw)),
         jquant.ternary_weight_quant(jnp.asarray(x), jnp.asarray(aw))),
        (quant.thermometer_act_quant(_t(x), _t(a), 8),
         jquant.thermometer_act_quant(jnp.asarray(x), jnp.asarray(a), 8)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lsq_casts_alpha_to_x_dtype():
    """The reference's rule: alpha is cast to x.dtype before the divide."""
    x = torch.tensor([0.3, -1.7, 2.2], dtype=torch.bfloat16)
    out = quant.lsq_fake_quant(x, torch.tensor(0.37), -8, 8)
    assert out.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# KV formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["int8", "sc"])
def test_kv_quant_bit_exact(fmt):
    """Codes, scales and residuals equal the reference's (run op by op:
    XLA's compiled division by a literal 127 rounds differently, see
    ROADMAP Queue 3), and the dequant agrees exactly."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((6, 4, 3, 16)) * 2).astype(np.float32)
    x[0, 0, 0] = 0.0                               # all-zero head vector
    want = jkv.kv_quant(jnp.asarray(x), fmt)
    got = kv_quant.kv_quant(_t(x), fmt)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    deq = kv_quant.kv_dequant(got["q"], got["scale"], got.get("resid"),
                              fmt=fmt)
    jdeq = jkv.kv_dequant(want["q"], want["scale"], want.get("resid"),
                          fmt=fmt)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    assert float(deq[0, 0, 0].abs().max()) == 0.0


def test_kv_format_of_and_check():
    assert kv_quant.kv_format_of({"k_pages": 0}) == "fp"
    assert kv_quant.kv_format_of({"k_scale": 0}) == "int8"
    assert kv_quant.kv_format_of({"k_scale": 0, "k_resid": 0}) == "sc"
    with pytest.raises(ValueError):
        kv_quant.check_kv_format("fp8")


# ---------------------------------------------------------------------------
# approximate BSN: oracle, plain kernel version, specs
# ---------------------------------------------------------------------------

def _jspec(spec):
    return jbsn.ApproxBSNSpec(
        width=spec.width, in_bsl=spec.in_bsl,
        stages=tuple(jbsn.StageSpec(s.group, jbsn.SubSampleSpec(
            s.sub.clip, s.sub.stride)) for s in spec.stages))


SPECS = [
    bsn.default_approx_spec(256, 8),
    bsn.default_approx_spec(2048, 8),
    bsn.default_approx_spec(48, 2),                 # stride 1
    # multi-stage, with a non-power-of-two stride in the middle
    bsn.ApproxBSNSpec(width=128, in_bsl=8, stages=(
        bsn.StageSpec(8, bsn.SubSampleSpec(2, 4)),
        bsn.StageSpec(4, bsn.SubSampleSpec(3, 3)),
        bsn.StageSpec(4, bsn.SubSampleSpec(0, 2)))),
]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"w{s.width}"
                         f"_{len(s.stages)}st")
def test_approx_bsn_bit_exact_against_reference(spec):
    """approx_bsn_plain and approx_bsn_counts == the reference's oracle
    and its Pallas kernel in interpret mode, bit for bit."""
    rng = np.random.default_rng(spec.width)
    counts = rng.integers(0, spec.in_bsl + 1, (64, spec.width)) \
        .astype(np.int32)
    stages = bsn.spec_stages(spec)
    want = np.asarray(jbsn.approx_bsn_counts(jnp.asarray(counts),
                                             _jspec(spec)))
    kern = np.asarray(approx_bsn_pallas(jnp.asarray(counts),
                                        in_bsl=spec.in_bsl, stages=stages,
                                        block_r=64, interpret=True))
    np.testing.assert_array_equal(kern, want)
    np.testing.assert_array_equal(
        approx_bsn_plain(_t(counts), in_bsl=spec.in_bsl,
                         stages=stages).numpy(), want)
    np.testing.assert_array_equal(
        bsn.approx_bsn_counts(_t(counts), spec).numpy(), want)
    assert validate_stages(spec.width, spec.in_bsl, stages) == spec.out_bsl
    # dispatch keeps any leading batch shape
    got = approx_bsn(_t(counts).reshape(4, 16, spec.width), spec)
    np.testing.assert_array_equal(got.reshape(-1).numpy(), want)


@pytest.mark.parametrize("width,in_bsl", [(16, 2), (48, 2), (256, 8),
                                          (2048, 8), (8192, 8), (33, 3)])
def test_default_approx_spec_matches_reference(width, in_bsl):
    spec = bsn.default_approx_spec(width, in_bsl)
    ref = jbsn.default_approx_spec(width, in_bsl)
    assert bsn.spec_stages(spec) == tuple(
        (s.group, s.sub.clip, s.sub.stride) for s in ref.stages)
    assert (spec.out_bsl, spec.scale) == (ref.out_bsl, ref.scale)


def test_validate_stages_rejects_bad_specs():
    with pytest.raises(ValueError):
        validate_stages(16, 8, ((3, 0, 1),))            # group !| width
    with pytest.raises(ValueError):
        validate_stages(16, 8, ((16, 0, 3),))           # stride !| kept
    with pytest.raises(ValueError):
        validate_stages(16, 8, ((4, 0, 1),))            # prod != width


# ---------------------------------------------------------------------------
# SC layers
# ---------------------------------------------------------------------------

def _int_case(seed, K=64, N=24, M=5, half=4):
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-half, half + 1, (M, K)).astype(np.int8)
    w_int = rng.integers(-1, 2, (K, N)).astype(np.int8)
    return x_q, w_int


def _si(rng, K, N, half=4, out_bsl=8):
    t = np.sort(rng.integers(0, 2 * K * half, (N, out_bsl)), axis=-1)
    return {"thresholds": t.astype(np.int32), "sum_max": K * half}


@pytest.mark.parametrize("with_si", [False, True])
def test_sc_linear_int_bit_exact(with_si):
    x_q, w_int = _int_case(1)
    extra = _si(np.random.default_rng(2), 64, 24) if with_si else {}
    want = np.asarray(jsc.sc_linear_int(
        {"w_int": jnp.asarray(w_int), **extra}, jnp.asarray(x_q)))
    got = sc_layers.sc_linear_int({"w_int": _t(w_int), **extra}, _t(x_q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("with_si", [False, True])
def test_sc_linear_int_approx_bit_exact(with_si, monkeypatch):
    """q-domain sums through the approximate adder, with the counts
    formed one row block at a time (a tiny budget forces 1-row blocks)."""
    x_q, w_int = _int_case(3, K=256, N=16, M=6)
    extra = _si(np.random.default_rng(4), 256, 16) if with_si else {}
    with_jax = np.asarray(jsc.sc_linear_int_approx(
        {"w_int": jnp.asarray(w_int), **extra}, jnp.asarray(x_q), 8,
        backend="reference"))
    params = {"w_int": _t(w_int), **extra}
    got = sc_layers.sc_linear_int_approx(params, _t(x_q), 8)
    np.testing.assert_array_equal(got.numpy(), with_jax)
    monkeypatch.setattr(sc_layers, "COUNTS_BUDGET_BYTES", 4 * 16 * 256)
    blocked = sc_layers.sc_linear_int_approx(params, _t(x_q), 8)
    np.testing.assert_array_equal(blocked.numpy(), with_jax)


@pytest.mark.parametrize("int_approx", [False, True])
def test_sc_linear_int_from_qat_matches(int_approx):
    """float32 outputs: the integer sums are exact on both sides and the
    rescale is the same elementwise product, so they agree exactly."""
    rng = np.random.default_rng(9)
    K, N = 128, 12
    params = {"w": (rng.standard_normal((K, N)) / np.sqrt(K))
              .astype(np.float32),
              "alpha_w": np.full((N,), 1.4 / np.sqrt(K) * 0.8, np.float32),
              "alpha_a": np.float32(1.0)}
    x = rng.standard_normal((3, 5, K)).astype(np.float32)
    cfg_t = sc_layers.SCQuantConfig(mode="sc_int", int_approx=int_approx)
    cfg_j = jsc.SCQuantConfig(mode="sc_int", int_approx=int_approx)
    want = np.asarray(jsc.sc_linear_int_from_qat(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        cfg_j, backend="reference"))
    got = sc_layers.sc_linear_int_from_qat(
        {k: _t(v) for k, v in params.items()}, _t(x), cfg_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)

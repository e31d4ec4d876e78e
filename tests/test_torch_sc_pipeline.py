"""The port's SC integer datapath against the JAX reference, end to end.

Thermometer coding, the ternary multiplier, the SI threshold design and
its application, the exact and approximate BSN circuits, the temporal
adder, the integer layers and their export, and the kernels' front doors
(``ops.ternary_matmul``, ``ops.bsn_sort``, ``dispatch.approx_bsn``) run
on the same seeded numpy inputs through ``repro`` and ``repro_torch``.
Integer results (bits, counts, sums, SI codes, sorted rows, thresholds,
exported weights) must be equal bit for bit; the reference's Pallas
kernels run in interpret mode.  Float results: the QAT view against the
integer path within ``atol=rtol=1e-5`` (the reference's own tolerance),
the TNN's float32 logits within ``atol=1e-5``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bsn as jbsn
from repro.core import coding as jcoding
from repro.core import multiplier as jmult
from repro.core import quant as jquant
from repro.core import sc_layers as jsc
from repro.core import si as jsi
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bsn_sort import bsn_sort_pallas
from repro_torch.core import bsn, coding, multiplier, quant, sc_layers, si
from repro_torch.kernels import build, dispatch, ops, ref
from repro_torch.kernels.approx_bsn import approx_bsn_temporal_plain
from repro_torch.kernels.bsn_sort import bsn_sort_plain
from repro_torch.weights import tree_to_torch
from port_fixtures import _one_torch_thread  # noqa: F401


ACT_BSL = 8
# the reference's Pallas matmul at small blocks, so interpret mode is fast
JMM = dict(min_flops_for_kernel=0, block_m=8, block_n=8, block_k=8)
# blocks that divide the largest aligned case (256 x 2048 x 512): 128 grid
# steps in interpret mode where JMM's 8-wide blocks take 524 288
JMM_ALIGNED = dict(min_flops_for_kernel=0, block_m=64, block_n=128,
                   block_k=256)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _n(x):
    return np.asarray(x)


def _jspec(spec):
    return jbsn.ApproxBSNSpec(
        width=spec.width, in_bsl=spec.in_bsl,
        stages=tuple(jbsn.StageSpec(s.group, jbsn.SubSampleSpec(
            s.sub.clip, s.sub.stride)) for s in spec.stages))


# ---------------------------------------------------------------------------
# coding and the multiplier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bsl", [2, 4, 8, 16])
def test_thermometer_coding_bit_exact(bsl):
    rng = np.random.default_rng(bsl)
    half = bsl // 2
    # levels past the rails saturate on both sides
    x_q = rng.integers(-half - 2, half + 3, (7, 33)).astype(np.int32)
    bits = coding.encode_thermometer(_t(x_q), bsl)
    jbits = jcoding.encode_thermometer(jnp.asarray(x_q), bsl)
    assert bits.dtype == torch.int8
    np.testing.assert_array_equal(bits.numpy(), _n(jbits))
    np.testing.assert_array_equal(coding.counts_from_bits(bits).numpy(),
                                  _n(jcoding.counts_from_bits(jbits)))
    np.testing.assert_array_equal(coding.decode_thermometer(bits).numpy(),
                                  _n(jcoding.decode_thermometer(jbits)))
    np.testing.assert_array_equal(coding.negate_bits(bits).numpy(),
                                  _n(jcoding.negate_bits(jbits)))
    np.testing.assert_array_equal(coding.zero_code(bsl, (3,)).numpy(),
                                  _n(jcoding.zero_code(bsl, (3,))))
    alpha = np.float32(0.37)
    np.testing.assert_array_equal(
        coding.dequantize_levels(_t(x_q), alpha).numpy(),
        _n(jcoding.dequantize_levels(jnp.asarray(x_q), alpha)))
    noisy = bits.numpy().copy()
    noisy[0, :, 0] = 0                  # a 0 before 1s: not thermometer
    noisy[1, :, -1] = 2                 # not binary
    np.testing.assert_array_equal(coding.is_thermometer(_t(noisy)).numpy(),
                                  jcoding.is_thermometer(noisy))
    if bsl in coding.THERMOMETER_TABLE:
        assert coding.THERMOMETER_TABLE[bsl] == \
            jcoding.THERMOMETER_TABLE[bsl]


def test_ternary_multiplier_bit_exact():
    codes = np.array([[0, 0], [1, 0], [1, 1]], np.int8)     # -1, 0, +1
    a = np.repeat(codes, 3, axis=0)
    w = np.tile(codes, (3, 1))
    np.testing.assert_array_equal(
        multiplier.ternary_mul_bits(_t(a), _t(w)).numpy(),
        _n(jmult.ternary_mul_bits(jnp.asarray(a), jnp.asarray(w))))
    rng = np.random.default_rng(0)
    a_q = rng.integers(-4, 5, (5, 12)).astype(np.int8)
    w_q = rng.integers(-1, 2, (5, 12)).astype(np.int8)
    np.testing.assert_array_equal(
        multiplier.ternary_mul_q(_t(a_q), _t(w_q)).numpy(),
        _n(jmult.ternary_mul_q(jnp.asarray(a_q), jnp.asarray(w_q))))
    bits = jcoding.encode_thermometer(jnp.asarray(a_q), ACT_BSL)
    got = multiplier.ternary_scale_bits(_t(w_q), _t(_n(bits)))
    np.testing.assert_array_equal(
        got.numpy(), _n(jmult.ternary_scale_bits(jnp.asarray(w_q), bits)))
    # the multiplier in the bit domain is the product in the q domain
    np.testing.assert_array_equal(coding.decode_thermometer(got).numpy(),
                                  a_q.astype(np.int32) * w_q)
    with pytest.raises(ValueError):
        multiplier.ternary_mul_bits(_t(a[:, :1]), _t(w))


# ---------------------------------------------------------------------------
# selective interconnect
# ---------------------------------------------------------------------------

ACTS = {
    "relu": si.relu_fn, "identity": si.identity_fn, "relu2": si.relu2_fn,
    "bn_relu": si.bn_relu_fn(1.5, 0.1), "tanh": si.tanh_fn(0.7),
    "gelu_mono": si.gelu_mono_fn, "silu_mono": si.silu_mono_fn,
}
JACTS = {
    "relu": jsi.relu_fn, "identity": jsi.identity_fn, "relu2": jsi.relu2_fn,
    "bn_relu": jsi.bn_relu_fn(1.5, 0.1), "tanh": jsi.tanh_fn(0.7),
    "gelu_mono": jsi.gelu_mono_fn, "silu_mono": jsi.silu_mono_fn,
}


@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("in_max,out_bsl", [(64, 8), (512, 16), (33, 5)])
def test_si_thresholds_equal(act, in_max, out_bsl):
    kw = dict(alpha_in=0.013, alpha_out=0.11)
    got = si.si_thresholds(ACTS[act], in_max, out_bsl, **kw)
    want = jsi.si_thresholds(JACTS[act], in_max, out_bsl, **kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_si_application_bit_exact():
    rng = np.random.default_rng(5)
    in_max, out_bsl = 64, 8
    oc = np.maximum.accumulate(rng.integers(0, out_bsl + 1, in_max + 1))
    t = si.si_thresholds_from_counts(oc, out_bsl)
    np.testing.assert_array_equal(
        t, jsi.si_thresholds_from_counts(oc, out_bsl))
    c = rng.integers(0, in_max + 1, (9, 4)).astype(np.int32)
    got = si.apply_si_counts(_t(c), t)
    np.testing.assert_array_equal(
        got.numpy(), _n(jsi.apply_si_counts(jnp.asarray(c), jnp.asarray(t))))
    np.testing.assert_array_equal(got.numpy(), oc[c])   # the table itself
    # the wiring form on sorted thermometer codes, rails included
    sorted_bits = _n(jcoding.encode_thermometer(
        jnp.asarray(c - in_max // 2), in_max))
    t_rails = np.array([0, 1, 5, 64, 65, 65, 70, 3], np.int32)
    for table in (t, t_rails):
        np.testing.assert_array_equal(
            si.apply_si_bits(_t(sorted_bits), table).numpy(),
            _n(jsi.apply_si_bits(jnp.asarray(sorted_bits),
                                 jnp.asarray(table))))
    with pytest.raises(ValueError, match="monotone"):
        si.si_thresholds_from_counts(np.array([0, 2, 1]), 4)
    with pytest.raises(ValueError, match="gamma"):
        si.bn_relu_fn(-1.0, 0.0)


# ---------------------------------------------------------------------------
# BSN circuits and the temporal adder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int8", "int32", "float32"])
@pytest.mark.parametrize("length", [16, 13])
@pytest.mark.parametrize("descending", [True, False])
def test_bitonic_sort_bit_exact(dtype, length, descending):
    rng = np.random.default_rng(length)
    x = (rng.standard_normal((6, length)) * 50).astype(dtype)
    got = bsn.bitonic_sort(_t(x), descending=descending)
    want = jbsn.bitonic_sort(jnp.asarray(x), descending=descending)
    np.testing.assert_array_equal(got.numpy(), _n(want))


def test_exact_bsn_bits_is_the_sum():
    rng = np.random.default_rng(1)
    x_q = rng.integers(-4, 5, (3, 6)).astype(np.int32)
    bits = _n(jcoding.encode_thermometer(jnp.asarray(x_q), ACT_BSL))
    got = bsn.exact_bsn_bits(_t(bits))
    np.testing.assert_array_equal(got.numpy(),
                                  _n(jbsn.exact_bsn_bits(jnp.asarray(bits))))
    assert bool(coding.is_thermometer(got).all())
    counts = x_q + ACT_BSL // 2
    np.testing.assert_array_equal(coding.counts_from_bits(got).numpy(),
                                  bsn.exact_bsn_counts(_t(counts)).numpy())
    np.testing.assert_array_equal(
        bsn.exact_bsn_counts(_t(counts), axis=0).numpy(),
        _n(jbsn.exact_bsn_counts(jnp.asarray(counts), axis=0)))


APPROX_SPECS = [
    bsn.default_approx_spec(16, 8),
    bsn.ApproxBSNSpec(width=16, in_bsl=4, stages=(
        bsn.StageSpec(4, bsn.SubSampleSpec(2, 4)),
        bsn.StageSpec(4, bsn.SubSampleSpec(1, 2)))),
]


@pytest.mark.parametrize("spec", APPROX_SPECS,
                         ids=lambda s: f"{len(s.stages)}st")
def test_approx_bsn_bits_bit_exact(spec):
    """The wire-tapping circuit equals the reference's, and its popcount
    equals the count-domain oracle."""
    rng = np.random.default_rng(spec.in_bsl)
    half = spec.in_bsl // 2
    x_q = rng.integers(-half, half + 1, (5, spec.width)).astype(np.int32)
    bits = _n(jcoding.encode_thermometer(jnp.asarray(x_q), spec.in_bsl))
    got = bsn.approx_bsn_bits(_t(bits), spec)
    np.testing.assert_array_equal(
        got.numpy(), _n(jbsn.approx_bsn_bits(jnp.asarray(bits),
                                             _jspec(spec))))
    np.testing.assert_array_equal(
        coding.counts_from_bits(got).numpy(),
        bsn.approx_bsn_counts(_t(x_q + half), spec).numpy())
    with pytest.raises(ValueError):
        bsn.approx_bsn_bits(_t(bits[:, :-1]), spec)


@pytest.mark.parametrize("width,cycles", [(16, 2), (32, 8), (256, 4)])
def test_temporal_adder_bit_exact_against_pallas(width, cycles):
    """``dispatch.approx_bsn(cycles=T)`` (the temporal kernel's plain
    version on the CPU), the front door and ``spatial_temporal_counts``
    equal the reference's temporal Pallas kernel in interpret mode."""
    spec = bsn.default_approx_spec(width, ACT_BSL)
    rng = np.random.default_rng(width + cycles)
    counts = rng.integers(0, ACT_BSL + 1, (3, 7, cycles * width)) \
        .astype(np.int32)
    want = _n(jdispatch.approx_bsn(jnp.asarray(counts), _jspec(spec),
                                   cycles=cycles,
                                   backend="pallas-interpret"))
    build.reset_launches()
    got = dispatch.approx_bsn(_t(counts), spec, cycles=cycles)
    assert got.shape == (3, 7) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        bsn.approx_bsn(_t(counts), spec, cycles=cycles).numpy(), want)
    np.testing.assert_array_equal(
        bsn.spatial_temporal_counts(_t(counts), spec, cycles).numpy(),
        _n(jbsn.spatial_temporal_counts(jnp.asarray(counts), _jspec(spec),
                                        cycles)))
    np.testing.assert_array_equal(
        approx_bsn_temporal_plain(_t(counts.reshape(21, -1)),
                                  in_bsl=ACT_BSL,
                                  stages=bsn.spec_stages(spec),
                                  cycles=cycles).numpy(), want.reshape(-1))
    assert build.LAUNCHES == dict.fromkeys(build.KERNELS, 0)
    with pytest.raises(ValueError, match="cycles"):
        dispatch.approx_bsn(_t(counts), spec, cycles=cycles + 1)


# ---------------------------------------------------------------------------
# the kernels' front doors
# ---------------------------------------------------------------------------

def _si_table(rng, n, k, out_bsl):
    t = np.sort(rng.integers(-k * 2, k * 2, (n, out_bsl)), axis=-1)
    return t.astype(np.int32)


@pytest.mark.parametrize("m,k,n", [(4, 1001, 1003), (16, 62, 10),
                                   (17, 1001, 1003), (64, 784, 10),
                                   (256, 2048, 512)])
@pytest.mark.parametrize("with_si", [False, True])
def test_ternary_matmul_operands_padded_for_each_kernel(m, k, n, with_si):
    """On the card ``ops.ternary_matmul`` pads K and N to the multiple the
    kernel for M rows reads (4 for dp4a up to 16 rows, 16 for the tensor
    cores above): the padded operands through the plain version, cropped,
    equal the reference's Pallas kernel on the unpadded ones, and aligned
    operands come back as they are (no copy)."""
    from repro_torch.kernels.ternary_matmul import operand_multiple
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-1, 2, (k, n)).astype(np.int8)
    t = _si_table(rng, n, k, 8) if with_si else None
    mult = operand_multiple(m)
    assert mult == (4 if m <= 16 else 16)
    xt, wt, tt = _t(x), _t(w), None if t is None else _t(t)
    xp, wp, tp = ops.pad_operands(xt, wt, tt, mult)
    assert xp.shape[1] % mult == 0 and wp.shape[1] % mult == 0
    assert wp.shape[0] == xp.shape[1]
    if k % mult == 0 and n % mult == 0:
        assert xp is xt and wp is wt and tp is tt
    got = ref.ternary_matmul_ref(xp, wp, tp)[:, :n]
    blocks = JMM_ALIGNED if (m, k, n) == (256, 2048, 512) else JMM
    want = _n(jops.ternary_matmul(
        jnp.asarray(x), jnp.asarray(w),
        None if t is None else jnp.asarray(t), **blocks))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(13, 70, 37), (4, 64, 32), (1, 9, 5),
                                   ((2, 3), 21, 11), ((), 33, 6)],
                         ids=str)
@pytest.mark.parametrize("with_si", [False, True])
def test_ternary_matmul_bit_exact_against_pallas(shape, with_si):
    """Ragged and batched shapes, with and without the fused SI epilogue:
    the port's ``ops.ternary_matmul`` (the plain version on the CPU) equals
    the reference's Pallas kernel in interpret mode."""
    batch, k, n = shape
    batch = batch if isinstance(batch, tuple) else (batch,)
    rng = np.random.default_rng(k * n)
    x = rng.integers(-4, 5, (*batch, k)).astype(np.int8)
    w = rng.integers(-1, 2, (k, n)).astype(np.int8)
    t = _si_table(rng, n, k, 8) if with_si else None
    want = _n(jops.ternary_matmul(
        jnp.asarray(x), jnp.asarray(w),
        None if t is None else jnp.asarray(t), **JMM))
    got = ops.ternary_matmul(_t(x), _t(w), None if t is None else _t(t))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.ternary_matmul_ref(_t(x), _t(w),
                               None if t is None else _t(t)).numpy(),
        _n(jref.ternary_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                   None if t is None else jnp.asarray(t))))


def test_si_epilogue_ref_bit_exact():
    rng = np.random.default_rng(2)
    sums = rng.integers(-60, 60, (5, 6)).astype(np.int32)
    t = _si_table(rng, 6, 16, 12)
    np.testing.assert_array_equal(
        ref.si_epilogue_ref(_t(sums), _t(t)).numpy(),
        _n(jref.si_epilogue_ref(jnp.asarray(sums), jnp.asarray(t))))


@pytest.mark.parametrize("dtype", ["int8", "int32", "float32"])
@pytest.mark.parametrize("length", [2, 64, 256])
def test_bsn_sort_bit_exact_against_pallas(dtype, length):
    """The port's network on power-of-two rows of any values equals the
    reference's Pallas sort in interpret mode, and ``ops.bsn_sort`` the
    reference's ``ops.bsn_sort``."""
    rng = np.random.default_rng(length)
    x = (rng.standard_normal((16, length)) * 40).astype(dtype)
    want = _n(bsn_sort_pallas(jnp.asarray(x), block_r=8, interpret=True))
    np.testing.assert_array_equal(bsn_sort_plain(_t(x)).numpy(), want)
    np.testing.assert_array_equal(ops.bsn_sort(_t(x)).numpy(), want)
    np.testing.assert_array_equal(ref.bsn_sort_ref(_t(x)).numpy(),
                                  _n(jref.bsn_sort_ref(jnp.asarray(x))))
    asc = _n(bsn_sort_pallas(jnp.asarray(x), descending=False, block_r=8,
                             interpret=True))
    np.testing.assert_array_equal(
        bsn_sort_plain(_t(x), descending=False).numpy(), asc)


@pytest.mark.parametrize("length", [3, 100, 255])
def test_bsn_sort_zero_pads_like_the_reference(length):
    """Non-power-of-two rows are padded with zeros and cropped: bit rows
    keep their popcount, and signed rows give the reference's (unsorted)
    result, not a repaired one."""
    rng = np.random.default_rng(length)
    bits = rng.integers(0, 2, (2, 5, length)).astype(np.int8)
    want = _n(jops.bsn_sort(jnp.asarray(bits), block_r=8,
                            min_rows_for_kernel=0))
    got = ops.bsn_sort(_t(bits))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().sum(-1), bits.sum(-1))
    signed = rng.integers(-5, 6, (9, length)).astype(np.int32)
    np.testing.assert_array_equal(
        ops.bsn_sort(_t(signed)).numpy(),
        _n(jops.bsn_sort(jnp.asarray(signed), block_r=8,
                         min_rows_for_kernel=0)))
    one = rng.integers(0, 2, (length,)).astype(np.int8)
    np.testing.assert_array_equal(ops.bsn_sort(_t(one)).numpy(),
                                  _n(jref.bsn_sort_ref(jnp.asarray(one))))


# ---------------------------------------------------------------------------
# SC layers: init, QAT view, export, integer paths
# ---------------------------------------------------------------------------

def _qat_params(rng, k, n, per_channel=True):
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    aw = (np.maximum(1.4 * np.abs(w).mean(0), 1e-8) if per_channel
          else np.float32(1.4 * np.abs(w).mean())).astype(np.float32)
    return {"w": w, "alpha_w": aw, "alpha_a": np.float32(0.5)}


def test_init_sc_linear_shapes_and_scales():
    cfg = sc_layers.SCQuantConfig(mode="sc_qat")
    gen = torch.Generator().manual_seed(0)
    p = sc_layers.init_sc_linear(gen, 48, 24, cfg, device="cpu")
    jp = jsc.init_sc_linear(__import__("jax").random.key(0), 48, 24,
                            jsc.SCQuantConfig(mode="sc_qat"))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in p.values())
    # the scales follow the reference's formulas on the port's own w
    w = jnp.asarray(p["w"].numpy())
    np.testing.assert_allclose(
        p["alpha_w"].numpy(),
        _n(jnp.maximum(1.4 * jnp.mean(jnp.abs(w), axis=0), 1e-8)),
        rtol=1e-6)
    assert float(p["alpha_a"]) == pytest.approx(float(jp["alpha_a"]))
    flat = sc_layers.init_sc_linear(
        gen, 48, 24, sc_layers.SCQuantConfig(mode="sc_qat",
                                             per_channel=False),
        device="cpu")
    assert flat["alpha_w"].shape == ()
    np.testing.assert_allclose(
        flat["alpha_w"].numpy(),
        _n(jquant.ternary_weight_init_alpha(jnp.asarray(flat["w"].numpy()))),
        rtol=1e-6)
    assert set(sc_layers.init_sc_linear(gen, 4, 4, sc_layers.SC_OFF,
                                        device="cpu")) == {"w"}


@pytest.mark.parametrize("mode", ["none", "sc_qat"])
def test_sc_linear_qat_and_residual_quant_match(mode):
    rng = np.random.default_rng(3)
    params = _qat_params(rng, 32, 8)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    r = rng.standard_normal((5, 8)).astype(np.float32)
    cfg, jcfg = (sc_layers.SCQuantConfig(mode=mode),
                 jsc.SCQuantConfig(mode=mode))
    got = sc_layers.sc_linear_qat(tree_to_torch(params, "cpu"), _t(x), cfg)
    want = jsc.sc_linear_qat({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), _n(want), rtol=1e-5, atol=1e-6)
    alpha_r = np.float32(0.1)
    np.testing.assert_array_equal(
        sc_layers.sc_residual_quant(_t(r), _t(alpha_r), cfg).numpy(),
        _n(jsc.sc_residual_quant(jnp.asarray(r), jnp.asarray(alpha_r),
                                 jcfg)))


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("with_si", [False, True])
def test_export_sc_linear_every_field_equal(per_channel, with_si):
    rng = np.random.default_rng(4)
    params = _qat_params(rng, 40, 12, per_channel)
    cfg = sc_layers.SCQuantConfig(mode="sc_int")
    kw = dict(act_fn=si.bn_relu_fn(1.2, 0.05), out_bsl=8, alpha_out=0.4) \
        if with_si else {}
    jkw = dict(act_fn=jsi.bn_relu_fn(1.2, 0.05), out_bsl=8,
               alpha_out=0.4) if with_si else {}
    got = sc_layers.export_sc_linear(tree_to_torch(params, "cpu"), cfg, **kw)
    want = jsc.export_sc_linear(params, jsc.SCQuantConfig(mode="sc_int"),
                                **jkw)
    assert set(got) == set(want)
    for key, v in want.items():
        g = got[key]
        if isinstance(g, torch.Tensor):
            assert g.numpy().dtype == np.asarray(v).dtype, key
            np.testing.assert_array_equal(g.numpy(), np.asarray(v))
        else:
            assert g == v, key


@pytest.mark.parametrize("per_channel", [True, False])
def test_sc_linear_int_with_exported_si_equals_reference(per_channel):
    """The fused-SI kernel path (``t - sum_max`` broadcast to (N, out_bsl))
    gives the reference's codes, and the unfused epilogue's."""
    rng = np.random.default_rng(6)
    params = _qat_params(rng, 48, 20, per_channel)
    cfg = sc_layers.SCQuantConfig(mode="sc_int")
    exp = sc_layers.export_sc_linear(tree_to_torch(params, "cpu"), cfg,
                                     act_fn=si.relu_fn, out_bsl=8,
                                     alpha_out=0.5)
    jexp = jsc.export_sc_linear(params, jsc.SCQuantConfig(mode="sc_int"),
                                act_fn=jsi.relu_fn, out_bsl=8, alpha_out=0.5)
    x_q = rng.integers(-4, 5, (3, 5, 48)).astype(np.int8)
    got = sc_layers.sc_linear_int(exp, _t(x_q))
    want = _n(jsc.sc_linear_int(jexp, jnp.asarray(x_q)))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = {"w_int": exp["w_int"]}
    unfused = sc_layers._si_epilogue(exp, sc_layers.sc_linear_int(
        plain, _t(x_q)))
    np.testing.assert_array_equal(unfused.numpy(), want)


@pytest.mark.parametrize("cycles", [2, 4])
@pytest.mark.parametrize("with_si", [False, True])
def test_sc_linear_int_approx_temporal_bit_exact(cycles, with_si):
    rng = np.random.default_rng(cycles)
    k, n = 256, 12
    x_q = rng.integers(-4, 5, (2, 3, k)).astype(np.int8)
    w = rng.integers(-1, 2, (k, n)).astype(np.int8)
    extra = {}
    if with_si:
        t = np.sort(rng.integers(0, 2 * k * 4, (n, 8)), axis=-1)
        extra = {"thresholds": t.astype(np.int32), "sum_max": k * 4}
    want = _n(jsc.sc_linear_int_approx(
        {"w_int": jnp.asarray(w), **extra}, jnp.asarray(x_q), ACT_BSL,
        cycles=cycles, backend="pallas-interpret"))
    got = sc_layers.sc_linear_int_approx({"w_int": _t(w), **extra},
                                         _t(x_q), ACT_BSL, cycles=cycles)
    np.testing.assert_array_equal(got.numpy(), want)
    # a degenerate spec (no clip, stride 1) is the exact adder
    exact = bsn.ApproxBSNSpec(width=k // cycles, in_bsl=ACT_BSL,
                              stages=(bsn.StageSpec(k // cycles),))
    np.testing.assert_array_equal(
        sc_layers.sc_linear_int_approx({"w_int": _t(w), **extra}, _t(x_q),
                                       ACT_BSL, exact, cycles=cycles)
        .numpy(),
        sc_layers.sc_linear_int({"w_int": _t(w), **extra}, _t(x_q)).numpy())
    with pytest.raises(ValueError, match="K="):
        sc_layers.sc_linear_int_approx({"w_int": _t(w)}, _t(x_q), ACT_BSL,
                                       exact, cycles=cycles + 1)


def test_tree_to_torch_carries_numpy_trees():
    tree = {"w_in": np.ones((3, 2), np.float32),
            "blocks": [{"w_int": np.ones((2, 2), np.int8), "alpha_a": 0.5,
                        "thresholds": None, "sum_max": 8,
                        "alpha_w": np.float32(0.05)}]}
    out = tree_to_torch(tree, "cpu")
    assert out["w_in"].dtype == torch.float32
    blk = out["blocks"][0]
    assert blk["w_int"].dtype == torch.int8
    assert blk["alpha_w"].shape == () and blk["alpha_w"].dtype == \
        torch.float32
    assert (blk["alpha_a"], blk["thresholds"], blk["sum_max"]) == \
        (0.5, None, 8)


# ---------------------------------------------------------------------------
# end to end: the paper's pipeline, float -> silicon, and the TNN
# ---------------------------------------------------------------------------

def test_end_to_end_sc_pipeline():
    """Port of the reference's ``test_end_to_end_sc_pipeline``: the QAT
    view equals the integer datapath, the kernel path equals the plain
    one, the bit-level circuit equals the integer sum, and the SI
    epilogue agrees on all three paths; every integer also equals the
    reference's."""
    rng = np.random.default_rng(0)
    din, dout, batch = 32, 8, 16
    out_bsl = 16
    alpha_a, alpha_w = 0.25, 0.05
    w_np = rng.normal(0, 0.05, (din, dout)).astype(np.float32)
    x_np = rng.normal(0, 0.5, (batch, din)).astype(np.float32)
    w, x = _t(w_np), _t(x_np)

    # 1. QAT view
    x_fq = quant.lsq_fake_quant(x, torch.tensor(alpha_a), -ACT_BSL // 2,
                                ACT_BSL // 2)
    w_fq = quant.lsq_fake_quant(w, torch.tensor(alpha_w), -1, 1)
    y_qat = x_fq @ w_fq

    # 2. integer datapath
    x_q = coding.quantize_levels(x, alpha_a, ACT_BSL).to(torch.int8)
    w_int = torch.clamp(torch.round(w / alpha_w), -1, 1).to(torch.int8)
    sum_q = ref.ternary_matmul_ref(x_q, w_int)
    np.testing.assert_allclose(y_qat.numpy(),
                               sum_q.numpy() * alpha_a * alpha_w,
                               rtol=1e-5, atol=1e-5)
    jx_q = jcoding.quantize_levels(jnp.asarray(x_np), alpha_a,
                                   ACT_BSL).astype(jnp.int8)
    np.testing.assert_array_equal(x_q.numpy(), _n(jx_q))
    np.testing.assert_array_equal(
        sum_q.numpy(), _n(jref.ternary_matmul_ref(jx_q,
                                                  jnp.asarray(w_int))))

    # 3. the kernel's front door == the plain version
    np.testing.assert_array_equal(ops.ternary_matmul(x_q, w_int).numpy(),
                                  sum_q.numpy())

    # 4. bit-level circuit == integer path (one neuron, full bitstreams)
    bits = coding.encode_thermometer(x_q[0], ACT_BSL)
    prods = multiplier.ternary_scale_bits(w_int[:, 0], bits)
    sorted_bits = bsn.exact_bsn_bits(prods)
    circuit = int(coding.counts_from_bits(sorted_bits)) - din * ACT_BSL // 2
    assert circuit == int(sum_q[0, 0])

    # 5. SI epilogue (BN-fused ReLU) on all three paths
    t = si.si_thresholds(si.bn_relu_fn(1.5, 0.1), 2 * din * ACT_BSL // 2,
                         out_bsl, alpha_in=alpha_a * alpha_w,
                         alpha_out=alpha_a)
    t_q = torch.from_numpy((t.astype(np.int64) - din * ACT_BSL // 2)
                           .astype(np.int32)).repeat(dout, 1)
    y_si_ref = ref.ternary_matmul_ref(x_q, w_int, t_q)
    y_si_kernel = ops.ternary_matmul(x_q, w_int, t_q)
    np.testing.assert_array_equal(y_si_ref.numpy(), y_si_kernel.numpy())
    np.testing.assert_array_equal(
        y_si_kernel.numpy(),
        _n(jops.ternary_matmul(jx_q, jnp.asarray(w_int),
                               jnp.asarray(t_q), **JMM)))
    si_bits = si.apply_si_bits(sorted_bits, t)
    assert int(si_bits.sum()) - out_bsl // 2 == int(y_si_ref[0, 0])


def _tnn_params(seed, batch):
    """Seeded random QAT parameters of the paper's TNN (784-256-256-10)."""
    rng = np.random.default_rng(seed)
    params = {"w_in": (rng.standard_normal((784, 256)) / 28.0)
              .astype(np.float32),
              "blocks": [{"w": (rng.standard_normal((256, 256)) / 16.0)
                          .astype(np.float32),
                          "alpha_w": np.float32(0.05),
                          "alpha_a": np.float32(0.5)} for _ in range(2)],
              "w_out": (rng.standard_normal((256, 10)) / 16.0)
              .astype(np.float32)}
    x = rng.standard_normal((batch, 784)).astype(np.float32)
    return params, x


def tnn_forward(params, x):
    """The exported TNN on the port: float frontend, the SC integer core
    (ternary matmul with the SI ReLU fused, q codes between layers), float
    classifier head.  Returns the logits and each layer's q codes."""
    cfg = sc_layers.SCQuantConfig(mode="sc_int", act_bsl=ACT_BSL)
    layers = [sc_layers.export_sc_linear(
        blk, cfg, act_fn=si.relu_fn, out_bsl=ACT_BSL,
        alpha_out=float(blk["alpha_a"])) for blk in params["blocks"]]
    h = torch.relu(x @ params["w_in"])
    x_q = coding.quantize_levels(h, layers[0]["alpha_a"],
                                 ACT_BSL).to(torch.int8)
    codes = []
    for layer in layers:
        x_q = sc_layers.sc_linear_int(layer, x_q).to(torch.int8)
        codes.append(x_q)
    h = x_q.to(torch.float32) * layers[-1]["alpha_a"]
    return h @ params["w_out"], codes


def test_tnn_forward_matches_reference():
    """The TNN at batch 16: every layer's q codes bit-exact against the
    reference's export + fused-SI Pallas matmul, logits within 1e-5."""
    params, x = _tnn_params(0, 16)
    logits, codes = tnn_forward(tree_to_torch(params, "cpu"), _t(x))
    jcfg = jsc.SCQuantConfig(mode="sc_int", act_bsl=ACT_BSL)
    h = jnp.maximum(jnp.asarray(x) @ jnp.asarray(params["w_in"]), 0.0)
    jx_q = jcoding.quantize_levels(h, 0.5, ACT_BSL).astype(jnp.int8)
    for blk, got in zip(params["blocks"], codes):
        exp = jsc.export_sc_linear(blk, jcfg, act_fn=jsi.relu_fn,
                                   out_bsl=ACT_BSL,
                                   alpha_out=float(blk["alpha_a"]))
        t_q = (exp["thresholds"].astype(np.int64) - exp["sum_max"]) \
            .astype(np.int32)
        jx_q = jops.ternary_matmul(
            jx_q, jnp.asarray(exp["w_int"]),
            jnp.asarray(np.tile(t_q, (256, 1))), min_flops_for_kernel=0,
            block_m=16, block_n=128, block_k=128).astype(jnp.int8)
        np.testing.assert_array_equal(got.numpy(), _n(jx_q))
    want = (jx_q.astype(jnp.float32) * 0.5) @ jnp.asarray(params["w_out"])
    assert logits.shape == (16, 10)
    np.testing.assert_allclose(logits.numpy(), _n(want), rtol=0, atol=1e-5)
    # the SI ReLU keeps the codes in the thermometer range, and they vary
    assert all(int(c.min()) >= -4 and int(c.max()) <= 4 for c in codes)
    assert len(np.unique(codes[-1].numpy())) > 1

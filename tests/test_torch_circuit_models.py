"""The circuit models and the port's examples against the JAX reference:
``prng``'s ``uniform`` / ``bernoulli`` / ``choice`` / ``normal``
against ``jax.random``, ``core/fault.py`` and ``core/fsm_baseline.py``
under one key, ``core/hwmodel.py``'s cost model, ``configs/paper_tnn``,
and ``repro_torch.examples`` (quickstart, design_space, train_qat,
serve_sc's TNN and engine parts) on the CPU.  Tolerances:

* the draws, the fault masks and decoded values, the stochastic streams
  and the FSM outputs: bit for bit;
* ``normal``: within 1e-6 absolute, at most a few ulps of values below 6
  (XLA's erfinv polynomial in torch ops; the log1p and the multiply-adds
  may round differently);
* the cost model: within 1e-12 relative (float64 arithmetic in both);
* design_space's MSEs: within 1e-6 relative (one float32 mean, summed in
  another order).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_fixtures import _one_torch_thread, _partitionable  # noqa: F401
from repro.configs import paper_tnn as jpaper_tnn
from repro.core import bsn as jbsn
from repro.core import fault as jfault
from repro.core import fsm_baseline as jfsm
from repro.core import hwmodel as jhw
from repro.core import si as jsi
from repro_torch import prng
from repro_torch.configs import paper_tnn
from repro_torch.core import bsn, fault, fsm_baseline, hwmodel
from repro_torch.examples import design_space, quickstart, serve_sc, train_qat

ROOT = Path(__file__).resolve().parents[1]
NORMAL_ATOL = 1e-6
HW_RTOL = 1e-12
MSE_RTOL = 1e-6


def _spec(mod, width, in_bsl, stages):
    return mod.ApproxBSNSpec(width, in_bsl, tuple(
        mod.StageSpec(g, mod.SubSampleSpec(c, s)) for g, c, s in stages))


# ---------------------------------------------------------------------------
# prng
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7,), (5, 9), (3, 4, 33), ()])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-2.5, 3.0)])
def test_uniform_is_bit_equal_to_jax(shape, bounds):
    for seed in (0, 5):
        want = np.asarray(jax.random.uniform(jax.random.key(seed), shape,
                                             minval=bounds[0],
                                             maxval=bounds[1]))
        got = prng.uniform(prng.key(seed), shape, *bounds).numpy()
        np.testing.assert_array_equal(got, want)


def test_uniform_takes_a_batch_of_keys():
    keys = jax.random.split(jax.random.key(3), 4)
    want = np.stack([np.asarray(jax.random.uniform(k, (6, 2))) for k in keys])
    got = prng.uniform(prng.split(prng.key(3), 4), (6, 2)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.0, 1e-3, 0.16, 0.5, 1.0])
def test_bernoulli_is_bit_equal_to_jax(p):
    want = np.asarray(jax.random.bernoulli(jax.random.key(9), p, (64, 50)))
    got = prng.bernoulli(prng.key(9), p, (64, 50)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [(0.16, 0.68, 0.16), (0.5, 0.25, 0.25),
                               (0.1, 0.2, 0.3, 0.4)])
def test_choice_is_bit_equal_to_jax(p):
    a = np.arange(len(p), dtype=np.int32) - 1
    want = np.asarray(jax.random.choice(jax.random.key(2), jnp.asarray(a),
                                        (40, 70), p=jnp.asarray(p)))
    got = prng.choice(prng.key(2), torch.from_numpy(a), (40, 70),
                      p=torch.tensor(p)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1000,), (8, 1024, 16)])
def test_normal_follows_jax(shape):
    for step in (0, 3):
        k = jax.random.fold_in(jax.random.key(7), step)
        want = np.asarray(jax.random.normal(k, shape))
        got = prng.normal(prng.fold_in(prng.key(7), step), shape).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL)


# ---------------------------------------------------------------------------
# the fault model and the FSM baseline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ber", [0.0, 1e-3, 0.02, 0.3])
def test_fault_injection_is_bit_equal_to_the_reference(ber):
    x = np.random.default_rng(0).integers(-8, 9, (96, 40)).astype(np.int32)
    for seed in (0, 11):
        k, kt = jax.random.key(seed), prng.key(seed)
        bits = np.random.default_rng(seed).integers(0, 2, (32, 17)) \
            .astype(np.int8)
        np.testing.assert_array_equal(
            fault.flip_bits(torch.from_numpy(bits), ber, kt).numpy(),
            np.asarray(jfault.flip_bits(jnp.asarray(bits), ber, k)))
        for bsl in (2, 16):
            np.testing.assert_array_equal(
                fault.thermometer_under_ber(torch.from_numpy(x), bsl, ber,
                                            kt).numpy(),
                np.asarray(jfault.thermometer_under_ber(jnp.asarray(x), bsl,
                                                        ber, k)))
        np.testing.assert_array_equal(
            fault.binary_under_ber(torch.from_numpy(x), 5, ber, kt).numpy(),
            np.asarray(jfault.binary_under_ber(jnp.asarray(x), 5, ber, k)))


def test_fsm_baseline_is_bit_equal_to_the_reference():
    x = np.random.default_rng(1).uniform(-1, 1, (12, 7)).astype(np.float32)
    bits = fsm_baseline.stochastic_bitstream(torch.from_numpy(x), 1024,
                                             prng.key(4))
    jbits = jfsm.stochastic_bitstream(jnp.asarray(x), 1024, jax.random.key(4))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    for n in (4, 8, 16):
        np.testing.assert_array_equal(
            fsm_baseline.fsm_stanh(bits, n).numpy(),
            np.asarray(jfsm.fsm_stanh(jbits, n)))
        np.testing.assert_array_equal(
            fsm_baseline.fsm_relu(bits, n).numpy(),
            np.asarray(jfsm.fsm_relu(jbits, n)))
    other = fsm_baseline.stochastic_bitstream(torch.from_numpy(x), 1024,
                                              prng.key(5))
    prod = fsm_baseline.xnor_multiply(bits, other)
    np.testing.assert_array_equal(
        prod.numpy(), np.asarray(jfsm.xnor_multiply(jbits,
                                                    jnp.asarray(other))))
    np.testing.assert_allclose(
        fsm_baseline.decode_bipolar(prod).numpy(),
        np.asarray(jfsm.decode_bipolar(jnp.asarray(prod.numpy()))),
        rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the cost model and the paper's TNN
# ---------------------------------------------------------------------------

SPECS = [(4608, 2, ((64, 48, 1), (72, 640, 8))),
         (2048, 8, ((16, 32, 2), (8, 96, 4), (16, 0, 2))),
         (256, 2, ((256, 0, 1),))]


def _cost_close(got, want):
    for f in ("area_um2", "delay_ns", "adp"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=HW_RTOL, atol=0)
    assert got.cycles == want.cycles


def test_hwmodel_equals_the_reference():
    assert hwmodel.GATE_AREA_UM2 == jhw.GATE_AREA_UM2
    assert hwmodel.LEVEL_DELAY_NS == jhw.LEVEL_DELAY_NS
    assert hwmodel.GATE_ENERGY_FJ == jhw.GATE_ENERGY_FJ
    for n in (1, 2, 3, 9216, 16384, 70000):
        assert hwmodel.bitonic_comparators(n) == jhw.bitonic_comparators(n)
        assert hwmodel.bitonic_depth(n) == jhw.bitonic_depth(n)
        _cost_close(hwmodel.bsn_cost(n), jhw.bsn_cost(n))
        _cost_close(hwmodel.multiplier_array_cost(n),
                    jhw.multiplier_array_cost(n))
    # Table V's calibration point: the 3x3x512 conv's baseline BSN
    base = hwmodel.bsn_cost(4608 * 2)
    np.testing.assert_allclose((base.area_um2, base.delay_ns), (2.95e5, 4.33),
                               rtol=HW_RTOL)
    for stages in SPECS:
        spec, jspec = _spec(bsn, *stages), _spec(jbsn, *stages)
        _cost_close(hwmodel.approx_bsn_cost(spec), jhw.approx_bsn_cost(jspec))
        for cycles in (1, 4, 9):
            _cost_close(hwmodel.spatial_temporal_cost(spec, cycles),
                        jhw.spatial_temporal_cost(jspec, cycles))
        _cost_close(hwmodel.datapath_cost(spec.width,
                                          hwmodel.approx_bsn_cost(spec)),
                    jhw.datapath_cost(jspec.width,
                                      jhw.approx_bsn_cost(jspec)))
        assert hwmodel.describe_spec(spec, 4) == jhw.describe_spec(jspec, 4)
    for act_bsl, volt in ((2, 0.65), (8, 0.5), (16, 0.9)):
        np.testing.assert_allclose(hwmodel.tops_per_watt(act_bsl, volt),
                                   jhw.tops_per_watt(act_bsl, volt),
                                   rtol=HW_RTOL)
    np.testing.assert_allclose(hwmodel.tops_per_watt(), 198.9, rtol=HW_RTOL)


def test_paper_tnn_config_equals_the_reference():
    assert paper_tnn.TNN_LAYERS == jpaper_tnn.TNN_LAYERS == (784, 256, 256,
                                                             10)
    assert paper_tnn.TNN_ACT_BSL == jpaper_tnn.TNN_ACT_BSL
    assert paper_tnn.TNN_RESID_BSL == jpaper_tnn.TNN_RESID_BSL


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_design_space_equals_the_reference_example():
    """The reference's ``examples/design_space.py`` (loaded by path) and
    the port's: the same candidate grid, the drawn products bit for bit,
    each MSE within 1e-6 relative, the same Pareto order."""
    ref = _reference_example("design_space")
    width, n = 1152, 256
    want = ref.candidates(width)
    got = design_space.candidates(width)
    assert [(f, s, g) for _, f, s, g in got] == \
        [(f, s, g) for _, f, s, g in want]
    assert {1, 9} == {f for _, f, _, _ in got}
    for (spec, fold, _, _), (jspec, _, _, _) in zip(got, want):
        assert bsn.spec_stages(spec) == tuple(
            (st.group, st.sub.clip, st.sub.stride) for st in jspec.stages)
        assert (spec.width, spec.out_bsl, spec.scale) == \
            (jspec.width, jspec.out_bsl, jspec.scale)
    draws = design_space.draw(width * 1, n, seed=0, device="cpu")
    jdraws = jax.random.choice(jax.random.key(0), jnp.asarray([-1, 0, 1]),
                               (n, width), p=jnp.asarray([0.16, 0.68, 0.16]))
    np.testing.assert_array_equal(draws.numpy(), np.asarray(jdraws))
    for spec, fold, _, _ in got[::3] + [got[-1]]:
        jspec = _spec(jbsn, spec.width, spec.in_bsl, bsn.spec_stages(spec))
        np.testing.assert_allclose(
            design_space.measure_mse(spec, fold, n, device="cpu"),
            ref.measure_mse(jspec, fold, n), rtol=MSE_RTOL, atol=0)


def test_quickstart_runs_on_the_cpu(capsys):
    """The port's quickstart: its neuron (the reference's randint draws)
    through the BSN circuit, the integer dot and ops.ternary_matmul."""
    res = quickstart.main(["--device", "cpu"])
    a_q = jax.random.randint(jax.random.key(0), (8,), -4, 5)
    w_q = jax.random.randint(jax.random.key(1), (8,), -1, 2)
    dot = int(jnp.sum(a_q * w_q))
    assert res["sum_q"] == res["dot"] == res["kernel"] == dot
    t = jsi.si_thresholds(jsi.relu_fn, 64, 16, alpha_in=0.5, alpha_out=0.5)
    assert res["si_q"] == int(np.sum(dot + 32 >= t)) - 8
    assert "All three views agree" in capsys.readouterr().out


def test_train_qat_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    first, last, floor = train_qat.run(steps=2, batch=2, seq=16,
                                       device="cpu", ckpt_dir=str(tmp_path))
    assert np.isfinite(first) and np.isfinite(last)
    assert floor == pytest.approx(np.log(4))
    train_qat.run(steps=3, batch=2, seq=16, device="cpu",
                  ckpt_dir=str(tmp_path))
    assert "resumed from checkpoint step 2" in capsys.readouterr().out


def test_serve_sc_tnn_part_on_the_cpu(capsys):
    """Part 1 at a tiny size: QAT-train the TNN, export it, serve a batch
    through ``ops.ternary_matmul`` with the fused SI; the gate raises
    where the integer path falls 3.5 points or more below QAT."""
    kw = dict(steps=3, batch=16, eval_batches=1, eval_batch=32,
              device="cpu")
    res = serve_sc.serve_tnn(gate=False, **kw)
    assert 0.0 <= res["acc_int"] <= 1.0 and 0.0 <= res["acc_qat"] <= 1.0
    assert res["drop"] == res["acc_qat"] - res["acc_int"]
    assert len(res["latency_ms"]) == 1
    assert "exported 2 SC layers, 131k ternary weights" in \
        capsys.readouterr().out
    # three steps leave the TNN under-trained: its integer path falls
    # more than the gate's 3.5 points below QAT, and the gate raises
    assert res["drop"] >= 0.035
    with pytest.raises(AssertionError, match="diverged from QAT"):
        serve_sc.serve_tnn(**kw)


def test_serve_sc_engine_part_on_the_cpu():
    """Greedy and seeded-sampled tokens of the batched sc_int engine equal
    the sequential oracle's (the example raises otherwise)."""
    res = serve_sc.main(["--smoke", "--device", "cpu"])
    assert len(res["greedy"]) == len(res["sampled"]) == 4
    assert res["greedy"] != res["sampled"]

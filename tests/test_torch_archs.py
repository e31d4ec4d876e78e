"""The dense-attention architectures the port now takes, against the JAX
reference: stablelm-1.6b (LayerNorm, partial RoPE 0.25, MHA), nemotron-
4-15b (LayerNorm, the ungated squared-ReLU FFN, partial RoPE 0.5, GQA 2)
and phi3-medium-14b (RMSNorm, SwiGLU, GQA 4), at the reference's
``REDUCED`` sizes (``tests/test_models_smoke.py``), float32, parameters
carried over by ``weights.from_jax``.  Tolerances:

* norms, activations and RoPE: ``atol=1e-5`` (float32; the port takes the
  norms' statistics in float64);
* training-forward logits: ``atol=1e-5`` without quantization and
  ``5e-5`` under sc_qat (the fake-quant lattice passes a one-ulp
  difference on as a whole level now and then), as
  ``tests/test_torch_train.py`` holds granite;
* serving: greedy tokens equal, against the JAX engine and against the
  port's own sequential oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch.train import reduced_config as jreduced_config
from repro.models import common as jcommon
from repro.models import init_params as jinit_params
from repro.models import transformer as jtf
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_arch
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import reduced_config
from repro_torch.models import common, forward
from repro_torch.serving import ServeEngine, sequential_generate
from repro_torch.weights import from_jax
from port_fixtures import _one_torch_thread  # noqa: F401


COMMON = dict(dtype="float32", vocab_pad_multiple=32)
REDUCED = {
    "stablelm-1.6b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=96, vocab_size=131),
    "nemotron-4-15b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                           d_ff=192, vocab_size=131),
    "phi3-medium-14b": dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
                            d_ff=128, vocab_size=131),
}
ARCHS = sorted(REDUCED)
PAIRS = [("qat", "fp"), ("sc_int", "int8"), ("sc_int_approx", "sc")]
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12, 13, 14]]
ENGINE = dict(max_slots=2, max_len=32, page_size=4)


def _cfgs(arch, mode="sc_qat"):
    jc = jget_arch(arch).scaled(attn_q_chunk=8, **COMMON, **REDUCED[arch])
    c = get_arch(arch).scaled(**COMMON, **REDUCED[arch])
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


def test_configs_carry_the_reference_fields():
    fields = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "head_dim", "norm", "ffn_act", "ffn_gated",
              "rope_theta", "rope_fraction", "qk_norm", "n_experts",
              "n_experts_per_tok", "moe_capacity_factor", "moe_group_size",
              "padded_vocab")
    for arch in ARCHS + ["qwen3-moe-235b-a22b", "dbrx-132b"]:
        want, got = jget_arch(arch), get_arch(arch)
        for f in fields:
            assert getattr(got, f) == getattr(want, f), (arch, f)
        assert got.period == tuple(type(got.period[0])(s.mixer, s.ffn)
                                   for s in want.period)


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-moe-235b-a22b",
                                          "dbrx-132b"])
@pytest.mark.parametrize("factor,seq", [(8, 256), (16, 32)])
def test_reduced_config_keeps_the_moe_fields(arch, factor, seq):
    want = jreduced_config(jget_arch(arch), factor, seq)
    got = reduced_config(get_arch(arch), factor, seq)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "head_dim", "n_experts", "n_experts_per_tok",
              "moe_group_size", "moe_capacity_factor", "attn_q_chunk"):
        assert getattr(got, f) == getattr(want, f), (arch, f)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match(kind):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 5, 48)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    if kind == "rmsnorm":
        del p["bias"]
    want = jcommon.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), kind)
    got = common.norm_apply({k: _t(v) for k, v in p.items()}, _t(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    init = common.norm_init(48, kind, torch.device("cpu"))
    assert set(init) == set(jcommon.norm_init(48, kind))


@pytest.mark.parametrize("act", ["silu", "gelu", "relu", "relu2"])
def test_activations_match(act):
    """``gelu`` is jax.nn.gelu's default, the tanh approximation."""
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    np.testing.assert_allclose(
        common.ACT_FNS[act](_t(x)).numpy(),
        np.asarray(jcommon.ACT_FNS[act](jnp.asarray(x))), rtol=0, atol=1e-5)


@pytest.mark.parametrize("fraction", [0.25, 0.5])
def test_partial_rope_matches(fraction):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    got = common.apply_rope(_t(x), _t(pos), 16, fraction, 1e4).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                           16, fraction, 1e4)),
        rtol=0, atol=1e-5)
    rot = int(16 * fraction) // 2 * 2
    np.testing.assert_array_equal(got[..., rot:], x[..., rot:])


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,tol", [("none", 1e-5), ("sc_qat", 5e-5)])
def test_forward_logits_match_reference(arch_params, mode, tol):
    arch, jp, tp = arch_params
    jc, c = _cfgs(arch, mode)
    toks = np.random.default_rng(4).integers(0, 131, (2, 16)) \
        .astype(np.int32)
    want, jaux, _ = jtf.forward(jp, {"tokens": jnp.asarray(toks)}, jc)
    got, aux = forward(tp, {"tokens": _t(toks)}, c)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("datapath,fmt", PAIRS)
def test_engine_tokens_equal_reference_engine(arch_params, datapath, fmt):
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

    def tokens(done):
        return [r.generated for r in sorted(done, key=lambda r: r.rid)]
    assert tokens(eng.run_to_completion()) == tokens(jeng.run_to_completion())


@pytest.mark.parametrize("datapath,fmt", PAIRS)
def test_engine_tokens_equal_sequential_generate(arch_params, datapath, fmt):
    arch, _, tp = arch_params
    _, c = _cfgs(arch)
    prompts = PROMPTS + [[3, 1, 4, 1, 5, 9, 2, 6]]
    eng = ServeEngine(tp, c, datapath=datapath, kv_format=fmt, device="cpu",
                      prefill_chunk=4, **ENGINE)
    for p in prompts:
        eng.submit(p, max_new_tokens=6)
    got = [r.generated for r in sorted(eng.run_to_completion(),
                                       key=lambda r: r.rid)]
    assert got == sequential_generate(
        tp, c, prompts, max_new_tokens=6, max_len=32, datapath=datapath,
        kv_format=fmt, page_size=8, device="cpu")


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "qwen3-moe-235b-a22b"])
def test_launch_train_runs_on_cpu(arch, capsys):
    _, hist = train_main(["--arch", arch, "--reduce", "32", "--steps", "2",
                          "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert f"[train] {arch}" in capsys.readouterr().out

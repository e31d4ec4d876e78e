"""The port's training mesh on the recurrent archs: rwkv6-7b (time mix and
channel mix) and the jamba hybrid (mamba, attention, dense FFN and MoE in
one whole period of 8 layers), with the dense entry points the dry-run's
cells run and long_500k's sequence-cut decode.

Tiny configs (``REDUCED`` of ``tests/test_models_smoke.py``; mamba's
``chunk`` 8, so that the training scan threads two chunks), mamba's
``conv_w`` at 10x the reference's draw so that the SSM state is live (as
the port's recurrent tests), and the optimizer state in float32 (jamba's
registered bfloat16 state would round every ``m`` and ``v`` to 2**-8,
hiding the differences held here).  Meshes (1, 2), (2, 1), (2, 2) and
(2, 1, 2) of gloo ranks (``tests/mesh_worker.py``, every mesh at once,
each rank running every case), against the port's mesh-off run:

* one ``build_train_step`` step (rwkv6 with the token scan and with the
  chunked wkv), quantization off and sc_qat: in float32
  at ``chip_smoke.TINY_TRAIN_TOL`` (loss and grad norm within 1e-5
  relative, params within 2e-5, m within 5e-5 and v within 1e-4 of each
  leaf's largest entry; under sc_qat the loss alone, ROADMAP Queue 3
  item 7), and in float64 on every leaf under both modes, the LSQ
  scales' included: a gradient that reached a replicated value from a
  rank's heads or channels and was left unsummed over "model" (or summed
  twice) parts the leaf by a factor of 2.  A scalar LSQ scale's gradient
  is summed in float32 whatever the model's dtype (``core/quant.py``) over
  terms that cancel to ~1e-3 of their size, so its ``m`` is held within
  1e-3 and its ``v`` within 2e-3 (``LSQ_SCALE_TOL``, as ``tests/
  test_torch_recurrent_train.py``): mesh-off's own float64 step with the
  batch's rows reversed moves layer 2's ``alpha_r1`` ``m`` by 4.2e-4;
* mesh-off's float32 step against the reference's single-device step,
  once an arch (quantization off);
* the dense ``prefill`` in the training layout (the dry-run's
  prefill_32k cell) and one ``decode_step`` in the serving layout with
  its batch of 4 cut over the batch axes (decode_32k): logits within
  1e-5 of the largest (float32, quantization off) and 1e-9 (float64,
  sc_qat); the decode's new cache within 1e-5 of its largest entry;
* the sequence-cut decode (long_500k's rules: the batch of 1 on no mesh
  axis, K / V time cut over "data") on (2, 1) and (2, 2), at positions on
  either side of the blocks' boundary and at both ends: logits within
  1e-5 of the largest; the new K / V written where mesh-off writes them,
  bit for bit when attention is layer 0 (it reads the embedding alone),
  within 1e-5 of the largest after a mamba layer; every other position
  and the recurrent state's untouched entries as mesh-off's;
* a tiny jamba checkpoint saved from the (2, 2) mesh restores onto (1, 2)
  bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_worker as mw
from port_fixtures import _one_torch_thread  # noqa: F401
from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit_params
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train import build_train_step as jbuild_train_step
from repro.train import init_train_state as jinit_train_state
from repro_torch.configs import get_arch
from repro_torch.configs.jamba_1_5_large import PERIOD
from repro_torch.models import init_cache, init_params
from repro_torch.tree import tree_map, tree_paths
from repro_torch.weights import from_jax

COMMON = dict(dtype="float32", vocab_pad_multiple=32, mamba_chunk=8,
              opt_state_dtype="float32")
REDUCED = {   # tests/test_models_smoke.py
    "rwkv6-7b": dict(n_layers=2, d_model=64, d_ff=128, vocab_size=131,
                     n_heads=4, n_kv_heads=4, rwkv_head_dim=16),
    "jamba-1.5-large-398b": dict(n_layers=8, d_model=64, n_heads=4,
                                 n_kv_heads=2, d_ff=96, vocab_size=131,
                                 n_experts=4, n_experts_per_tok=2,
                                 mamba_d_state=8, moe_group_size=16,
                                 moe_capacity_factor=2.0),
}
ARCHS = list(REDUCED)
# the train step's cases: each arch, and rwkv6 with the chunked wkv too
VARIANTS = {"rwkv6-7b": ("rwkv6-7b", {}),
            "rwkv6-7b-chunked": ("rwkv6-7b", dict(rwkv_wkv_impl="chunked",
                                                  rwkv_chunk=8)),
            "jamba-1.5-large-398b": ("jamba-1.5-large-398b", {})}
MODES = ("none", "sc_qat")
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "2x1x2": (2, 1, 2)}
SEQ_MESHES = ("2x1", "2x2")           # "data" cuts the cache's time
B, S, T = 4, 16, 16                   # batch, tokens, dense cache length
TOL = dict(metric=1e-5, params=2e-5, m=5e-5, v=1e-4)   # TINY_TRAIN_TOL
LSQ_SCALE_TOL = dict(m=1e-3, v=2e-3)    # a scalar alpha_*, float32 sums
LOGIT_TOL = {"float32": 1e-5, "float64": 1e-9}
# long_500k's decode: the attention layer first (its K / V read the
# embedding alone) and after a mamba layer; positions either side of the
# two data blocks' boundary and at both ends
SEQ_CASES = {"attn-first": ((PERIOD[4], PERIOD[0]), (0, 7, 8, 15)),
             "attn-after-mamba": ((PERIOD[0], PERIOD[4]), (7, 8))}


def _lr(s):
    return jwarmup_cosine(s + 1, 1e-3, 2, 10)


def _cfgs(variant, mode):
    arch, kw = VARIANTS[variant]
    jc = jget_arch(arch).scaled(attn_q_chunk=8, attn_kv_chunk=8, **COMMON,
                                **REDUCED[arch], **kw)
    c = get_arch(arch).scaled(**COMMON, **REDUCED[arch], **kw)
    return (jc.scaled(quant=jc.quant.with_mode(mode)),
            c.scaled(quant=c.quant.with_mode(mode)))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 131, (B, S)).astype(np.int32),
            "targets": rng.integers(0, 131, (B, S)).astype(np.int32),
            "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _jstate(arch, mode):
    """The reference's initial state of an arch (mamba's SSM live): the
    same for each of its variants, whose options the init never reads."""
    jc, _ = _cfgs(arch, mode)
    return jinit_train_state(mw.live_ssm(jax.jit(
        jinit_params, static_argnums=1)(jax.random.key(0), jc)), jc)


@functools.lru_cache(maxsize=None)
def _init(variant, mode):
    """The reference's initial state and config and the case the port runs
    from it: its params as the port's numpy tree, the batch."""
    jc, c = _cfgs(variant, mode)
    jstate = _jstate(VARIANTS[variant][0], mode)
    port = from_jax(jax.tree.map(np.asarray, jstate.params), c, device="cpu")
    return jc, jstate, dict(cfg=c, params=tree_map(lambda t: t.numpy(), port),
                            batch=_batch())


def _reference(arch):
    """The reference's jitted step, quantization off: metrics and state."""
    jc, jstate, case = _init(arch, "none")
    jstate, jm = jax.jit(jbuild_train_step(jc, _lr))(
        jstate, {k: jnp.asarray(v) for k, v in case["batch"].items()})
    want = from_jax(jax.tree.map(np.asarray, jstate), case["cfg"],
                    device="cpu")
    return {"metrics": {k: float(v) for k, v in jm.items()},
            **{name: {k: v.numpy() for k, v in tree_paths(tree)}
               for name, tree in (("params", want.params),
                                  ("m", want.opt["m"]),
                                  ("v", want.opt["v"]))}}


def _float64(case):
    """``case`` in float64: the leaves the port makes in the model's dtype
    and the batch's floats widened, the LSQ scales, norms and per-channel
    SSM leaves kept float32 as ``init_params`` keeps them."""
    cfg = case["cfg"].scaled(dtype="float64")
    made = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = tree_map(lambda a, t: a.astype(t.numpy().dtype),
                      case["params"], made)
    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in case["batch"].items()}
    return dict(case, cfg=cfg, params=params, batch=batch)


def _random_cache(cfg, batch, seed):
    """A dense cache of ``T`` positions, every leaf seeded random (the
    recurrent state at the scale of a live one)."""
    rng = np.random.default_rng(seed)
    made = init_cache(cfg, batch, T, device="cpu")
    layers = tree_map(lambda t: (0.5 * rng.standard_normal(t.shape))
                      .astype(t.numpy().dtype), made["layers"])
    return {"pos": np.array(5, dtype=np.int32), "layers": layers}


def _dense_cases():
    """The prefill and the batch-cut decode of each arch: quantization
    off in float32, sc_qat in float64."""
    out = {}
    for arch in ARCHS:
        for mode in MODES:
            case = _init(arch, mode)[2]
            if mode == "sc_qat":
                case = _float64(case)
            out[f"prefill-{arch}-{mode}"] = dict(case, kind="prefill")
            cache = _random_cache(case["cfg"], B, 1)
            toks = np.random.default_rng(2).integers(0, 131, (B, 1))
            out[f"decode-{arch}-{mode}"] = dict(
                case, kind="decode", cache_kw={}, cache=cache,
                tokens=toks.astype(np.int32))
    return out


def _seq_cases():
    """long_500k's decode on tiny jamba layers at each position."""
    _, _, case = _init("jamba-1.5-large-398b", "none")
    c = case["cfg"]
    out = {}
    for name, (period, positions) in SEQ_CASES.items():
        cfg = c.scaled(n_layers=2, period=period)
        params = tree_map(lambda t: t.numpy(), init_params(
            cfg, torch.Generator().manual_seed(4), "cpu"))
        for layer in params["layers"]:
            if "conv_w" in layer["mixer"]:
                layer["mixer"]["conv_w"] = layer["mixer"]["conv_w"] * 10
        for pos in positions:
            cache = _random_cache(cfg, 1, 3)
            cache["pos"] = np.array(pos, dtype=np.int32)
            out[f"seq-{name}-{pos}"] = dict(
                cfg=cfg, params=params, kind="seq_decode", cache=cache,
                cache_kw=dict(seq_shard=True),
                tokens=np.array([[17]], dtype=np.int32))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's per-rank results, mesh-off's, the reference's, and
    the checkpoint the (2, 2) mesh saved, restored onto (1, 2).  The
    ranks start first; the reference compiles while they run."""
    mw.run_all([functools.partial(_jstate, a, m) for a in ARCHS
                for m in MODES])
    train = {}
    for a in VARIANTS:
        for m in MODES:
            train[f"{a}-{m}"] = _init(a, m)[2]
            train[f"{a}-{m}-f64"] = _float64(_init(a, m)[2])
    cases = {**train, **_dense_cases()}
    seq = _seq_cases()
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt"))
    jobs = {}
    for name, shape in MESHES.items():
        mine = dict(cases, **(seq if name in SEQ_MESHES else {}))
        if name == "2x2":
            mine["ckpt"] = dict(train["jamba-1.5-large-398b-none"],
                                ckpt_dir=ckpt)
        jobs[name] = mw.Ranks(mw.mesh_cases, int(np.prod(shape)), shape,
                              mine)
    ref = dict(zip(ARCHS, mw.run_all([functools.partial(_reference, a)
                                      for a in ARCHS])))
    off = {cid: mw.case_off(case) for cid, case in {**cases, **seq}.items()}
    per_rank = {name: job.collect(timeout=400) for name, job in jobs.items()}
    c = train["jamba-1.5-large-398b-none"]["cfg"]
    target = tree_map(lambda t: t.numpy(),
                      init_params(c, torch.Generator().manual_seed(0), "cpu"))
    restored = mw.on_ranks(mw.restore_on_mesh, 2, (1, 2), c,
                           [(ckpt, "params", target)])
    return dict(per_rank=per_rank, off=off, ref=ref, restored=restored)


def _check(got, want, mode, label, scales=False):
    checked = ("loss",) if mode == "sc_qat" else ("loss", "grad_norm")
    errs = {k: abs(got["metrics"][k] - want["metrics"][k])
            / abs(want["metrics"][k]) for k in checked}
    for k in checked:
        assert errs[k] <= TOL["metric"], (label, k, errs)
    if mode == "sc_qat":
        return
    slack = 2 * want["metrics"]["lr"]
    for k, w in want["params"].items():
        small = np.abs(want["m"][k]) < (1 - 0.9) * 1e-6
        err = np.abs(got["params"][k] - w) - np.where(small, slack, 0.0)
        assert err.max() <= TOL["params"], (label, k, err.max())
    for name in ("m", "v"):
        for k, w in want[name].items():
            err = np.abs(got[name][k] - w).max() / max(np.abs(w).max(),
                                                       1e-30)
            lsq = scales and w.ndim == 0 and \
                k.rsplit("/", 1)[-1].startswith("alpha")
            assert err <= (LSQ_SCALE_TOL if lsq else TOL)[name], \
                (label, name, k, err)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(VARIANTS))
@pytest.mark.parametrize("mode", MODES)
def test_mesh_step_equals_mesh_off(runs, arch, mode, mesh):
    cid = f"{arch}-{mode}"
    ranks = runs["per_rank"][mesh]
    got = ranks[0][cid]
    for other in ranks[1:]:       # every rank holds the same whole state
        assert other[cid]["metrics"] == got["metrics"]
        for k, v in got["params"].items():
            np.testing.assert_array_equal(other[cid]["params"][k], v)
    _check(got, runs["off"][cid], mode, f"{cid} {mesh} vs mesh-off")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(VARIANTS))
@pytest.mark.parametrize("mode", MODES)
def test_mesh_step_equals_mesh_off_in_float64(runs, arch, mode, mesh):
    """Every leaf, the LSQ scales' (``alpha_*``) included, and the grad
    norm, under both modes."""
    cid = f"{arch}-{mode}-f64"
    _check(runs["per_rank"][mesh][0][cid], runs["off"][cid], "none",
           f"{cid} {mesh} vs mesh-off", scales=mode == "sc_qat")


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_off_step_equals_the_reference(runs, arch):
    _check(runs["off"][f"{arch}-none"], runs["ref"][arch], "none",
           f"{arch} mesh-off vs reference")


def _logits_close(got, want, dtype, label):
    err = np.abs(got - want).max()
    assert err <= LOGIT_TOL[dtype] * np.abs(want).max(), (label, err)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_prefill_in_the_training_layout(runs, arch, mode, mesh):
    """The dense prefill (serving products, the recurrences' per-token
    form) under the training layout: row-parallel ``x_proj`` /
    ``out_proj`` / ``wo`` / ``wv`` sums in another order."""
    cid = f"prefill-{arch}-{mode}"
    dtype = "float64" if mode == "sc_qat" else "float32"
    for got in runs["per_rank"][mesh]:
        _logits_close(got[cid]["logits"], runs["off"][cid]["logits"], dtype,
                      f"{cid} {mesh}")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_decode_with_its_batch_cut(runs, arch, mode, mesh):
    """One decode step in the serving layout, each data rank its block of
    the 4 rows and of their states: logits and the whole new cache."""
    cid = f"decode-{arch}-{mode}"
    dtype = "float64" if mode == "sc_qat" else "float32"
    want = runs["off"][cid]
    for got in runs["per_rank"][mesh]:
        _logits_close(got[cid]["logits"], want["logits"], dtype,
                      f"{cid} {mesh}")
        for k, v in want["cache"].items():
            err = np.abs(got[cid]["cache"][k] - v).max()
            assert err <= LOGIT_TOL[dtype] * max(np.abs(v).max(), 1.0), \
                (cid, mesh, k, err)


@pytest.mark.parametrize("mesh", SEQ_MESHES)
@pytest.mark.parametrize("cid", [f"seq-{n}-{p}" for n, (_, ps) in
                                 SEQ_CASES.items() for p in ps])
def test_decode_over_a_data_cut_cache(runs, cid, mesh):
    want = runs["off"][cid]
    pos = int(cid.rsplit("-", 1)[1])
    first = cid.startswith("seq-attn-first")
    for got in runs["per_rank"][mesh]:
        _logits_close(got[cid]["logits"], want["logits"], "float32",
                      f"{cid} {mesh}")
        for k, v in want["cache"].items():
            g = got[cid]["cache"][k]
            if k == "pos" or not k.endswith(("/k", "/v")):
                err = np.abs(g - v).max()
                assert err <= 1e-5 * max(np.abs(v).max(), 1.0), (cid, k, err)
                continue
            rest = np.ones(v.shape[1], dtype=bool)
            rest[pos] = False
            np.testing.assert_array_equal(g[:, rest], v[:, rest])
            if first:
                np.testing.assert_array_equal(g[:, pos], v[:, pos])
            else:
                assert np.abs(g[:, pos] - v[:, pos]).max() <= \
                    1e-5 * np.abs(v[:, pos]).max(), (cid, mesh, k)


def test_checkpoint_from_2x2_restores_onto_1x2(runs):
    """Saved whole from the (2, 2) mesh's blocks of tiny jamba (mamba's
    channels, the experts, the FSDP cuts), restored onto (1, 2): each
    rank's blocks gathered again are the (2, 2) mesh's bits."""
    saved = runs["per_rank"]["2x2"][0]["ckpt"]["params"]
    for rank, res in enumerate(runs["restored"]):
        (bits, shapes), = res
        for k, v in saved.items():
            np.testing.assert_array_equal(bits[f"params/{k}"],
                                          v.view(np.int32))
        # each rank held its block: in_proj's 2 x 128 columns halved
        assert shapes["params/layers/0/mixer/in_proj/w"] == (64, 128), rank

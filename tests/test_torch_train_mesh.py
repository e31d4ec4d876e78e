"""The port's training mesh: FSDP x tensor / expert parallelism over a
torch.distributed (data, model) or (pod, data, model) mesh of gloo ranks.

* The layouts: the port's training and serving ``param_specs``,
  ``opt_state_specs``, ``batch_specs`` and the dense ``cache_specs`` equal
  the reference's leaf by leaf for every registered arch (the
  reference's stacked leading axis dropped, ``PartitionSpec`` as tuples),
  but for the serving departures ROADMAP Queue 1 item 11 records;
  ``multipod_mapping`` equals the reference's.
* The step: tiny granite, qwen3-moe and llava (``REDUCED`` of
  ``tests/test_models_smoke.py``), float32, quantization off and sc_qat,
  one ``build_train_step`` step on (1, 2), (2, 1), (2, 2) and (2, 1, 2)
  meshes (``tests/mesh_worker.py``, every mesh at once, one start a file)
  against the port's mesh-off step and the reference's single-device
  step, at phase 6's tolerances (``chip_smoke.TINY_TRAIN_TOL``): loss and
  grad norm within 1e-5 relative, params within 2e-5 (an entry whose
  first-step gradient is below 1e-6 within 2 lr: its step ``lr g / (|g| +
  eps)`` is set by the gradient's rounding, as phase 6's rule), m within
  5e-5 and v within 1e-4 of each leaf's largest entry.  Under sc_qat in
  float32 the loss alone (ROADMAP Queue 3 item 7: a sum in another order
  moves an activation across a clip rail and the LSQ gradients with it;
  mesh-off's own float32 step parts from its float64 step by 13% on an
  ``alpha_r`` leaf); under sc_qat in float64 (the weights and activations;
  the scales float32, as the port keeps them) the grad norm and every
  leaf, the LSQ scales' included, against mesh-off at the same
  tolerances.  Gradient compression on the (2, 2) mesh against
  mesh-off's.
* A mixture of experts whose groups straddle two data ranks' blocks
  (qwen3-moe with its group as large as the batch): every rank routes
  every token, the unsharded call's groups and capacity.
* The dense decode step over a cache whose time axis is cut over "model"
  (``cache_specs(kv_head_shard=False)``, the dry-run's decode cells):
  logits and the written cache equal mesh-off's, on (1, 2) and (2, 2).
* Checkpoints: saved from the (2, 2) mesh, restored onto (1, 1) and (1, 2)
  bit for bit; a checkpoint the reference wrote restores onto (1, 2) bit
  for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_worker as mw
from port_fixtures import _one_torch_thread  # noqa: F401
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.configs import get_arch as jget_arch
from repro.configs import list_archs as jlist_archs
from repro.distributed.sharding import multipod_mapping as jmultipod_mapping
from repro.models import batch_specs as jbatch_specs
from repro.models import cache_specs as jcache_specs
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import param_specs as jparam_specs
from repro.optim import opt_state_specs as jopt_state_specs
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train import build_train_step as jbuild_train_step
from repro.train import init_train_state as jinit_train_state
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import multipod_mapping
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import (batch_specs, cache_specs, init_params,
                                param_specs)
from repro_torch.optim import opt_state_specs
from repro_torch.tree import tree_map, tree_paths
from repro_torch.weights import from_jax

COMMON = dict(dtype="float32", vocab_pad_multiple=32)
REDUCED = {   # tests/test_models_smoke.py
    "granite-3-2b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=131),
    "qwen3-moe-235b-a22b": dict(n_layers=2, d_model=64, n_heads=4,
                                n_kv_heads=2, d_ff=48, vocab_size=131,
                                n_experts=8, n_experts_per_tok=2,
                                moe_group_size=16, moe_capacity_factor=4.0),
    "llava-next-34b": dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
                           d_ff=128, vocab_size=131),
}
MODES = ("none", "sc_qat")
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "2x1x2": (2, 1, 2)}
B, S, N_IMG = 4, 16, 4          # llava: 4 image rows, then 12 text tokens
TOL = dict(metric=1e-5, params=2e-5, m=5e-5, v=1e-4)   # TINY_TRAIN_TOL
# the reference's serving layout where the port's departs (ROADMAP Queue 1
# item 11): the port serves every contraction whole
SERVING_DEPARTURES = {
    "mamba": {"in_proj", "x_proj", "out_proj"},
    "rwkv6": {"wr", "wk", "wv", "wg", "wo", "ln_x"},
    "rwkv_cmix": {"wk", "wv", "wr"},
    "moe": {"w_down"},
}


def _lr(s):
    return jwarmup_cosine(s + 1, 1e-3, 2, 10)


def _cfgs(arch, mode):
    jc = jget_arch(arch).scaled(attn_q_chunk=8, attn_kv_chunk=8, **COMMON,
                                **REDUCED[arch])
    c = get_arch(arch).scaled(**COMMON, **REDUCED[arch])
    return (jc.scaled(quant=jc.quant.with_mode(mode)),
            c.scaled(quant=c.quant.with_mode(mode)))


# -- the layouts --------------------------------------------------------------

def _tuples(spec_tree, lead: bool):
    """A reference spec tree with ``PartitionSpec`` (or logical tuple)
    leaves as tuples, the stacked leading axis dropped when ``lead``."""
    return jax.tree.map(
        lambda s: tuple(s)[1:] if lead else tuple(s), spec_tree,
        is_leaf=lambda s: isinstance(s, (tuple, jax.sharding.PartitionSpec)))


def _port_layout(jtree: dict, cfg, layers_key: str = "periods") -> dict:
    """The reference's spec tree in the port's layout: one entry a layer
    (layer i from period position i % len(period))."""
    out = {k: _tuples(v, False) for k, v in jtree.items() if k != layers_key}
    per = {k: _tuples(v, True) for k, v in jtree[layers_key].items()}
    out["layers"] = [per[f"p{i % len(cfg.period)}"]
                     for i in range(cfg.n_layers)]
    return out


def _leaf_diffs(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        return [d for k in want for d in _leaf_diffs(got[k], want[k],
                                                     f"{path}/{k}")]
    if isinstance(want, list):
        assert len(got) == len(want), path
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in _leaf_diffs(g, w, f"{path}/{i}")]
    return [] if tuple(got) == tuple(want) else [path]


def _departure(path: str, cfg) -> bool:
    parts = path.strip("/").split("/")
    if parts[0] != "layers":
        return False
    spec = cfg.period[int(parts[1]) % len(cfg.period)]
    kind = spec.mixer if parts[2] == "mixer" else spec.ffn
    return parts[3] in SERVING_DEPARTURES.get(kind, ())


@pytest.mark.parametrize("arch", sorted(set(jlist_archs())))
def test_layouts_equal_the_reference(arch):
    jc, c = jget_arch(arch), get_arch(arch)
    for serving in (False, True):
        got = param_specs(c, serving=serving)
        want = _port_layout(dict(jparam_specs(jc, serving=serving)), jc)
        diffs = _leaf_diffs(got, want)
        if not serving:
            assert diffs == [], diffs
        else:
            assert all(_departure(d, c) for d in diffs), diffs
    got = opt_state_specs(param_specs(c, serving=False))
    want = jopt_state_specs(jparam_specs(jc))
    assert got["count"] == tuple(want["count"])
    for k in ("m", "v"):
        assert _leaf_diffs(got[k], _port_layout(dict(want[k]), jc)) == []
    for kind in ("train", "prefill", "decode"):
        assert batch_specs(c, kind) == jbatch_specs(jc, kind)
    if not c.is_encoder:
        for kw in (dict(), dict(kv_head_shard=False), dict(seq_shard=True)):
            want = jcache_specs(jc, **kw)
            got = cache_specs(c, **kw)
            assert got["pos"] == tuple(want["pos"])
            assert _leaf_diffs(got, _port_layout(
                {k: v for k, v in want.items()}, jc)) == []


def test_multipod_mapping_and_the_production_mesh():
    assert multipod_mapping() == {k: tuple(v) for k, v in
                                  jmultipod_mapping().items()}
    # one process and no group: the production meshes need 256 / 512
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="needs"):
            make_production_mesh(multi_pod=multi)


# -- the train step -------------------------------------------------------------

def _batch(arch, seed=0):
    rng = np.random.default_rng(seed)
    v = REDUCED[arch]["vocab_size"]
    n_txt = S - N_IMG if arch == "llava-next-34b" else S
    b = {"tokens": rng.integers(0, v, (B, n_txt)).astype(np.int32),
         "targets": rng.integers(0, v, (B, S)).astype(np.int32),
         "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if arch == "llava-next-34b":
        b["patch_embeds"] = (0.02 * rng.standard_normal((B, N_IMG, 1024))) \
            .astype(np.float32)
        b["loss_mask"][:, :N_IMG] = 0.0
    return b


@functools.lru_cache(maxsize=None)
def _init(arch, mode):
    """The reference's initial state and the batch, and the case the port
    runs: its params as the port's numpy tree."""
    jc, c = _cfgs(arch, mode)
    jstate = jinit_train_state(jax.jit(jinit_params, static_argnums=1)(
        jax.random.key(0), jc), jc)
    port = from_jax(jax.tree.map(np.asarray, jstate.params), c, device="cpu")
    b = _batch(arch)
    case = dict(cfg=c, params=tree_map(lambda t: t.numpy(), port), batch=b)
    return jc, jstate, case


@functools.lru_cache(maxsize=None)
def _reference(arch, mode):
    """The reference's one step: its metrics and state, as numpy; under
    sc_qat, where the loss alone is held, its ``loss_fn`` (the step's
    loss, a smaller program to compile)."""
    jc, jstate, case = _init(arch, mode)
    if mode == "sc_qat":
        loss, _ = jax.jit(lambda p, b: jloss_fn(p, b, jc))(
            jstate.params, {k: jnp.asarray(v) for k, v in
                            case["batch"].items()})
        return {"metrics": {"loss": float(loss)}}
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
    """``case`` (sc_qat) in float64: the leaves the port makes in the
    model's dtype (weights, tables) and the batch's floats widened, the
    LSQ scales, norms and router kept float32 as ``init_params`` keeps
    them."""
    cfg = case["cfg"].scaled(dtype="float64")
    made = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = tree_map(lambda a, t: a.astype(t.numpy().dtype),
                      case["params"], made)
    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in case["batch"].items()}
    return dict(case, cfg=cfg, params=params, batch=batch)


def _decode_case():
    """Tiny granite mid-sequence: a seeded cache of 16 positions with 5
    written, 4 rows, the next token of each."""
    _, _, case = _init("granite-3-2b", "none")
    c = case["cfg"]
    rng = np.random.default_rng(5)
    kv = (4, 16, c.n_kv_heads, c.head_dim)
    layers = [{"k": rng.standard_normal(kv).astype(np.float32),
               "v": rng.standard_normal(kv).astype(np.float32)}
              for _ in range(c.n_layers)]
    return dict(cfg=c, params=case["params"],
                cache={"pos": np.array(5, dtype=np.int32), "layers": layers},
                tokens=rng.integers(0, c.vocab_size, (4, 1)).astype(np.int32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's per-rank results (each rank returns the whole state),
    mesh-off's, the reference's, and the checkpoint the (2, 2) mesh saved,
    restored onto a (1, 2) mesh beside a checkpoint the reference wrote.
    The ranks start first; the reference compiles while they run."""
    mw.run_all([functools.partial(_init, a, m) for a in REDUCED
                for m in MODES])
    cases = {f"{a}-{m}": _init(a, m)[2] for a in REDUCED for m in MODES}
    moe = cases["qwen3-moe-235b-a22b-none"]
    cases["qwen3-straddle"] = dict(moe, cfg=moe["cfg"].scaled(
        moe_group_size=B * S))
    for a in REDUCED:
        cases[f"{a}-sc_qat-f64"] = _float64(cases[f"{a}-sc_qat"])
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt"))
    jckpt = str(tmp_path_factory.mktemp("ref_ckpt"))
    jobs = {}
    for name, shape in MESHES.items():
        mine = dict(cases)
        if name == "2x2":
            mine["granite-3-2b-none"] = dict(cases["granite-3-2b-none"],
                                             ckpt_dir=ckpt)
            mine["granite-3-2b-compress"] = dict(
                cases["granite-3-2b-none"], grad_compress=True)
        jobs[name] = mw.Ranks(mw.train_mesh, int(np.prod(shape)), shape,
                              mine)
    dcase = _decode_case()
    decode = {name: mw.Ranks(mw.decode_mesh, int(np.prod(shape)), shape,
                             dcase)
              for name, shape in (("1x2", (1, 2)), ("2x2", (2, 2)))}
    ref = dict(zip(cases, mw.run_all(
        [functools.partial(_reference, a, m) for a in REDUCED
         for m in MODES])))
    off = {cid: mw.train_step_case(case) for cid, case in cases.items()}
    decode_off = mw.decode_step_case(dcase)
    off["granite-3-2b-compress"] = mw.train_step_case(
        dict(cases["granite-3-2b-none"], grad_compress=True))
    c = cases["granite-3-2b-none"]["cfg"]
    jparams = jinit_params(jax.random.key(3), _cfgs("granite-3-2b",
                                                    "none")[0])
    jsave_checkpoint(jckpt, 1, jparams, async_=False)
    per_rank = {name: job.collect(timeout=240) for name, job in jobs.items()}
    decoded = {name: job.collect(timeout=240) for name, job in decode.items()}
    target = tree_map(lambda t: t.numpy(),
                      init_params(c, torch.Generator().manual_seed(0), "cpu"))
    restored = mw.on_ranks(mw.restore_on_mesh, 2, (1, 2), c,
                           [(ckpt, "params", target), (jckpt, None, target)])
    return dict(per_rank=per_rank, off=off, ref=ref, ckpt=ckpt,
                jparams=jparams, restored=restored, cfg=c, decoded=decoded,
                decode_off=decode_off)


def _check(got, want, mode, label):
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
            assert err <= TOL[name], (label, name, k, err)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(REDUCED))
@pytest.mark.parametrize("mode", MODES)
def test_mesh_step_equals_mesh_off_and_reference(runs, arch, mode, mesh):
    cid = f"{arch}-{mode}"
    ranks = runs["per_rank"][mesh]
    got = ranks[0][cid]
    for other in ranks[1:]:        # every rank holds the same whole state
        assert other[cid]["metrics"] == got["metrics"]
        for k, v in got["params"].items():
            np.testing.assert_array_equal(other[cid]["params"][k], v)
    _check(got, runs["off"][cid], mode, f"{cid} {mesh} vs mesh-off")
    _check(got, runs["ref"][cid], mode, f"{cid} {mesh} vs reference")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(REDUCED))
def test_sc_qat_mesh_step_equals_mesh_off_in_float64(runs, arch, mesh):
    """Every leaf, the LSQ scales' (``alpha_*``) included, and the grad
    norm: a gradient scale sized from a rank's block, a scale's partial
    gradient left unsummed or summed twice parts them by a factor."""
    cid = f"{arch}-sc_qat-f64"
    _check(runs["per_rank"][mesh][0][cid], runs["off"][cid], "none",
           f"{cid} {mesh} vs mesh-off")


def test_mesh_off_step_equals_the_reference(runs):
    for cid, want in runs["ref"].items():
        _check(runs["off"][cid], want, cid.rsplit("-", 1)[1],
               f"{cid} mesh-off vs reference")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_groups_straddling_data_ranks(runs, mesh):
    _check(runs["per_rank"][mesh][0]["qwen3-straddle"],
           runs["off"]["qwen3-straddle"], "none",
           f"qwen3 straddling groups {mesh} vs mesh-off")


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_decode_over_a_time_cut_cache(runs, mesh):
    """float32, one token: logits within 1e-5 of the largest (the blocks'
    softmax merged by their log-sum-exp, sums in another order); the new
    K / V written where mesh-off writes them, layer 0's bit for bit (they
    read the embedding alone), a later layer's within 1e-5 of the
    largest (they read the layer below's output), every other position
    untouched."""
    want = runs["decode_off"]
    pos = 5
    for got in runs["decoded"][mesh]:
        err = np.abs(got["logits"] - want["logits"]).max()
        assert err <= 1e-5 * np.abs(want["logits"]).max(), (mesh, err)
        for k, v in want["cache"].items():
            g = got["cache"][k]
            if k == "pos" or k.startswith("layers/0/"):
                np.testing.assert_array_equal(g, v)
                continue
            rest = np.ones(v.shape[1], dtype=bool)
            rest[pos] = False
            np.testing.assert_array_equal(g[:, rest], v[:, rest])
            assert np.abs(g[:, pos] - v[:, pos]).max() <= \
                1e-5 * np.abs(v[:, pos]).max(), (mesh, k)


def test_grad_compress_on_a_mesh_equals_mesh_off(runs):
    """int8 gradient compression on the (2, 2) mesh: each scale the
    largest |g| over every rank's blocks of the leaves that share it (a
    layer's leaf at every period position).  The metrics and params at
    the tolerances; m (0.1 of the dequantized gradient) and v within their
    tolerances except where the uncompressed gradients, equal within
    float32 rounding, straddle an int8 rounding boundary: there m within
    one int8 level, v off at the same entries only, at most 0.1% of a
    leaf's entries."""
    cid = "granite-3-2b-compress"
    got, want = runs["per_rank"]["2x2"][0][cid], runs["off"][cid]
    _check(dict(got, m=want["m"], v=want["v"]), want, "none",
           "grad_compress 2x2 vs mesh-off")

    def key(k):
        return k.split("/", 2)[-1] if k.startswith("layers/") else k
    share: dict[str, float] = {}
    for k, w in want["m"].items():
        share[key(k)] = max(share.get(key(k), 0.0), float(np.abs(w).max()))
    for k, w in want["m"].items():
        d = np.abs(got["m"][k] - w)
        flips = d > TOL["m"] * np.abs(w).max()
        assert d.max() <= share[key(k)] / 127 * 1.0001, (k, d.max())
        assert flips.sum() <= max(1, w.size // 1000), (k, int(flips.sum()))
        wv = want["v"][k]
        v_off = np.abs(got["v"][k] - wv) > TOL["v"] * np.abs(wv).max()
        assert not (v_off & ~flips).any(), k


def test_checkpoint_reshards_bit_for_bit(runs):
    """Saved whole from the (2, 2) mesh's blocks; restored onto (1, 1) (no
    mesh) and onto (1, 2) (each rank its blocks, gathered again): the
    bits of the (2, 2) mesh's state."""
    saved = runs["per_rank"]["2x2"][0]["granite-3-2b-none"]["params"]
    c = runs["cfg"]
    tgt = init_params(c, torch.Generator().manual_seed(0), "cpu")
    whole = restore_checkpoint(runs["ckpt"], 1, {"params": tgt})["params"]
    for k, v in tree_paths(whole):
        np.testing.assert_array_equal(v.numpy(), saved[k])
    for rank, res in enumerate(runs["restored"]):
        (bits, shapes), (jbits, _) = res
        for k, v in saved.items():
            np.testing.assert_array_equal(bits[f"params/{k}"],
                                          v.view(np.int32))
        # each rank held its block: wq's output columns halved
        assert shapes["params/layers/0/mixer/wq/w"] == (64, 32), rank
        want = from_jax(jax.tree.map(np.asarray, runs["jparams"]), c,
                        device="cpu")
        for k, v in tree_paths(want):
            np.testing.assert_array_equal(jbits[k], v.numpy().view(np.int32))

"""The port's paged-attention plain versions against the reference's
Pallas kernels (interpret mode), the dispatch rule, the CUDA wrappers'
input checks, and the kernels' ctypes signatures against their C sources.

The plain versions (``repro_torch.kernels.ref``) are what the CPU runs
and what the CUDA kernels are held against on the card; here they are
held against ``paged_attn_*_pallas(interpret=True)`` on the same numpy
inputs.  Float32: tolerance ``atol=2e-6, rtol=2e-5`` (the reference's own
kernel-vs-reference tolerance: the two softmaxes sum in different
orders).  bf16 q at granite-3-2b's head geometry (G 4, D 64, page 16):
both sides compute in float32 and round to bf16, so an output may land
one bf16 ulp apart: ``atol=1e-2`` (one ulp at |o| <= 2 is 7.8e-3).
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kv_quant as jkv
from repro.kernels.paged_attention import (paged_attn_decode_pallas,
                                           paged_attn_prefill_pallas)
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.approx_bsn import (approx_bsn_cuda,
                                            approx_bsn_temporal_cuda)
from repro_torch.kernels.bsn_sort import bsn_sort_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.paged_attention import (paged_attn_decode_cuda,
                                                 paged_attn_prefill_cuda)
from repro_torch.kernels.ref import (paged_attn_decode_ref,
                                     paged_attn_prefill_ref)
from repro_torch.kernels.ternary_matmul import ternary_matmul_cuda
from port_fixtures import _one_torch_thread  # noqa: F401


TOL = dict(rtol=2e-5, atol=2e-6)
BF16_TOL = dict(rtol=0, atol=1e-2)
POISON = 3.0e4


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bf16_values(a):
    """float32 numpy values exactly representable in bf16."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _case(seed, S, Hkv, D, page, maxp, fmt, bf16=False):
    """Pools the way the allocator hands pages out (page 0 = trash,
    distinct pages per slot), quantized with the reference's kv_quant
    (op by op) so both sides read identical codes and scales; ``bf16``
    draws values exact in bf16 (an fp pool is then cast to bf16)."""
    rng = np.random.default_rng(seed)
    n = S * maxp + 1
    pools = {}
    for name in ("k", "v"):
        x = rng.standard_normal((n, page, Hkv, D)).astype(np.float32)
        if bf16:
            x = _bf16_values(x)
        qd = jkv.kv_quant(jnp.asarray(x), fmt)
        pools[f"{name}_pages"] = np.asarray(qd["q"])
        if "scale" in qd:
            pools[f"{name}_scale"] = np.asarray(qd["scale"])
        if "resid" in qd:
            pools[f"{name}_resid"] = np.asarray(qd["resid"])
    tables = np.zeros((S, maxp), np.int32)
    for s in range(S):
        tables[s] = 1 + s * maxp + rng.permutation(maxp)
    return rng, pools, tables


def _aux(pools, to):
    return {k: to(v) for k, v in pools.items() if not k.endswith("_pages")}


def _decode_both(q, pools, tables, lengths, fmt, num_splits):
    want = paged_attn_decode_pallas(
        jnp.asarray(q), jnp.asarray(pools["k_pages"]),
        jnp.asarray(pools["v_pages"]), jnp.asarray(tables),
        jnp.asarray(lengths), num_splits=num_splits, interpret=True,
        kv_format=fmt, **_aux(pools, jnp.asarray))
    got = paged_attn_decode_ref(
        _t(q), _t(pools["k_pages"]), _t(pools["v_pages"]), _t(tables),
        _t(lengths), kv_format=fmt, kv_aux=_aux(pools, _t))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
@pytest.mark.parametrize("num_splits", [1, 2])
def test_decode_plain_vs_pallas(fmt, num_splits):
    S, Hkv, G, D, page, maxp = 3, 2, 2, 16, 8, 4
    rng, pools, tables = _case(S * D + num_splits, S, Hkv, D, page, maxp,
                               fmt)
    q = rng.standard_normal((S, Hkv, G, D)).astype(np.float32)
    lengths = rng.integers(0, maxp * page, S).astype(np.int32)
    got, want = _decode_both(q, pools, tables, lengths, fmt, num_splits)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("rem", [0, 1, -1])
def test_decode_lengths_straddle_page_boundaries(rem):
    """(length + 1) % page in {1, 2, 0}: the mask cuts exactly at the
    boundary whether the live window ends a page, just enters one, or
    stops one short."""
    S, Hkv, G, D, page, maxp = 3, 2, 2, 16, 8, 4
    rng, pools, tables = _case(7 + rem, S, Hkv, D, page, maxp, "int8")
    q = rng.standard_normal((S, Hkv, G, D)).astype(np.float32)
    lengths = np.array([(k * page + rem) % (maxp * page) for k in (1, 2, 3)],
                       np.int32)
    got, want = _decode_both(q, pools, tables, lengths, "int8", 2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fmt", ["fp", "sc"])
def test_decode_padded_lanes_and_poisoned_pages(fmt):
    """A padded lane (length 0, all-trash table) and poison on the trash
    page and every page past each live length: live lanes are
    bit-identical to the clean run, and still agree with the reference."""
    S, Hkv, G, D, page, maxp = 4, 2, 2, 16, 8, 4
    rng, pools, tables = _case(11, S, Hkv, D, page, maxp, fmt)
    q = rng.standard_normal((S, Hkv, G, D)).astype(np.float32)
    tables[0] = 0
    lengths = np.array([0, 5, page, 2 * page - 1], np.int32)
    clean, want = _decode_both(q, pools, tables, lengths, fmt, 1)
    np.testing.assert_allclose(clean, want, **TOL)
    pois = {k: v.copy() for k, v in pools.items()}
    dead = {0} | {int(tables[s, j]) for s in range(1, S)
                  for j in range(int(lengths[s]) // page + 1, maxp)}
    for v in pois.values():
        v[sorted(dead)] = 127 if v.dtype == np.int8 else POISON
    got = paged_attn_decode_ref(
        _t(q), _t(pois["k_pages"]), _t(pois["v_pages"]), _t(tables),
        _t(lengths), kv_format=fmt, kv_aux=_aux(pois, _t)).numpy()
    np.testing.assert_array_equal(got[1:], clean[1:])


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
@pytest.mark.parametrize("G,Hkv,Gq,D,page,C,start", [
    (2, 2, 2, 16, 8, 16, 0),
    (2, 2, 2, 16, 8, 16, 16),     # a later chunk sees earlier pages
    (3, 1, 4, 8, 4, 8, 24),
])
def test_prefill_plain_vs_pallas(fmt, G, Hkv, Gq, D, page, C, start):
    maxp = (start + C) // page + 1
    rng, pools, tables = _case(G * C + start, G, Hkv, D, page, maxp, fmt)
    q = rng.standard_normal((G, C, Hkv, Gq, D)).astype(np.float32)
    want = paged_attn_prefill_pallas(
        jnp.asarray(q), jnp.asarray(pools["k_pages"]),
        jnp.asarray(pools["v_pages"]), jnp.asarray(tables), start=start,
        block_q=8, interpret=True, kv_format=fmt,
        **_aux(pools, jnp.asarray))
    got = paged_attn_prefill_ref(
        _t(q), _t(pools["k_pages"]), _t(pools["v_pages"]), _t(tables),
        start, kv_format=fmt, kv_aux=_aux(pools, _t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_future_pages_poison_invisible():
    G, Hkv, Gq, D, page, C, start, maxp = 2, 2, 2, 16, 8, 16, 8, 6
    rng, pools, tables = _case(13, G, Hkv, D, page, maxp, "fp")
    q = _t(rng.standard_normal((G, C, Hkv, Gq, D)).astype(np.float32))
    clean = paged_attn_prefill_ref(q, _t(pools["k_pages"]),
                                   _t(pools["v_pages"]), _t(tables), start)
    seen = (start + C) // page
    dead = [0] + [int(tables[g, j]) for g in range(G)
                  for j in range(seen, maxp)]
    kp, vp = pools["k_pages"].copy(), pools["v_pages"].copy()
    kp[dead] = POISON
    vp[dead] = POISON
    pois = paged_attn_prefill_ref(q, _t(kp), _t(vp), _t(tables), start)
    np.testing.assert_array_equal(pois.numpy(), clean.numpy())


# ---------------------------------------------------------------------------
# dispatch: the device decides, nothing else
# ---------------------------------------------------------------------------

def test_dispatch_sends_cpu_tensors_to_the_plain_versions():
    """On CPU tensors dispatch runs the plain version and launches no
    kernel (the launch counts stay 0)."""
    build.reset_launches()
    S, Hkv, G, D, page, maxp = 2, 2, 2, 8, 4, 2
    rng, pools, tables = _case(1, S, Hkv, D, page, maxp, "fp")
    q = _t(rng.standard_normal((S, Hkv, G, D)).astype(np.float32))
    lengths = _t(np.array([3, 6], np.int32))
    got = dispatch.paged_attn_decode(q, _t(pools["k_pages"]),
                                     _t(pools["v_pages"]), _t(tables),
                                     lengths)
    want = paged_attn_decode_ref(q, _t(pools["k_pages"]),
                                 _t(pools["v_pages"]), _t(tables), lengths)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert build.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never falls back: given a CPU tensor it raises."""
    counts = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        approx_bsn_cuda(counts, in_bsl=8, stages=((16, 0, 1),))
    q = torch.zeros((1, 1, 1, 8))
    pool = torch.zeros((2, 4, 1, 8))
    tables = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attn_decode_cuda(q, pool, pool, tables,
                               torch.zeros((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attn_prefill_cuda(q.reshape(1, 1, 1, 1, 8).expand(
            1, 4, 1, 1, 8).contiguous(), pool, pool, tables, start=0)
    with pytest.raises(ValueError, match="CUDA"):
        approx_bsn_temporal_cuda(torch.zeros((4, 32), dtype=torch.int32),
                                 in_bsl=8, stages=((16, 0, 1),), cycles=2)
    x_q = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        ternary_matmul_cuda(x_q, torch.zeros((8, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="CUDA"):
        bsn_sort_cuda(x_q)
    qkv = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(qkv, qkv, qkv)
    assert build.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


def test_build_flags_target_sm90a_with_a_plain_c_interface():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    srcs = sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert srcs == ["approx_bsn.cu", "bsn_sort.cu", "errors.cu",
                    "flash_attention.cu", "paged_attention.cu",
                    "tensor_map.cu", "ternary_matmul.cu"]
    for p in build.CSRC.glob("*.cu*"):
        assert "torch/extension.h" not in p.read_text()


# ---------------------------------------------------------------------------
# bf16 q at granite-3-2b's head geometry: the serving path's dtypes
# ---------------------------------------------------------------------------

GRANITE_HEADS = dict(G=4, D=64, page=16)


def _jnp(a, bf16=False):
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if bf16 else x


def _torch(a, bf16=False):
    x = _t(a)
    return x.to(torch.bfloat16) if bf16 else x


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
@pytest.mark.parametrize("num_splits", [1, 4])
def test_decode_plain_vs_pallas_bf16_long_lanes(fmt, num_splits):
    """Lengths 5, 1100 and 1791 span one, three and four of the CUDA
    kernel's 512-position splits; the JAX side runs 1 or 4 splits."""
    S, Hkv, maxp = 3, 2, 112
    G, D, page = GRANITE_HEADS["G"], GRANITE_HEADS["D"], GRANITE_HEADS["page"]
    rng, pools, tables = _case(31 + num_splits, S, Hkv, D, page, maxp, fmt,
                               bf16=True)
    q = _bf16_values(rng.standard_normal((S, Hkv, G, D)).astype(np.float32))
    lengths = np.array([5, 1100, 1791], np.int32)
    fp = fmt == "fp"
    want = paged_attn_decode_pallas(
        _jnp(q, True), _jnp(pools["k_pages"], fp), _jnp(pools["v_pages"], fp),
        jnp.asarray(tables), jnp.asarray(lengths), num_splits=num_splits,
        interpret=True, kv_format=fmt, **_aux(pools, jnp.asarray))
    got = paged_attn_decode_ref(
        _torch(q, True), _torch(pools["k_pages"], fp),
        _torch(pools["v_pages"], fp), _t(tables), _t(lengths),
        kv_format=fmt, kv_aux=_aux(pools, _t))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
def test_prefill_plain_vs_pallas_bf16_late_chunk(fmt):
    """A 32-token chunk at start 256 (pages 0-17 seen) of two requests."""
    Gr, C, Hkv, start = 2, 32, 2, 256
    Gq, D, page = GRANITE_HEADS["G"], GRANITE_HEADS["D"], GRANITE_HEADS["page"]
    maxp = (start + C) // page + 1
    rng, pools, tables = _case(41, Gr, Hkv, D, page, maxp, fmt, bf16=True)
    q = _bf16_values(rng.standard_normal((Gr, C, Hkv, Gq, D))
                     .astype(np.float32))
    fp = fmt == "fp"
    want = paged_attn_prefill_pallas(
        _jnp(q, True), _jnp(pools["k_pages"], fp), _jnp(pools["v_pages"], fp),
        jnp.asarray(tables), start=start, block_q=16, interpret=True,
        kv_format=fmt, **_aux(pools, jnp.asarray))
    got = paged_attn_prefill_ref(
        _torch(q, True), _torch(pools["k_pages"], fp),
        _torch(pools["v_pages"], fp), _t(tables), start, kv_format=fmt,
        kv_aux=_aux(pools, _t))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


# ---------------------------------------------------------------------------
# the ctypes signatures against the C entry points (a mismatch would show
# only on the card, as a wrong argument)
# ---------------------------------------------------------------------------

def _c_params(name):
    """Kinds of the parameters of ``extern "C" int name(...)`` in csrc."""
    pat = re.compile(r'extern "C" int\s+' + re.escape(name)
                     + r"\s*\(([^)]*)\)", re.S)
    found = [m.group(1) for p in sorted(build.CSRC.glob("*.cu"))
             for m in pat.finditer(p.read_text())]
    assert len(found) == 1, (name, found)
    params = [x.strip() for x in found[0].split(",") if x.strip()]
    if params == ["void"]:
        params = []
    kinds = []
    for p in params:
        if "*" in p:
            kinds.append("pointer")
        else:
            kinds.append(p.split()[-2] if len(p.split()) > 1 else p)
    return kinds


def _ctypes_kind(t):
    if t is ctypes.c_void_p or (isinstance(t, type)
                                and issubclass(t, ctypes._Pointer)):
        return "pointer"
    return {ctypes.c_int: "int", ctypes.c_float: "float"}[t]


@pytest.mark.parametrize("name", sorted(build._SIGNATURES))
def test_ctypes_signature_matches_the_c_entry_point(name):
    assert [_ctypes_kind(t) for t in build._SIGNATURES[name]] == \
        _c_params(name)

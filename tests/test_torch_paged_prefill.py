"""The bf16 paged prefill's wgmma route (``csrc/paged_attention.cu``,
``paged_prefill_wgmma_kernel``) on the CPU: the range its joined sc
operand rests on, the arithmetic its producer widens codes with, its
launch plan, and the plain version it is held against on the card at its
head geometries, against the reference's Pallas kernel (interpret mode).

The kernel multiplies sc's 16 code + resid as one bf16 operand.  That is
exact because kv_quant clips every code and residual to +-8
(``core/kv_quant.py``), so the joined value lies in [-136, 136] and bf16
holds every integer up to 256.  The tests hold the clip (hypothesis,
extreme inputs, all-zero rows) and the exactness of every step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from port_fixtures import _one_torch_thread  # noqa: F401
from repro.core import kv_quant as jkv
from repro.kernels.paged_attention import paged_attn_prefill_pallas
from repro_torch.core.kv_quant import SC_COARSE_BSL, SC_RESID_BSL, kv_quant
from repro_torch.kernels import plan as kp
from repro_torch.kernels.ref import paged_attn_prefill_ref

BF16_TOL = dict(rtol=0, atol=1e-2)   # one bf16 ulp at |o| <= 2 is 7.8e-3
_B = np.float32(2 ** 23 + 128)       # the producer's bias
_F32_BIG = float(np.float32(3.0e38))


def _biased(b: np.ndarray) -> np.ndarray:
    """int8 b as the float 2^23 + (b + 128): the byte b ^ 0x80 in the
    mantissa of 2^23, as the producer's PRMT places it."""
    u = (b.astype(np.int16) + 128).astype(np.uint32)
    return (np.uint32(0x4B000000) | u).view(np.float32)


@pytest.mark.parametrize("code", range(-SC_COARSE_BSL // 2,
                                       SC_COARSE_BSL // 2 + 1))
def test_sc_joined_value_is_exact_in_bf16(code):
    """Every (code, resid) kv_quant can write joins to an integer bf16
    holds exactly."""
    half = SC_RESID_BSL // 2
    resid = torch.arange(-half, half + 1, dtype=torch.int32)
    joined = (16 * code + resid).to(torch.float32)
    assert joined.abs().max() <= 136
    assert torch.equal(joined.to(torch.bfloat16).to(torch.float32), joined)


def test_widening_steps_are_exact_for_every_int8_pair():
    """The producer's float steps, (c' - B) 16 + r' - B with c', r' the
    biased bytes, give 16 code + resid exactly for all 65536 int8 pairs,
    and the int8 path's c' - B the code; the bf16 rounding that follows
    is exact exactly where |16 code + resid| <= 256 or the value needs
    no more than bf16's 8 bits."""
    c, r = np.meshgrid(np.arange(-128, 128, dtype=np.int8),
                       np.arange(-128, 128, dtype=np.int8), indexing="ij")
    code = _biased(c) - _B
    np.testing.assert_array_equal(code, c.astype(np.float32))
    joined = (code * np.float32(16) + _biased(r)) - _B
    want = 16 * c.astype(np.int32) + r.astype(np.int32)
    np.testing.assert_array_equal(joined, want.astype(np.float32))
    as_bf16 = torch.from_numpy(joined).to(torch.bfloat16).float().numpy()
    exact = as_bf16 == joined
    assert exact[np.abs(want) <= 256].all()
    in_range = (np.abs(c.astype(np.int32)) <= 8) & (np.abs(
        r.astype(np.int32)) <= 8)
    assert exact[in_range].all() and not exact.all()


def _codes_in_range(x: torch.Tensor) -> None:
    qd = kv_quant(x, "sc")
    for name, bsl in (("q", SC_COARSE_BSL), ("resid", SC_RESID_BSL)):
        v = qd[name]
        assert v.dtype == torch.int8
        assert int(v.abs().max()) <= bsl // 2, name


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.lists(st.floats(min_value=-_F32_BIG, max_value=_F32_BIG,
                          allow_nan=False, allow_infinity=False, width=32),
                min_size=16, max_size=16),
       st.sampled_from([torch.float32, torch.bfloat16]))
def test_kv_quant_sc_never_writes_past_8(values, dtype):
    """kv_quant(., "sc") clips each code and residual to +-8 for any
    finite row (one KV head's D values), in float32 and in bf16."""
    x = torch.tensor(values, dtype=torch.float32)
    if dtype == torch.bfloat16:          # stays finite when rounded
        x = x.clamp(-3.0e38, 3.0e38)
    _codes_in_range(x.to(dtype).reshape(1, 1, 16))


@pytest.mark.parametrize("case", ["zeros", "subnormal", "tiny", "huge",
                                  "one_big", "ties"])
def test_kv_quant_sc_extremes_stay_within_8(case):
    """All-zero rows, subnormal and near-underflow rows, rows near the
    float32 maximum, one outlier beside tiny values, and values on the
    rounding ties of both levels."""
    d = 64
    if case == "zeros":
        x = torch.zeros(3, 2, d)
    elif case == "subnormal":
        x = torch.full((3, 2, d), 1e-45) * torch.arange(d)
    elif case == "tiny":
        x = torch.linspace(-1.2e-38, 1.2e-38, 6 * d).reshape(3, 2, d)
    elif case == "huge":
        x = torch.linspace(-3.4e38, 3.4e38, 6 * d).reshape(3, 2, d)
    elif case == "one_big":
        x = torch.full((3, 2, d), 1e-30)
        x[..., 7] = -1e30
    else:
        # amax 8: scale 1, codes on half-integers; residuals on their ties
        x = (torch.arange(6 * d, dtype=torch.float32).reshape(3, 2, d) % 33
             - 16) / 2
        x[..., 0] = 8.0
        x[..., 1] += 1 / 32
    for dtype in (torch.float32, torch.bfloat16):
        _codes_in_range(x.to(dtype))


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,page,q_dtype,kind,code", [
    (64, 16, kp.Q_BF16, kp.KV_BF16, 2), (64, 16, kp.Q_BF16, kp.KV_INT8, 2),
    (64, 16, kp.Q_BF16, kp.KV_SC, 2), (128, 16, kp.Q_BF16, kp.KV_SC, 2),
    (128, 16, kp.Q_BF16, kp.KV_BF16, 2), (64, 32, kp.Q_BF16, kp.KV_BF16, 1),
    (64, 8, kp.Q_BF16, kp.KV_INT8, 1), (128, 4, kp.Q_BF16, kp.KV_SC, 1),
    (32, 16, kp.Q_BF16, kp.KV_BF16, 1), (16, 16, kp.Q_BF16, kp.KV_SC, 1),
    (64, 16, kp.Q_F32, kp.KV_INT8, 0), (64, 16, kp.Q_BF16, kp.KV_F32, 0)])
def test_prefill_plan_routes_by_dtype_head_dim_and_page(D, page, q_dtype,
                                                        kind, code):
    """The kernel is chosen by dtype, head dim and page size alone: the
    same for every block_q, C and start."""
    assert kp.paged_prefill_kernel_code(D, page, kind, q_dtype) == code
    name = kp.PAGED_PREFILL_KERNELS[code]
    for C, start, block_q in ((64, 64, 32), (32, 4032, 8), (16, 0, 1),
                              (128, 960, 64)):
        width = (start + C) // page + 1
        plan = kp.paged_prefill_plan(G=2, C=C, Hkv=2, Gq=4, D=D, page=page,
                                     width=width, start=start,
                                     num_pages=2 * width + 1, kv_kind=kind,
                                     block_q=block_q, q_dtype=q_dtype)
        assert plan.code == code
        assert plan.kernel.startswith(f"{len(name)}{name}")
        assert plan.smem <= kp.SMEM_CAP


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kind", [kp.KV_BF16, kp.KV_INT8, kp.KV_SC])
def test_wgmma_prefill_layout_fits_and_aligns(D, kind):
    """PwLayout: within a block's shared memory, every 128B-swizzled box
    (the stages' K and V page boxes, the consumers' q boxes) 1024-byte
    aligned, the barriers past them; threads one producer and one
    consumer warpgroup a 64 rows, at most two consumers."""
    lay = kp.pw_layout(D, kind)
    assert lay["bytes"] <= kp.SMEM_CAP
    offs = kp.pw_box_offsets(D, kind)
    assert offs and all(o % 1024 == 0 for o in offs)
    assert len(set(offs)) == len(offs)
    assert max(offs) + 64 * 128 <= lay["scale_off"] <= lay["bar_off"]
    assert lay["bar_off"] % 8 == 0 and lay["bytes"] > lay["bar_off"]
    if kind != kp.KV_BF16:
        # the raw ring holds whole int8 pages where TMA lands them
        assert lay["raw_off"] % 1024 == 0 and lay["raw"] % 1024 == 0
    for Gq, block_q, threads in ((4, 32, 384), (4, 16, 256), (1, 32, 256),
                                 (16, 32, 384), (5, 32, 384), (32, 8, 384),
                                 (8, 4, 256)):
        plan = kp.paged_prefill_plan(G=1, C=64, Hkv=2, Gq=Gq, D=D, page=16,
                                     width=8, start=64, num_pages=9,
                                     kv_kind=kind, block_q=block_q)
        assert (plan.code, plan.threads, plan.smem) == (2, threads,
                                                        lay["bytes"])


# ---------------------------------------------------------------------------
# the plain version at the wgmma kernel's head geometries
# ---------------------------------------------------------------------------

def _pools(rng, n, page, Hkv, D, fmt):
    pools = {}
    for name in ("k", "v"):
        x = rng.standard_normal((n, page, Hkv, D)).astype(np.float32)
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        qd = jkv.kv_quant(jnp.asarray(x), fmt)
        pools[f"{name}_pages"] = np.asarray(qd["q"])
        for k in ("scale", "resid"):
            if k in qd:
                pools[f"{name}_{k}"] = np.asarray(qd[k])
    return pools


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
@pytest.mark.parametrize("Gq,D,C,start", [(16, 64, 16, 48),
                                          (8, 128, 16, 32)])
def test_prefill_plain_vs_pallas_at_the_wgmma_heads(fmt, Gq, D, C, start):
    """qwen3-moe's GQA group of 16 at D 64 and jamba's D 128, on the
    engine's 16-position pages, a chunk ending inside a 64-key tile:
    the port's plain version against the reference's Pallas kernel in
    bf16 (one bf16 ulp)."""
    page, Hkv, G = 16, 1, 2
    width = (start + C) // page + 1
    rng = np.random.default_rng(Gq + D)
    pools = _pools(rng, G * width + 1, page, Hkv, D, fmt)
    tables = (1 + np.arange(G * width, dtype=np.int32)
              .reshape(G, width)[:, ::-1]).copy()
    q = rng.standard_normal((G, C, Hkv, Gq, D)).astype(np.float32)
    q = torch.from_numpy(q).to(torch.bfloat16)
    aux = {k: v for k, v in pools.items() if not k.endswith("_pages")}
    fp = fmt == "fp"

    def jx(a, cast):
        a = jnp.asarray(a)
        return a.astype(jnp.bfloat16) if cast else a

    def tt(a, cast):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(torch.bfloat16) if cast else t
    want = paged_attn_prefill_pallas(
        jnp.asarray(q.float().numpy()).astype(jnp.bfloat16),
        jx(pools["k_pages"], fp), jx(pools["v_pages"], fp),
        jnp.asarray(tables), start=start, block_q=16, interpret=True,
        kv_format=fmt, **{k: jnp.asarray(v) for k, v in aux.items()})
    got = paged_attn_prefill_ref(
        q, tt(pools["k_pages"], fp), tt(pools["v_pages"], fp),
        torch.from_numpy(tables), start, kv_format=fmt,
        kv_aux={k: tt(v, False) for k, v in aux.items()})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)

"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; the
file imports torch only (no JAX), so it runs where the card is:

    python -m pytest -q tests/test_torch_cuda.py

float32 inputs at small shapes; attention within ``atol=rtol=1e-5``
(fp32 online softmax against the gathered softmax: the sums run in a
different order); the paged kernels with bf16 q (split decode, tensor-
core prefill) within ``atol=1e-2`` on O, and bit for bit where a lane's
or a row's output must not depend on the batch, block_q or chunk; the
BSN adders, the ternary matmul (with and without its SI epilogue) and
the sort bit for bit.  The flash kernels in bfloat16
(wgmma at D 64, 80 and 128, mma.sync at D 16 and 32) within ``atol=1e-2``
on O (one bf16 ulp at |o| <= 2 is 7.8e-3) and ``atol=rtol=1e-5`` on
their float32 LSE, and bit for bit where a row must not depend on the
batch; in float32 (the CUDA-core kernel) within ``atol=rtol=1e-5`` on
both.
"""

import re

import pytest
import torch

from repro_torch.core.bsn import default_approx_spec, spec_stages
from repro_torch.core.kv_quant import kv_quant
from repro_torch.core.sc_layers import SCQuantConfig, sc_linear_int_from_qat
from repro_torch.kernels import build, dispatch, ops
from repro_torch.kernels.approx_bsn import (approx_bsn_cuda, approx_bsn_plain,
                                            approx_bsn_temporal_cuda,
                                            approx_bsn_temporal_plain)
from repro_torch.kernels.bsn_sort import bsn_sort_cuda, bsn_sort_plain
from repro_torch.kernels.flash_attention import (flash_attention_backward,
                                                 flash_attention_cuda)
from repro_torch.kernels.paged_attention import (paged_attn_decode_cuda,
                                                 paged_attn_prefill_cuda)
from repro_torch.kernels.ref import (flash_attention_ref,
                                     paged_attn_decode_ref,
                                     paged_attn_prefill_ref,
                                     ternary_matmul_ref)
from repro_torch.kernels.ternary_matmul import ternary_matmul_cuda

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(dev, fmt, S=3, Hkv=2, D=16, page=8, maxp=4, seed=0, bf16=False):
    """Pools and tables (S, maxp) of distinct pages (page 0 = trash); with
    ``bf16`` the values are bf16 before kv_quant (fp pools stay bf16)."""
    gen = torch.Generator(dev).manual_seed(seed)
    n = S * maxp + 1
    pools = {}
    for name in ("k", "v"):
        x = torch.randn((n, page, Hkv, D), generator=gen, device=dev)
        qd = kv_quant(x.to(torch.bfloat16) if bf16 else x, fmt)
        pools[f"{name}_pages"] = qd["q"].contiguous()
        if "scale" in qd:
            pools[f"{name}_scale"] = qd["scale"].contiguous()
        if "resid" in qd:
            pools[f"{name}_resid"] = qd["resid"].contiguous()
    perm = torch.randperm(n - 1, generator=gen, device=dev) + 1
    tables = perm.reshape(S, maxp).to(torch.int32)
    aux = {k: v for k, v in pools.items() if not k.endswith("_pages")}
    return gen, pools, tables, aux


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
def test_decode_kernel_matches_plain(cuda, fmt):
    gen, pools, tables, aux = _case(cuda, fmt)
    tables[0] = 0                                    # a padded lane
    q = torch.randn((3, 2, 2, 16), generator=gen, device=cuda)
    lengths = torch.tensor([0, 9, 31], dtype=torch.int32, device=cuda)
    args = (q, pools["k_pages"], pools["v_pages"], tables, lengths)
    got = paged_attn_decode_cuda(*args, kv_format=fmt, **aux)
    want = paged_attn_decode_ref(*args, kv_format=fmt, kv_aux=aux)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
@pytest.mark.parametrize("start,block_q", [(0, 32), (8, 8), (16, 5)])
def test_prefill_kernel_matches_plain(cuda, fmt, start, block_q):
    gen, pools, tables, aux = _case(cuda, fmt)
    q = torch.randn((3, 16, 2, 2, 16), generator=gen, device=cuda)
    args = (q, pools["k_pages"], pools["v_pages"], tables)
    got = paged_attn_prefill_cuda(*args, start=start, block_q=block_q,
                                  kv_format=fmt, **aux)
    want = paged_attn_prefill_ref(*args, start, kv_format=fmt, kv_aux=aux)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("stages", [
    spec_stages(default_approx_spec(256, 8)),
    ((8, 2, 4), (32, 0, 2)),
    ((4, 0, 1), (8, 2, 3), (8, 0, 2)),
])
def test_approx_bsn_kernel_bit_exact(cuda, stages):
    counts = torch.randint(0, 9, (37, 256), dtype=torch.int32, device=cuda)
    got = approx_bsn_cuda(counts, in_bsl=8, stages=stages)
    assert torch.equal(got, approx_bsn_plain(counts, in_bsl=8,
                                             stages=stages))


def test_dispatch_launches_the_kernels_on_cuda_tensors(cuda):
    build.reset_launches()
    gen, pools, tables, aux = _case(cuda, "fp")
    q = torch.randn((3, 2, 2, 16), generator=gen, device=cuda)
    lengths = torch.tensor([1, 2, 3], dtype=torch.int32, device=cuda)
    dispatch.paged_attn_decode(q, pools["k_pages"], pools["v_pages"],
                               tables, lengths)
    dispatch.paged_attn_prefill(q.reshape(3, 1, 2, 2, 16).expand(
        3, 8, 2, 2, 16).contiguous(), pools["k_pages"], pools["v_pages"],
        tables, 0)
    dispatch.approx_bsn(torch.zeros((2, 3, 256), dtype=torch.int32,
                                    device=cuda),
                        default_approx_spec(256, 8))
    dispatch.approx_bsn(torch.zeros((2, 512), dtype=torch.int32,
                                    device=cuda),
                        default_approx_spec(256, 8), cycles=2)
    ops.ternary_matmul(torch.zeros((3, 8), dtype=torch.int8, device=cuda),
                       torch.zeros((8, 4), dtype=torch.int8, device=cuda))
    ops.ternary_matmul(torch.zeros((2, 3, 8), dtype=torch.int8, device=cuda),
                       torch.zeros((2, 8, 4), dtype=torch.int8, device=cuda))
    ops.bsn_sort(torch.zeros((3, 8), dtype=torch.int8, device=cuda))
    qkv = torch.zeros((1, 8, 2, 16), device=cuda)
    dispatch.flash_attention(qkv, qkv, qkv)
    assert build.LAUNCHES == dict.fromkeys(build.KERNELS, 1)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    gen, pools, tables, aux = _case(cuda, "int8")
    q = torch.randn((3, 2, 2, 16), generator=gen, device=cuda)
    lengths = torch.tensor([1, 2, 3], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="k_scale"):
        paged_attn_decode_cuda(q, pools["k_pages"], pools["v_pages"],
                               tables, lengths, kv_format="int8")
    with pytest.raises(ValueError, match="lengths"):
        paged_attn_decode_cuda(q, pools["k_pages"], pools["v_pages"],
                               tables, lengths.long(), kv_format="int8",
                               **aux)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        paged_attn_decode_cuda(q.half(), pools["k_pages"], pools["v_pages"],
                               tables, lengths, kv_format="int8", **aux)
    with pytest.raises(ValueError, match="int32"):
        approx_bsn_cuda(torch.zeros((2, 16), device=cuda), in_bsl=8,
                        stages=((16, 0, 1),))


def test_launch_refuses_layouts_above_the_shared_memory_cap(cuda):
    """The C side owns each kernel's shared-memory layout: a layout above
    a block's cap is refused at launch with the kernel and the bytes."""
    build.reset_launches()
    q = torch.zeros((1, 1, 16, 1024), device=cuda)
    pages = torch.zeros((2, 64, 1, 1024), device=cuda)
    tables = torch.ones((1, 1), dtype=torch.int32, device=cuda)
    lengths = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError,
                       match=r"paged_attn_decode needs \d+ bytes of shared"):
        paged_attn_decode_cuda(q, pages, pages, tables, lengths)
    counts = torch.zeros((1, 2 ** 17), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError,
                       match=r"approx_bsn needs 524292 bytes of shared"):
        approx_bsn_cuda(counts, in_bsl=8, stages=((1, 0, 1), (2 ** 17, 0, 1)))
    assert build.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


# ---------------------------------------------------------------------------
# bf16 q over bf16 / int8 / sc pools: the split decode and the tensor-core
# prefill (O within 1e-2: one bf16 ulp at |o| <= 2 is 7.8e-3)
# ---------------------------------------------------------------------------

BF16_O = dict(rtol=0, atol=1e-2)


def _bf16_decode_case(dev, fmt, lens, maxp, Hkv=2, G=4, D=64, page=16,
                      seed=0):
    """Lanes with distinct pages; a lane of length 0 is a padded lane
    (all-trash table)."""
    S = len(lens)
    gen, pools, tables, aux = _case(dev, fmt, S, Hkv, D, page, maxp, seed,
                                    bf16=True)
    for s, n in enumerate(lens):
        if n == 0:
            tables[s] = 0
    q = torch.randn((S, Hkv, G, D), generator=gen, device=dev) \
        .to(torch.bfloat16)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, pools, aux, tables, lengths


def _decode_both(fmt, q, pools, aux, tables, lengths):
    args = (q, pools["k_pages"], pools["v_pages"], tables, lengths)
    return (paged_attn_decode_cuda(*args, kv_format=fmt, **aux),
            paged_attn_decode_ref(*args, kv_format=fmt, kv_aux=aux))


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
def test_decode_bf16_kernel_matches_plain(cuda, fmt):
    """Lengths at page and split edges: a padded lane, the new token at a
    page's first / last slot, one split exactly full, four splits."""
    lens = [0, 15, 16, 511, 512, 1023, 2047]
    got, want = _decode_both(fmt, *_bf16_decode_case(cuda, fmt, lens, 128))
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **BF16_O)


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
def test_decode_bf16_lane_is_invariant_to_the_batch(cuda, fmt):
    """Bit for bit: a lane run alone with its own table width equals the
    same lane among 32 lanes of width 256 with padded lanes."""
    gen = torch.Generator(cuda).manual_seed(3)
    lens = torch.randint(1, 4095, (32,), generator=gen,
                         device=cuda).tolist()
    lens[5] = lens[20] = 0
    q, pools, aux, tables, lengths = _bf16_decode_case(cuda, fmt, lens, 256,
                                                       seed=3)
    batch, _ = _decode_both(fmt, q, pools, aux, tables, lengths)
    for s in (0, 7, 31):
        own = lens[s] // 16 + 1
        alone, _ = _decode_both(fmt, q[s:s + 1].contiguous(), pools, aux,
                                tables[s:s + 1, :own].contiguous(),
                                lengths[s:s + 1])
        assert torch.equal(alone[0], batch[s]), s


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
@pytest.mark.parametrize("D,G,page", [(16, 2, 8), (32, 8, 4), (128, 4, 16),
                                      (64, 1, 32), (64, 16, 16),
                                      (128, 16, 16)])
def test_decode_bf16_kernel_head_geometries(cuda, fmt, D, G, page):
    lens = [3, page, 700, 1500]
    case = _bf16_decode_case(cuda, fmt, lens, 1536 // page, G=G, D=D,
                             page=page, seed=D + G)
    got, want = _decode_both(fmt, *case)
    torch.testing.assert_close(got.float(), want.float(), **BF16_O)


def _bf16_prefill_case(dev, fmt, G, C, start, Hkv=2, Gq=4, D=64, page=16,
                       seed=0):
    width = (start + C) // page + 2
    gen, pools, tables, aux = _case(dev, fmt, G, Hkv, D, page, width, seed,
                                    bf16=True)
    q = torch.randn((G, C, Hkv, Gq, D), generator=gen, device=dev) \
        .to(torch.bfloat16)
    return q, pools, aux, tables


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
@pytest.mark.parametrize("C,start", [(16, 0), (64, 64), (64, 960),
                                     (32, 2048)])
def test_prefill_bf16_kernel_matches_plain(cuda, fmt, C, start):
    q, pools, aux, tables = _bf16_prefill_case(cuda, fmt, 3, C, start)
    args = (q, pools["k_pages"], pools["v_pages"], tables)
    got = paged_attn_prefill_cuda(*args, start=start, kv_format=fmt, **aux)
    want = paged_attn_prefill_ref(*args, start, kv_format=fmt, kv_aux=aux)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **BF16_O)


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
def test_prefill_bf16_rows_are_invariant_to_block_q_and_chunk(cuda, fmt):
    """Bit for bit: block_q 8, 16, 24 and 32 give the same output, and
    the chunk [1024, 1088) equals the same rows of the chunk [960, 1088)
    (which crosses a 1024-key split)."""
    q, pools, aux, tables = _bf16_prefill_case(cuda, fmt, 2, 128, 960)
    args = (pools["k_pages"], pools["v_pages"], tables)
    outs = [paged_attn_prefill_cuda(q, *args, start=960, block_q=bq,
                                    kv_format=fmt, **aux)
            for bq in (32, 16, 8, 24)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    late = paged_attn_prefill_cuda(q[:, 64:].contiguous(), *args, start=1024,
                                   kv_format=fmt, **aux)
    assert torch.equal(late, outs[0][:, 64:])


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
@pytest.mark.parametrize("Gq,C,start,block_q", [
    (4, 32, 1008, 32), (4, 128, 960, 24), (6, 64, 992, 32),
    (5, 64, 2016, 32)])
def test_prefill_bf16_q_blocks_straddling_a_key_split(cuda, fmt, Gq, C,
                                                      start, block_q):
    """A q-block whose positions cross a 1024-key split (block_q not
    dividing 1024, or 128 / Gq not a power of two): its rows before the
    split come from the first split's block alone.  Enough requests that
    the later split's blocks run after the first split's have finished.
    Against the plain version, and bit for bit against block_q 8 (whose
    q-blocks never straddle)."""
    q, pools, aux, tables = _bf16_prefill_case(cuda, fmt, 32, C, start,
                                               Hkv=8, Gq=Gq)
    args = (q, pools["k_pages"], pools["v_pages"], tables)
    got = paged_attn_prefill_cuda(*args, start=start, block_q=block_q,
                                  kv_format=fmt, **aux)
    aligned = paged_attn_prefill_cuda(*args, start=start, block_q=8,
                                      kv_format=fmt, **aux)
    want = paged_attn_prefill_ref(*args, start, kv_format=fmt, kv_aux=aux)
    torch.testing.assert_close(got.float(), want.float(), **BF16_O)
    assert torch.equal(got, aligned)


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
@pytest.mark.parametrize("D,Gq,page", [(16, 2, 8), (32, 8, 4), (128, 4, 16),
                                       (64, 1, 32), (64, 32, 16)])
def test_prefill_bf16_kernel_head_geometries(cuda, fmt, D, Gq, page):
    q, pools, aux, tables = _bf16_prefill_case(cuda, fmt, 2, 32, 1024 + 32,
                                               Gq=Gq, D=D, page=page,
                                               seed=D + Gq)
    args = (q, pools["k_pages"], pools["v_pages"], tables)
    got = paged_attn_prefill_cuda(*args, start=1056, kv_format=fmt, **aux)
    want = paged_attn_prefill_ref(*args, 1056, kv_format=fmt, kv_aux=aux)
    torch.testing.assert_close(got.float(), want.float(), **BF16_O)


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
@pytest.mark.parametrize("Gq,D,C,start", [
    (16, 64, 16, 64), (16, 64, 48, 992), (16, 128, 32, 2064),
    (8, 128, 16, 0), (4, 128, 48, 1024)])
def test_prefill_bf16_wgmma_chunk_ends_off_the_tile(cuda, fmt, Gq, D, C,
                                                    start):
    """The wgmma kernel at qwen3-moe's GQA group (16) and at D 128, the
    chunk ending inside a 64-key tile (its last pages past the chunk read
    as zeros, never looked up): against the plain version, and bit for bit
    with every page past the chunk and the trash page poisoned."""
    q, pools, aux, tables = _bf16_prefill_case(cuda, fmt, 3, C, start,
                                               Hkv=2, Gq=Gq, D=D,
                                               seed=Gq + D + start)
    args = (q, pools["k_pages"], pools["v_pages"], tables)
    got = paged_attn_prefill_cuda(*args, start=start, kv_format=fmt, **aux)
    want = paged_attn_prefill_ref(*args, start, kv_format=fmt, kv_aux=aux)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **BF16_O)
    seen = (start + C) // 16
    tab = tables.tolist()
    dead = {0} | {tab[g][j] for g in range(3)
                  for j in range(seen, tables.shape[1])}
    pp = _poisoned(pools, dead)
    paux = {k: v for k, v in pp.items() if not k.endswith("_pages")}
    pois = paged_attn_prefill_cuda(q, pp["k_pages"], pp["v_pages"], tables,
                                   start=start, kv_format=fmt, **paux)
    assert torch.equal(got, pois)


@pytest.mark.parametrize("fmt,kind", [("fp", 1), ("int8", 2), ("sc", 3)])
def test_prefill_bf16_route_by_head_dim_and_page(cuda, fmt, kind):
    """bf16 q at D 64 and 128 on 16-position pages reaches the wgmma
    kernel (the launch's C geometry, and the profiler's kernel name), at
    every block_q; other head dims and pages the mma.sync kernel, float32
    q the CUDA-core one; the plan's route agrees."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import plan as kp
    for D, page, q_dtype, code in ((64, 16, 1, 2), (128, 16, 1, 2),
                                   (64, 32, 1, 1), (128, 8, 1, 1),
                                   (32, 16, 1, 1), (16, 16, 1, 1),
                                   (64, 16, 0, 0)):
        for block_q in (1, 8, 32, 64):
            geo = build.geometry("paged_attn_prefill_geometry", 2, 64, 2, 4,
                                 D, page, 256 // page, 128, block_q,
                                 q_dtype, kind)
            assert geo["kernel"] == code, (D, page, q_dtype, block_q, geo)
            assert kp.paged_prefill_kernel_code(D, page, kind,
                                                q_dtype) == code
    q, pools, aux, tables = _bf16_prefill_case(cuda, fmt, 2, 64, 64)
    args = (q, pools["k_pages"], pools["v_pages"], tables)
    paged_attn_prefill_cuda(*args, start=64, kv_format=fmt, **aux)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            paged_attn_prefill_cuda(*args, start=64, kv_format=fmt, **aux)
        torch.cuda.synchronize()
    names = {re.search(r"(\w+_kernel)\b", e.key).group(1)
             for e in prof.key_averages() if "prefill" in e.key}
    assert names == {"paged_prefill_wgmma_kernel"}, names


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
@pytest.mark.parametrize("block_q", [4, 8, 16, 24, 32, 64])
def test_prefill_bf16_request_alone_equals_beside_others(cuda, fmt,
                                                         block_q):
    """Bit for bit, at every block_q: a request's rows prefilled alone
    (its own table row, cut to its pages) equal its rows among three
    requests, over a chunk that crosses a 1024-key split."""
    q, pools, aux, tables = _bf16_prefill_case(cuda, fmt, 3, 128, 960,
                                               Hkv=2, Gq=4, seed=block_q)
    kv = (pools["k_pages"], pools["v_pages"])
    batch = paged_attn_prefill_cuda(q, *kv, tables, start=960,
                                    block_q=block_q, kv_format=fmt, **aux)
    for g in range(3):
        alone = paged_attn_prefill_cuda(
            q[g:g + 1].contiguous(), *kv,
            tables[g:g + 1, :(960 + 128) // 16].contiguous(), start=960,
            block_q=block_q, kv_format=fmt, **aux)
        assert torch.equal(alone[0], batch[g]), g


def _poisoned(pools, pages):
    out = {k: v.clone() for k, v in pools.items()}
    idx = torch.as_tensor(sorted(pages), device=next(iter(pools.values()))
                          .device, dtype=torch.long)
    for v in out.values():
        v[idx] = 127 if v.dtype == torch.int8 else 3.0e4
    return out


@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
def test_bf16_poisoned_pages_stay_invisible_at_4096_tokens(cuda, fmt):
    """Big codes and scales on the trash page and every page past a lane's
    length (decode, 32 lanes of 1024-4095 tokens) or past the chunk
    (prefill, the last chunk of a 4096-token prompt): bit-identical."""
    lens = [1024 + 99 * i for i in range(32)]
    lens[-1] = 4095
    q, pools, aux, tables, lengths = _bf16_decode_case(cuda, fmt, lens, 256)
    tab = tables.tolist()
    dead = {0} | {tab[s][j] for s in range(32)
                  for j in range(lens[s] // 16 + 1, 256)}
    clean, _ = _decode_both(fmt, q, pools, aux, tables, lengths)
    pp = _poisoned(pools, dead)
    paux = {k: v for k, v in pp.items() if not k.endswith("_pages")}
    pois, _ = _decode_both(fmt, q, pp, paux, tables, lengths)
    assert torch.equal(clean, pois)
    q, pools, aux, tables = _bf16_prefill_case(cuda, fmt, 4, 64, 4032)
    seen = 4096 // 16
    tab = tables.tolist()
    dead = {0} | {tab[g][j] for g in range(4) for j in range(seen, seen + 2)}
    pp = _poisoned(pools, dead)
    paux = {k: v for k, v in pp.items() if not k.endswith("_pages")}
    clean = paged_attn_prefill_cuda(q, pools["k_pages"], pools["v_pages"],
                                    tables, start=4032, kv_format=fmt, **aux)
    pois = paged_attn_prefill_cuda(q, pp["k_pages"], pp["v_pages"], tables,
                                   start=4032, kv_format=fmt, **paux)
    assert torch.equal(clean, pois)


def test_bf16_q_over_float32_pools_matches_plain(cuda):
    """The route by dtype: bf16 q over float32 pools runs the CUDA-core
    kernels."""
    gen, pools, tables, aux = _case(cuda, "fp", 2, 2, 64, 16, 16, seed=5)
    q = torch.randn((2, 2, 4, 64), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    lengths = torch.tensor([40, 255], dtype=torch.int32, device=cuda)
    got, want = _decode_both("fp", q, pools, aux, tables, lengths)
    torch.testing.assert_close(got.float(), want.float(), **BF16_O)
    qp = torch.randn((2, 64, 2, 4, 64), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    args = (qp, pools["k_pages"], pools["v_pages"], tables)
    torch.testing.assert_close(
        paged_attn_prefill_cuda(*args, start=128).float(),
        paged_attn_prefill_ref(*args, 128).float(), **BF16_O)


def test_paged_kernels_by_dtype_and_one_launch_per_call(cuda):
    """By the profiler's kernel names: bf16 q runs the split decode (and
    its combine when a lane has several splits) and the wgmma prefill at
    D 64 on 16-position pages (and its combine when the keys span several
    splits); float32 q the CUDA-core kernels.  Each call counts one
    launch.  The calls run three times under the profiler, which now and
    then drops a session's first kernel records."""
    from torch.profiler import ProfilerActivity, profile
    reps = 3
    build.reset_launches()
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, pools, aux, tables, lengths = _bf16_decode_case(
            cuda, "int8", [100, 1500], 96)
        qp, ppools, paux, ptables = _bf16_prefill_case(cuda, "int8", 1, 64,
                                                       1024)
        q, qp = q.to(dtype), qp.to(dtype)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                paged_attn_decode_cuda(q, pools["k_pages"], pools["v_pages"],
                                       tables, lengths, kv_format="int8",
                                       **aux)
                paged_attn_prefill_cuda(qp, ppools["k_pages"],
                                        ppools["v_pages"], ptables,
                                        start=1024, kv_format="int8", **paux)
            torch.cuda.synchronize()
        names[dtype] = sorted({re.search(r"(\w+_kernel)\b", e.key).group(1)
                               for e in prof.key_averages()
                               if "decode" in e.key or "prefill" in e.key})
    assert names[torch.bfloat16] == [
        "paged_decode_combine_kernel", "paged_decode_split_kernel",
        "paged_prefill_combine_kernel", "paged_prefill_wgmma_kernel"]
    assert names[torch.float32] == ["decode_kernel", "prefill_kernel"]
    assert build.LAUNCHES["paged_attn_decode"] == 2 * reps
    assert build.LAUNCHES["paged_attn_prefill"] == 2 * reps


def test_bf16_paged_kernels_refuse_what_they_do_not_take(cuda):
    lens = [10, 20]
    q, pools, aux, tables, lengths = _bf16_decode_case(cuda, "fp", lens, 4,
                                                       G=17)
    with pytest.raises(RuntimeError, match="at most 16 query rows"):
        _decode_both("fp", q, pools, aux, tables, lengths)
    q, pools, aux, tables, lengths = _bf16_decode_case(cuda, "fp", lens, 4,
                                                       page=12)
    with pytest.raises(RuntimeError, match="power-of-two page"):
        _decode_both("fp", q, pools, aux, tables, lengths)
    q, pools, aux, tables, lengths = _bf16_decode_case(cuda, "int8", lens, 4,
                                                       D=48)
    with pytest.raises(RuntimeError, match="head dim 48"):
        _decode_both("int8", q, pools, aux, tables, lengths)


# ---------------------------------------------------------------------------
# the SC integer datapath: ternary matmul, temporal adder, sort
# ---------------------------------------------------------------------------

def _matmul_case(dev, m, k, n, out_bsl, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randint(-4, 5, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-1, 2, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    t = None
    if out_bsl:
        t = torch.sort(torch.randint(-2 * k - 1, 2 * k + 1, (n, out_bsl),
                                     generator=gen, device=dev,
                                     dtype=torch.int32), dim=-1).values
    return x, w, t


@pytest.mark.parametrize("m,k,n", [
    (4, 2048, 512),         # decode lanes, K split over blocks
    (1, 8192, 256),         # one row, a long K split
    (37, 256, 132),         # ragged row and column tiles
    (256, 256, 256),        # the TNN's layer
    (5, 1001, 1003),        # K and N padded by ops.ternary_matmul
    (3, 0, 8),              # an empty contraction
])
@pytest.mark.parametrize("out_bsl", [0, 8, 32])
def test_ternary_matmul_kernel_bit_exact(cuda, m, k, n, out_bsl):
    x, w, t = _matmul_case(cuda, m, k, n, out_bsl)
    got = ops.ternary_matmul(x, w, t)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, ternary_matmul_ref(x, w, t))


def _full_range_case(dev, m, k, n, out_bsl, seed=0):
    """x and w over all of int8; thresholds spread over the sums' range."""
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    t = None
    if out_bsl:
        lim = 128 * 128 * (int(k ** 0.5) + 1)
        t = torch.sort(torch.randint(-lim, lim + 1, (n, out_bsl),
                                     generator=gen, device=dev,
                                     dtype=torch.int32), dim=-1).values
    return x, w, t


@pytest.mark.parametrize("m", [16, 17, 64, 255, 256, 257])
@pytest.mark.parametrize("k", [32, 784, 1004, 2048, 8192])
@pytest.mark.parametrize("n", [4, 12, 512, 1003, 2048])
@pytest.mark.parametrize("out_bsl", [0, 8])
def test_ternary_matmul_both_kernels_bit_exact(cuda, m, k, n, out_bsl):
    """Both sides of the dp4a / tensor-core crossover (M 16 | 17), ragged
    M tiles, K and N that the tensor-core path pads to 16 (1004, 12,
    1003), split K (M 64 x K 8192), over the full int8 range."""
    x, w, t = _full_range_case(cuda, m, k, n, out_bsl)
    got = ops.ternary_matmul(x, w, t)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, ternary_matmul_ref(x, w, t))


@pytest.mark.parametrize("m", [16, 17, 64, 255, 256, 257])
@pytest.mark.parametrize("out_bsl", [1, 32])
def test_ternary_matmul_both_kernels_si_widths(cuda, m, out_bsl):
    x, w, t = _full_range_case(cuda, m, 784, 1003, out_bsl, seed=m)
    assert torch.equal(ops.ternary_matmul(x, w, t),
                       ternary_matmul_ref(x, w, t))


@pytest.mark.parametrize("m", [4, 16, 64, 256])
def test_ternary_matmul_sums_reach_the_int8_extremes(cuda, m):
    """All-+-127 x against all-+-1 w gives sums of +-K*127; all -128 x
    against all -128 w gives K*16384 (K 8192: 1.3e8, inside int32)."""
    k, n = 8192, 64
    gen = torch.Generator(cuda).manual_seed(m)
    sign = torch.randint(0, 2, (m, k), generator=gen, device=cuda) * 2 - 1
    x = (127 * sign).to(torch.int8)
    w = torch.randint(0, 2, (k, n), generator=gen, device=cuda) * 2 - 1
    w[:, 0], w[:, 1] = sign[0], -sign[0]          # +-K*127 on row 0
    w = w.to(torch.int8)
    got = ops.ternary_matmul(x, w)
    assert torch.equal(got, ternary_matmul_ref(x, w))
    assert int(got[0, 0]) == 127 * k and int(got[0, 1]) == -127 * k
    lo = torch.full((m, k), -128, dtype=torch.int8, device=cuda)
    got = ops.ternary_matmul(lo, torch.full((k, n), -128, dtype=torch.int8,
                                            device=cuda))
    assert bool((got == 16384 * k).all())


def test_ternary_matmul_picks_the_kernel_by_rows(cuda):
    """By the profiler's kernel names: 64 rows run the tensor-core kernel,
    4 and 16 rows the dp4a one; one launch each."""
    from torch.profiler import ProfilerActivity, profile
    names = {}
    for m in (4, 16, 64):
        x, w, _ = _full_range_case(cuda, m, 2048, 512, 0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):      # the profiler may drop a first record
                ternary_matmul_cuda(x, w)
            torch.cuda.synchronize()
        names[m] = {re.search(r"(ternary_matmul\w*_kernel)", e.key).group(1)
                    for e in prof.key_averages()
                    if "ternary_matmul" in e.key}
    assert names[64] == {"ternary_matmul_mma_kernel"}
    assert names[4] == names[16] == {"ternary_matmul_kernel"}


def test_ternary_matmul_tensor_core_path_refuses_what_it_does_not_take(
        cuda):
    """Above 16 rows the kernel reads 16-byte chunks: K and N must be
    multiples of 16 (``ops.ternary_matmul`` pads) and x and w 16-byte
    aligned; the C entry point refuses, and nothing launches."""
    build.reset_launches()
    x, w, _ = _full_range_case(cuda, 32, 1004, 64, 0)
    with pytest.raises(RuntimeError, match="multiples of 16 at M=32"):
        ternary_matmul_cuda(x, w)
    x, w, _ = _full_range_case(cuda, 32, 1024, 64, 0)
    flat = torch.zeros(32 * 1024 + 4, dtype=torch.int8, device=cuda)
    with pytest.raises(RuntimeError, match="16-byte boundary at M=32"):
        ternary_matmul_cuda(flat[4:].view(32, 1024), w)
    assert build.LAUNCHES["ternary_matmul"] == 0
    assert torch.equal(ops.ternary_matmul(x[:, :1004], w[:1004]),
                       ternary_matmul_ref(x[:, :1004], w[:1004]))


def test_ternary_matmul_padded_channels_never_fire(cuda):
    """N = 1003 is padded to 1004 with a never-firing threshold; the kernel
    on the padded operands gives the padded channel the lowest code."""
    x, w, t = _matmul_case(cuda, 6, 64, 1003, 8, seed=1)
    got = ops.ternary_matmul(x.reshape(2, 3, 64), w, t)
    assert torch.equal(got.reshape(6, 1003), ternary_matmul_ref(x, w, t))
    wp = torch.nn.functional.pad(w, (0, 1))
    tp = torch.nn.functional.pad(t, (0, 0, 0, 1),
                                 value=torch.iinfo(torch.int32).max)
    full = ternary_matmul_cuda(x, wp, tp)
    assert bool((full[:, -1] == -4).all())


@pytest.mark.parametrize("cycles", [2, 8])
@pytest.mark.parametrize("width", [256, 64])
def test_temporal_adder_kernel_bit_exact(cuda, cycles, width):
    spec = default_approx_spec(width, 8)
    counts = torch.randint(0, 9, (37, cycles * width), dtype=torch.int32,
                           device=cuda)
    kw = dict(in_bsl=8, stages=spec_stages(spec), cycles=cycles)
    got = approx_bsn_temporal_cuda(counts, **kw)
    assert torch.equal(got, approx_bsn_temporal_plain(counts, **kw))
    multi = ((8, 2, 4), (width // 8, 0, 2))
    kw["stages"] = multi
    assert torch.equal(approx_bsn_temporal_cuda(counts, **kw),
                       approx_bsn_temporal_plain(counts, **kw))


# every level class of the kernel: inside a word (int8, L <= 4), inside a
# thread's run of 32 (L <= 32), inside a warp (L <= 1024), across warps
# in shared memory (L >= 2048); rows sharing a block (L < 8192), a tail
# block with rows missing (19, 300), and the int8 runs of 64 and 128
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.float32])
@pytest.mark.parametrize("length", [1, 2, 4, 8, 32, 64, 256, 1024, 2048,
                                    4096, 8192, 16384])
@pytest.mark.parametrize("rows", [1, 19, 300])
@pytest.mark.parametrize("descending", [True, False])
def test_bsn_sort_kernel_bit_exact(cuda, dtype, length, rows, descending):
    x = (torch.randn((rows, length), device=cuda) * 50).to(dtype)
    got = bsn_sort_cuda(x, descending=descending)
    assert torch.equal(got, bsn_sort_plain(x, descending=descending))
    assert torch.equal(got, torch.sort(x, dim=-1,
                                       descending=descending).values)


@pytest.mark.parametrize("rows,length", [(8, 16384), (300, 1024), (19, 8),
                                         (3, 2048), (2, 65536),
                                         (1, 131072)])
@pytest.mark.parametrize("descending", [True, False])
def test_bsn_sort_kernel_at_the_exact_bsn_row(cuda, rows, length,
                                              descending):
    """Rows of 0/1 bits (ties everywhere), as the exact BSN sorts them: one
    q_proj output channel's K * act_bsl = 16384 bits per row, and the
    other classes of the network."""
    bits = torch.randint(0, 2, (rows, length), dtype=torch.int8,
                         device=cuda)
    got = (ops.bsn_sort(bits) if descending
           else bsn_sort_cuda(bits, descending=False))
    assert torch.equal(got, bsn_sort_plain(bits, descending=descending))
    assert torch.equal(got.sum(-1), bits.sum(-1))


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.float32])
def test_bsn_sort_kernel_takes_an_unaligned_view(cuda, dtype):
    """A contiguous view one element into its storage is not 16-byte
    aligned: the kernel reads and writes it element by element."""
    flat = (torch.randn(5 * 2048 + 1, device=cuda) * 50).to(dtype)
    x = flat[1:].view(5, 2048)
    got = bsn_sort_cuda(x)
    assert torch.equal(got, bsn_sort_plain(x))


def test_sc_int_projection_launches_ternary_matmul(cuda):
    """An sc_int projection on CUDA tensors runs the kernel, and gives the
    plain path's result."""
    gen = torch.Generator(cuda).manual_seed(0)
    params = {"w": torch.randn((256, 64), generator=gen, device=cuda) / 16,
              "alpha_w": torch.full((64,), 0.07, device=cuda),
              "alpha_a": torch.tensor(1.0, device=cuda)}
    x = torch.randn((4, 256), generator=gen, device=cuda)
    build.reset_launches()
    y = sc_linear_int_from_qat(params, x, SCQuantConfig(mode="sc_int"))
    assert build.LAUNCHES["ternary_matmul"] == 1
    cpu = {k: v.cpu() for k, v in params.items()}
    want = sc_linear_int_from_qat(cpu, x.cpu(), SCQuantConfig(mode="sc_int"))
    torch.testing.assert_close(y.cpu(), want, rtol=0, atol=0)


def test_sc_kernels_refuse_what_they_do_not_take(cuda):
    build.reset_launches()
    x, w, t = _matmul_case(cuda, 4, 64, 32, 33)
    with pytest.raises(RuntimeError, match="out_bsl=33"):
        ternary_matmul_cuda(x, w, t)
    with pytest.raises(RuntimeError, match="multiples of 4"):
        ternary_matmul_cuda(x[:, :62].contiguous(), w[:62].contiguous())
    with pytest.raises(ValueError, match="int8"):
        ternary_matmul_cuda(x.int(), w)
    with pytest.raises(ValueError, match="contiguous"):
        ternary_matmul_cuda(x, w.t().contiguous().t())
    with pytest.raises(ValueError, match=r"\(32, out_bsl\) int32"):
        ternary_matmul_cuda(x, w, t.long())
    with pytest.raises(RuntimeError,
                       match=r"bsn_sort needs 262144 bytes of shared"):
        bsn_sort_cuda(torch.zeros((1, 65536), device=cuda))
    with pytest.raises(ValueError, match="int8, int32 or float32"):
        bsn_sort_cuda(torch.zeros((2, 8), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="power of two"):
        bsn_sort_cuda(torch.zeros((2, 6), device=cuda, dtype=torch.int8))
    with pytest.raises(ValueError, match="cycles"):
        approx_bsn_temporal_cuda(torch.zeros((2, 100), dtype=torch.int32,
                                             device=cuda),
                                 in_bsl=8, stages=((16, 0, 1),), cycles=3)
    assert build.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


# ---------------------------------------------------------------------------
# the batched ternary matmul: E products (the MoE experts') in one launch
# ---------------------------------------------------------------------------

def _batched_case(dev, e, m, k, n, seed=0):
    """x (E, M, K) and w (E, K, N) over the full int8 range, with empty
    experts as the MoE dispatch leaves them: every third expert's x all
    zero, every fifth expert's w all zero, and the rows past a random
    fill of each expert's capacity zero."""
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randint(-128, 128, (e, m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (e, k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    x[::3] = 0
    w[::5] = 0
    fill = torch.randint(0, m + 1, (e, 1), generator=gen, device=dev)
    x[torch.arange(m, device=dev)[None, :].expand(e, m) >= fill] = 0
    return x, w


@pytest.mark.parametrize("e,m,k,n", [
    (1, 4, 2048, 512),        # one product: the single kernel's path
    (16, 4, 256, 128),        # decode lanes, dp4a
    (128, 4, 512, 384),       # qwen3-like expert count at decode
    (128, 16, 256, 132),      # the last dp4a row count, N padded
    (16, 17, 1001, 1003),     # the first tensor-core row count, ragged
    (16, 64, 1024, 256),
    (128, 64, 256, 128),
    (2, 4, 8192, 128),        # few tiles: K splits over (product, split)
    (2, 64, 8192, 128),       # the same on the tensor cores
    (1, 256, 2048, 512),
])
def test_batched_ternary_matmul_bit_exact(cuda, e, m, k, n):
    """Bit for bit against the plain version and a loop over the experts'
    single products; one launch, counted as batched."""
    x, w = _batched_case(cuda, e, m, k, n)
    build.reset_launches()
    got = ops.ternary_matmul(x, w)
    assert build.LAUNCHES["ternary_matmul_batched"] == 1
    assert build.LAUNCHES["ternary_matmul"] == 0
    assert got.dtype == torch.int32 and got.shape == (e, m, n)
    assert torch.equal(got, ternary_matmul_ref(x, w))
    loop = torch.stack([ternary_matmul_ref(x[i], w[i]) for i in range(e)])
    assert torch.equal(got, loop)


@pytest.mark.parametrize("m", [4, 16, 17, 64])
def test_batched_ternary_matmul_sums_reach_the_int8_extremes(cuda, m):
    """+-K*127 sums in every expert, and K*16384 from all -128 operands."""
    e, k, n = 3, 8192, 32
    gen = torch.Generator(cuda).manual_seed(m)
    sign = torch.randint(0, 2, (e, m, k), generator=gen, device=cuda) * 2 - 1
    x = (127 * sign).to(torch.int8)
    w = torch.randint(0, 2, (e, k, n), generator=gen, device=cuda) * 2 - 1
    w[:, :, 0], w[:, :, 1] = sign[:, 0], -sign[:, 0]
    w = w.to(torch.int8)
    got = ops.ternary_matmul(x, w)
    assert torch.equal(got, ternary_matmul_ref(x, w))
    assert bool((got[:, 0, 0] == 127 * k).all())
    assert bool((got[:, 0, 1] == -127 * k).all())
    lo = torch.full((e, m, k), -128, dtype=torch.int8, device=cuda)
    got = ops.ternary_matmul(lo, torch.full((e, k, n), -128,
                                            dtype=torch.int8, device=cuda))
    assert bool((got == 16384 * k).all())


@pytest.mark.parametrize("mode", ["sc_int", "sc_qat", "none"])
def test_moe_layer_on_the_card_equals_the_cpu(cuda, mode):
    """One tiny float32 MoE layer (8 experts, top 2, two groups of 16
    tokens): under sc_int its three expert products are three batched
    launches, and on every datapath the card's output is the CPU's within
    float32 rounding (the router's float64 product and the combine sum
    in another order; the expert sums are exact)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    cfg = get_arch("qwen3-moe-235b-a22b").scaled(
        d_model=64, d_ff=48, n_experts=8, n_experts_per_tok=2,
        moe_group_size=16, moe_capacity_factor=4.0, dtype="float32")
    cfg = cfg.scaled(quant=cfg.quant.with_mode(mode))
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(cfg, generator=gen, device=torch.device("cpu"))
    x = torch.randn((2, 16, 64), generator=gen)
    want, want_aux = moe.moe_apply(p, x, cfg)
    build.reset_launches()
    got, aux = moe.moe_apply(
        {k: {kk: vv.to(cuda) for kk, vv in v.items()}
         if isinstance(v, dict) else v.to(cuda) for k, v in p.items()},
        x.to(cuda), cfg)
    assert build.LAUNCHES["ternary_matmul_batched"] == \
        (3 if mode == "sc_int" else 0)
    torch.testing.assert_close(got.cpu(), want, **TOL)
    torch.testing.assert_close(aux.cpu(), want_aux, **TOL)


def test_batched_ternary_matmul_refuses_what_it_does_not_take(cuda):
    build.reset_launches()
    x, w = _batched_case(cuda, 2, 4, 64, 32)
    t = torch.zeros((32, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="one product"):
        ternary_matmul_cuda(x, w, t)
    with pytest.raises(ValueError, match="one product"):
        ops.ternary_matmul(x, w, t)
    with pytest.raises(ValueError, match=r"\(E, K, N\)"):
        ternary_matmul_cuda(x, w[:1].contiguous())
    assert build.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


# ---------------------------------------------------------------------------
# flash attention: the training path's forward
# ---------------------------------------------------------------------------

def _flash_case(dev, B, S, Hq, Hkv, D, dtype, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev)
               .to(dtype) for h in (Hq, Hkv, Hkv))
    return q, k, v


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (1, 64, 4, 2, 16),      # one q tile, GQA 2
    (2, 100, 8, 2, 64),     # ragged S: a part tile of q rows and keys
    (1, 1, 2, 1, 32),       # a single row
    (2, 257, 6, 3, 64),     # GQA 2, 5 tiles, 1 row past the last
    (1, 130, 4, 4, 128),    # no grouping, the widest head
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, B, S, Hq, Hkv, D, causal, dtype):
    q, k, v = _flash_case(cuda, B, S, Hq, Hkv, D, dtype)
    out, lse = flash_attention_cuda(q, k, v, causal=causal)
    want, want_lse = flash_attention_ref(q, k, v, causal, return_lse=True)
    tol = TOL if dtype == torch.float32 else dict(rtol=0, atol=1e-2)
    torch.testing.assert_close(out.float(), want.float(), **tol)
    torch.testing.assert_close(lse, want_lse, **TOL)


def test_flash_bf16_kernel_at_the_train_shape(cuda):
    """The training path's shape at batch 1 (S 4096, 32 q / 8 kv heads,
    D 64, causal) on the tensor-core kernel."""
    q, k, v = _flash_case(cuda, 1, 4096, 32, 8, 64, torch.bfloat16, seed=3)
    out, lse = flash_attention_cuda(q, k, v)
    want, want_lse = flash_attention_ref(q, k, v, True, return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=1e-2)
    torch.testing.assert_close(lse, want_lse, **TOL)


@pytest.mark.parametrize("S", [63, 65, 129, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_kernel_ragged_gqa4(cuda, S, causal):
    """GQA 4 where the causal diagonal tile and the ragged tail of S meet
    (128-row q tiles of two 64-row warpgroups, 128-key tiles)."""
    q, k, v = _flash_case(cuda, 2, S, 8, 2, 64, torch.bfloat16, seed=S)
    out, lse = flash_attention_cuda(q, k, v, causal=causal)
    want, want_lse = flash_attention_ref(q, k, v, causal, return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=1e-2)
    torch.testing.assert_close(lse, want_lse, **TOL)


@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_kernel_default_scale(cuda, D, causal):
    """1/sqrt(D) is not exact in bf16 at D 32 and 128: the kernel scales
    the float32 logits, as the plain version scales q in float32."""
    q, k, v = _flash_case(cuda, 1, 300, 4, 2, D, torch.bfloat16, seed=D)
    out, lse = flash_attention_cuda(q, k, v, causal=causal)
    want, want_lse = flash_attention_ref(q, k, v, causal, return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=1e-2)
    torch.testing.assert_close(lse, want_lse, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_kernel_with_large_negative_logits(cuda, causal):
    """Every logit far below zero (q >= 0, k <= 0, scale 8): the first
    tile's row max is below -128 in log2 units, and the running sums must
    start from it without overflow."""
    q, k, v = _flash_case(cuda, 1, 150, 4, 2, 64, torch.bfloat16, seed=9)
    q, k = q.abs(), -k.abs()
    out, lse = flash_attention_cuda(q, k, v, causal=causal, scale=8.0)
    want, want_lse = flash_attention_ref(q, k, v, causal, scale=8.0,
                                         return_lse=True)
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=1e-2)
    torch.testing.assert_close(lse, want_lse, **TOL)


def test_flash_bf16_kernel_takes_a_negative_scale(cuda):
    """The tensor-core kernel takes the row max of raw logits, so for a
    negative scale it negates q (exact in bf16) against |scale|."""
    q, k, v = _flash_case(cuda, 1, 200, 4, 2, 64, torch.bfloat16, seed=8)
    out, lse = flash_attention_cuda(q, k, v, scale=-0.3)
    want, want_lse = flash_attention_ref(q, k, v, True, scale=-0.3,
                                         return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=1e-2)
    torch.testing.assert_close(lse, want_lse, **TOL)


@pytest.mark.parametrize("B,S,Hq,Hkv", [
    (2, 1500, 16, 16),      # hubert's encoder: 30 s of 50 frames/s
    (1, 65, 4, 2),          # ragged: one key past a tile, GQA 2
    (1, 1, 2, 1),           # a single row
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_head_dim_80(cuda, B, S, Hq, Hkv, causal, dtype):
    """D 80 (hubert-xlarge's 1280 / 16): 5 k steps of 16 in q k^T, the
    last from the 16-column box in 32B swizzle; P V in an n64 product and
    an n16 one, V read MN-major from both boxes."""
    q, k, v = _flash_case(cuda, B, S, Hq, Hkv, 80, dtype, seed=S)
    out, lse = flash_attention_cuda(q, k, v, causal=causal)
    want, want_lse = flash_attention_ref(q, k, v, causal, return_lse=True)
    tol = TOL if dtype == torch.float32 else dict(rtol=0, atol=1e-2)
    torch.testing.assert_close(out.float(), want.float(), **tol)
    torch.testing.assert_close(lse, want_lse, **TOL)


def test_flash_bf16_kernel_negative_scale_at_head_dim_80(cuda):
    """The negated q at D 80: every 16-byte unit of both boxes is flipped
    exactly once (a unit flipped twice would be flipped back)."""
    q, k, v = _flash_case(cuda, 1, 300, 4, 2, 80, torch.bfloat16, seed=80)
    out, lse = flash_attention_cuda(q, k, v, scale=-0.3)
    want, want_lse = flash_attention_ref(q, k, v, True, scale=-0.3,
                                         return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=1e-2)
    torch.testing.assert_close(lse, want_lse, **TOL)


@pytest.mark.parametrize("S", [63, 300])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_gqa_7(cuda, S, causal, dtype):
    """llava-next-34b's heads: 56 q heads over 8 KV heads, a group of 7
    (q head h reads KV head h // 7), D 128."""
    q, k, v = _flash_case(cuda, 2, S, 56, 8, 128, dtype, seed=7 * S)
    out, lse = flash_attention_cuda(q, k, v, causal=causal)
    want, want_lse = flash_attention_ref(q, k, v, causal, return_lse=True)
    tol = TOL if dtype == torch.float32 else dict(rtol=0, atol=1e-2)
    torch.testing.assert_close(out.float(), want.float(), **tol)
    torch.testing.assert_close(lse, want_lse, **TOL)


def test_flash_dtype_picks_the_tensor_core_or_cuda_core_kernel(cuda):
    """By the profiler's kernel names: a bf16 call runs a tensor-core
    kernel (wgmma at D 64, mma.sync at D 32), a float32 call the CUDA-core
    one; one launch each."""
    from torch.profiler import ProfilerActivity, profile
    names = {}
    for dtype, D in ((torch.bfloat16, 64), (torch.bfloat16, 32),
                     (torch.float32, 64)):
        q, k, v = _flash_case(cuda, 1, 256, 4, 2, D, dtype)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash_attention_cuda(q, k, v)
            torch.cuda.synchronize()
        names[dtype, D] = [e.key for e in prof.key_averages()
                           if "flash_fwd" in e.key for _ in range(e.count)]
    assert len(names[torch.bfloat16, 64]) == 1
    assert "flash_fwd_wgmma_kernel" in names[torch.bfloat16, 64][0]
    assert len(names[torch.bfloat16, 32]) == 1
    assert "flash_fwd_mma_kernel" in names[torch.bfloat16, 32][0]
    assert len(names[torch.float32, 64]) == 1
    assert "flash_fwd_kernel" in names[torch.float32, 64][0]


# the wgmma kernel: 128-row q tiles of two 64-row warpgroups, 128-key tiles
_WG_GROUPS = {1: (3, 3), 7: (14, 2), 8: (8, 1)}      # GQA: (Hq, Hkv)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 193])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("gqa", [1, 7, 8])
def test_flash_wgmma_kernel_across_its_tile_edges(cuda, S, causal, D, gqa):
    """S on both sides of a warpgroup's 64 rows and of a 128-row / 128-key
    tile: TMA's zero-filled rows past S, the masked diagonal and ragged
    tiles, at each head width the kernel takes and GQA 1, 7 and 8."""
    Hq, Hkv = _WG_GROUPS[gqa]
    q, k, v = _flash_case(cuda, 2, S, Hq, Hkv, D, torch.bfloat16,
                          seed=S * D + gqa)
    out, lse = flash_attention_cuda(q, k, v, causal=causal)
    want, want_lse = flash_attention_ref(q, k, v, causal, return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=1e-2)
    torch.testing.assert_close(lse, want_lse, **TOL)


@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_kernel_on_prescaled_q(cuda, D, causal):
    """The model path's call: q scaled beforehand and ``scale=1.0``."""
    q, k, v = _flash_case(cuda, 2, 300, 8, 2, D, torch.bfloat16, seed=D + 1)
    q = (q.float() / D ** 0.5).to(torch.bfloat16)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, scale=1.0)
    want, want_lse = flash_attention_ref(q, k, v, causal, scale=1.0,
                                         return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=1e-2)
    torch.testing.assert_close(lse, want_lse, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_kernel_at_head_dim_128_with_odd_scales(cuda, causal):
    """jamba's and llava's D 128 (two 64-column boxes): a negative scale
    (q negated in shared memory) and logits far below zero.  Scale 4 puts
    the logits of q >= 0, k <= 0 at D 128 where scale 8 puts them at D 64
    (a sum of twice the terms): rows' maxima near -330, below -128 in
    log2 units."""
    q, k, v = _flash_case(cuda, 1, 200, 8, 2, 128, torch.bfloat16, seed=12)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, scale=-0.3)
    want, want_lse = flash_attention_ref(q, k, v, causal, scale=-0.3,
                                         return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=1e-2)
    torch.testing.assert_close(lse, want_lse, **TOL)
    q, k = q.abs(), -k.abs()
    out, lse = flash_attention_cuda(q, k, v, causal=causal, scale=4.0)
    want, want_lse = flash_attention_ref(q, k, v, causal, scale=4.0,
                                         return_lse=True)
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=1e-2)
    torch.testing.assert_close(lse, want_lse, **TOL)


@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_kernel_is_batch_invariant(cuda, D, causal):
    """A row's output and LSE do not depend on the batch around it: B 3
    equals each batch row run alone, bit for bit."""
    q, k, v = _flash_case(cuda, 3, 200, 8, 2, D, torch.bfloat16, seed=D + 3)
    out, lse = flash_attention_cuda(q, k, v, causal=causal)
    for b in range(3):
        one, one_lse = flash_attention_cuda(q[b:b + 1].contiguous(),
                                            k[b:b + 1].contiguous(),
                                            v[b:b + 1].contiguous(),
                                            causal=causal)
        assert torch.equal(out[b:b + 1], one)
        assert torch.equal(lse[b:b + 1], one_lse)


@pytest.mark.parametrize("D", [64, 80, 128])
def test_flash_bf16_at_the_model_widths_reaches_the_wgmma_kernel(cuda, D):
    """The route is by dtype and D: bf16 at D 64, 80 and 128 is the wgmma
    kernel (Geometry::kernel 2, 384 threads), float32 is not; one launch
    a call."""
    geo = build.geometry("flash_attention_geometry", 2, 300, 8, 2, D, 1)
    assert (geo["kernel"], geo["threads"], geo["block"]) == (2, 384, 128)
    assert build.geometry("flash_attention_geometry", 2, 300, 8, 2, D,
                          0)["kernel"] == 0
    q, k, v = _flash_case(cuda, 2, 300, 8, 2, D, torch.bfloat16)
    build.reset_launches()
    flash_attention_cuda(q, k, v)
    assert build.LAUNCHES["flash_attention"] == 1


def test_flash_kernel_takes_a_caller_scale(cuda):
    q, k, v = _flash_case(cuda, 2, 96, 4, 2, 64, torch.float32)
    out, _ = flash_attention_cuda(q * 0.125, k, v, scale=1.0)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_matches_autograd_through_plain(cuda, causal, dtype):
    """dispatch.flash_attention's gradient (the kernel's LSE, the blocked
    backward) against autograd through the plain version; float32 within
    1e-4, bf16 gradients within 2e-2 (rounded to bf16 on both sides)."""
    q, k, v = _flash_case(cuda, 2, 200, 8, 2, 64, dtype, seed=1)
    g = torch.randn(q.shape, device=cuda).to(dtype)
    got = torch.autograd.grad(
        dispatch.flash_attention(*(t.requires_grad_() for t in (q, k, v)),
                                 causal=causal), (q, k, v), g)
    want = torch.autograd.grad(flash_attention_ref(q, k, v, causal),
                               (q, k, v), g)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=2e-2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), **tol)


def test_flash_backward_blocks_rows(cuda, monkeypatch):
    """Blocks of query rows give the gradient of one block."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _flash_case(cuda, 1, 96, 4, 2, 32, torch.float32, seed=2)
    _, lse = flash_attention_cuda(q, k, v)
    g = torch.randn(q.shape, device=cuda)
    whole = flash_attention_backward(q, k, v, lse, g, causal=True)
    monkeypatch.setattr(fa, "_BWD_BLOCK_ELEMS", 4 * 96 * 7)
    blocked = flash_attention_backward(q, k, v, lse, g, causal=True)
    for a, b in zip(blocked, whole):
        torch.testing.assert_close(a, b, **TOL)


def test_flash_counts_one_launch_per_forward(cuda):
    q, k, v = (t.requires_grad_() for t in _flash_case(
        cuda, 1, 64, 4, 2, 64, torch.float32))
    build.reset_launches()
    out = dispatch.flash_attention(q, k, v)
    out.sum().backward()
    assert build.LAUNCHES["flash_attention"] == 1
    assert sum(build.LAUNCHES.values()) == 1


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    build.reset_launches()
    q, k, v = _flash_case(cuda, 1, 64, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="k must be"):
        flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q, k, v.transpose(1, 2).contiguous()
                             .transpose(1, 2))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention_cuda(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="is on cpu"):
        flash_attention_cuda(q, k.cpu(), v)
    with pytest.raises(RuntimeError, match="head dim 24"):
        flash_attention_cuda(q[..., :24].contiguous(),
                             k[..., :24].contiguous(),
                             v[..., :24].contiguous())
    assert build.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


def test_train_step_on_the_card_equals_the_cpu(cuda):
    """One float32 train step without quantization (flash kernel, CUDA
    products) against the same step on the CPU: loss and grad norm within
    1e-5 relative, params within 2e-5 (one AdamW step of lr 5e-4), m / v
    within 5e-5 / 1e-4 of each leaf's largest entry; the kernel ran once
    per layer in the forward and once in the recompute."""
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_arch("granite-3-2b").scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=64, vocab_pad_multiple=32, dtype="float32")
    cfg = cfg.scaled(quant=cfg.quant.with_mode("none"))
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    batch = SyntheticLM(vocab_size=64, seq_len=100, seed=0).batch(0, 4)
    step = build_train_step(cfg, lambda s: warmup_cosine(s + 1, 1e-3, 2,
                                                         10))
    sc, mc = step(init_train_state(cpu, cfg), batch)
    build.reset_launches()
    sg, mg = step(init_train_state(gpu, cfg), batch)
    assert build.LAUNCHES["flash_attention"] == 2 * cfg.n_layers
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(mg[k].cpu(), mc[k], rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(sg.params), tree_leaves(sc.params)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2e-5)
    for name, tol in (("m", 5e-5), ("v", 1e-4)):
        for a, b in zip(tree_leaves(sg.opt[name]), tree_leaves(sc.opt[name])):
            assert (a.cpu() - b).abs().max() <= tol * b.abs().max()


@pytest.mark.parametrize("deterministic", [False, True])
def test_train_step_on_the_card_repeats_bit_for_bit(cuda, deterministic):
    """The float32 train step of the test above, four times on the card
    from the same parameters: bit-equal every time; with
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` PyTorch
    names no op of the step as lacking a deterministic kernel."""
    import warnings

    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_arch("granite-3-2b").scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=64, vocab_pad_multiple=32, dtype="float32")
    cfg = cfg.scaled(quant=cfg.quant.with_mode("none"))
    init = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = SyntheticLM(vocab_size=64, seq_len=100, seed=0).batch(0, 4)
    step = build_train_step(cfg, lambda s: warmup_cosine(s + 1, 1e-3, 2,
                                                         10))

    def run():
        params = tree_map(lambda t: t.clone().to(cuda), init)
        state, _ = step(init_train_state(params, cfg), batch)
        return [t.detach().cpu() for t in tree_leaves(state.params)]

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runs = [run() for _ in range(4)]
    finally:
        torch.use_deterministic_algorithms(was)
    named = [str(w.message) for w in caught
             if "deterministic" in str(w.message)]
    assert named == []
    for params in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(params, runs[0]))


# ---------------------------------------------------------------------------
# the recurrent mixers and jamba's attention shape (head_dim 128)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["fp", "int8", "sc"])
def test_paged_kernels_at_jamba_shape(cuda, fmt):
    """jamba-1.5-large's attention (Hkv 8, G 8, D 128, pages of 16) at the
    serving traffic's shapes: 4 decode lanes of 32-128 tokens and a padded
    lane; the second 64-token prefill chunk of 4 prompts.  Against the
    plain versions (O within 1e-2), and bit for bit with poison on the
    trash page and on every page past a lane's length or the chunk (the
    padded lane attends the trash page itself, so it is left out)."""
    lens = [32, 57, 96, 128, 0]
    q, pools, aux, tables, lengths = _bf16_decode_case(
        cuda, fmt, lens, 16, Hkv=8, G=8, D=128, seed=128)
    got, want = _decode_both(fmt, q, pools, aux, tables, lengths)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **BF16_O)
    tab = tables.tolist()
    dead = {0} | {tab[s][j] for s, n in enumerate(lens)
                  for j in range(n // 16 + 1, 16)}
    pp = _poisoned(pools, dead)
    paux = {k: v for k, v in pp.items() if not k.endswith("_pages")}
    assert torch.equal(got[:4], _decode_both(fmt, q, pp, paux, tables,
                                             lengths)[0][:4])
    q, pools, aux, tables = _bf16_prefill_case(cuda, fmt, 4, 64, 64, Hkv=8,
                                               Gq=8, D=128, seed=129)
    args = (q, pools["k_pages"], pools["v_pages"], tables)
    got = paged_attn_prefill_cuda(*args, start=64, kv_format=fmt, **aux)
    want = paged_attn_prefill_ref(*args, 64, kv_format=fmt, kv_aux=aux)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **BF16_O)
    tab = tables.tolist()
    dead = {0} | {tab[g][j] for g in range(4) for j in range(8, 10)}
    pp = _poisoned(pools, dead)
    paux = {k: v for k, v in pp.items() if not k.endswith("_pages")}
    assert torch.equal(got, paged_attn_prefill_cuda(
        q, pp["k_pages"], pp["v_pages"], tables, start=64, kv_format=fmt,
        **paux))


def _to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_dev(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _recurrent_layer(arch, mode):
    """One full-width float32 layer's mixer (and, for rwkv6, its channel
    mix) with seeded random parameters, on the CPU; the reference's zero-
    initialised leaves get small random values and mamba's conv taps 10x
    their draw (at the init scale every SSM input quantizes to level 0
    under sc_int)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import mamba, rwkv6
    cfg = get_arch(arch).scaled(dtype="float32")
    cfg = cfg.scaled(quant=cfg.quant.with_mode(mode))
    gen = torch.Generator().manual_seed(0)
    cpu = torch.device("cpu")
    if arch == "rwkv6-7b":
        parts = {"tmix": (rwkv6.rwkv_tmix_init(cfg, generator=gen,
                                               device=cpu),
                          rwkv6.rwkv_tmix_prefill_chunk,
                          rwkv6.rwkv_tmix_decode,
                          rwkv6.rwkv_state_init(cfg, 4)),
                 "cmix": (rwkv6.rwkv_cmix_init(cfg, generator=gen,
                                               device=cpu),
                          rwkv6.rwkv_cmix_prefill_chunk,
                          rwkv6.rwkv_cmix_decode,
                          {"shift": torch.zeros((4, cfg.d_model))})}
    else:
        parts = {"mamba": (mamba.mamba_init(cfg, generator=gen, device=cpu),
                           mamba.mamba_prefill_chunk, mamba.mamba_decode,
                           mamba.mamba_state_init(cfg, 4))}
    for p, *_ in parts.values():
        for k in ("maa_x", "maa", "u", "mk", "mr", "conv_b"):
            if k in p:
                p[k] = torch.randn(p[k].shape, generator=gen) * 0.3
        if "conv_w" in p:           # keep the SSM's inputs off level 0
            p["conv_w"] = p["conv_w"] * 10
    return cfg, gen, parts


def _assert_card_close(got, want, tol, what):
    """``got`` (card) within ``tol`` of ``want`` (CPU) everywhere except
    at most 1e-4 of the entries, which stay within 0.05 (see the test)."""
    got, want = got.cpu().float(), want.float()
    err = (got - want).abs()
    off = float((err > tol["atol"] + tol["rtol"] * want.abs())
                .float().mean())
    assert off <= 1e-4 and float(err.max()) <= 0.05, \
        (what, off, float(err.max()))


@pytest.mark.parametrize("mode", ["sc_int", "none"])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_recurrent_layer_on_the_card_equals_the_cpu(cuda, arch, mode):
    """A full-width rwkv6 layer (time mix and channel mix, d 4096, 64
    heads of 64, d_ff 14336) or a full-width jamba mamba layer (d 8192,
    d_inner 16384, d_state 16), float32: a 64-token prefill chunk of 4
    lanes (one with 37 real tokens) from zero state, then one decode step
    from the chunk's state, on the card and on the CPU.  Outputs and
    states within ``atol=rtol=1e-4`` (the products run in float64 on both
    sides, but tanh / exp / sigmoid differ in their last ulp between card
    and host, and the recurrence carries that over the chunk) on all but
    at most 1e-4 of the entries, and those within 0.05: under sc_int an
    activation within an ulp of a quantization boundary lands one level
    over on one side now and then, and a level is ~1e-3 of output.  Under
    sc_int the layer's projections launch ``ternary_matmul``."""
    cfg, gen, parts = _recurrent_layer(arch, mode)
    tol = dict(rtol=1e-4, atol=1e-4)
    x = torch.randn((4, 64, cfg.d_model), generator=gen)
    valid = torch.ones((4, 64), dtype=torch.bool)
    valid[2, 37:] = False
    x1 = torch.randn((4, 1, cfg.d_model), generator=gen)
    for name, (p, prefill, decode, st0) in parts.items():
        want, wst = prefill(p, x, cfg, st0, valid=valid)
        want1, wst1 = decode(p, x1, cfg, wst)
        pc = _to_dev(p, cuda)
        build.reset_launches()
        got, gst = prefill(pc, x.to(cuda), cfg, _to_dev(st0, cuda),
                           valid=valid.to(cuda))
        dense = [v for v in p.values() if isinstance(v, dict) and "w" in v]
        assert build.LAUNCHES["ternary_matmul"] == \
            (0 if mode == "none" else len(dense))
        got1, gst1 = decode(pc, x1.to(cuda), cfg, gst)
        _assert_card_close(got, want, tol, (name, "prefill"))
        _assert_card_close(got1, want1, tol, (name, "decode"))
        for k in wst1:
            _assert_card_close(gst[k], wst[k], tol, (name, "state", k))
            _assert_card_close(gst1[k], wst1[k], tol, (name, "state1", k))


def test_flash_bf16_kernel_at_jamba_shape(cuda):
    """jamba-1.5-large's attention over a train_4k sequence (B 1, S 4096,
    64 q / 8 kv heads, D 128, causal) on the tensor-core kernel."""
    q, k, v = _flash_case(cuda, 1, 4096, 64, 8, 128, torch.bfloat16, seed=5)
    out, lse = flash_attention_cuda(q, k, v)
    want, want_lse = flash_attention_ref(q, k, v, True, return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=1e-2)
    torch.testing.assert_close(lse, want_lse, **TOL)


# tiny float32 recurrent configs (tests/test_models_smoke.py's REDUCED);
# jamba's AdamW state in float32 so that m / v compare at 5e-5 / 1e-4
_TINY_RECURRENT = {
    "rwkv6-scan": ("rwkv6-7b", dict(
        n_layers=2, d_model=64, d_ff=128, vocab_size=131, n_heads=4,
        n_kv_heads=4, rwkv_head_dim=16, rwkv_wkv_impl="scan")),
    "rwkv6-chunked": ("rwkv6-7b", dict(
        n_layers=2, d_model=64, d_ff=128, vocab_size=131, n_heads=4,
        n_kv_heads=4, rwkv_head_dim=16, rwkv_wkv_impl="chunked",
        rwkv_chunk=8)),
    "jamba": ("jamba-1.5-large-398b", dict(
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=131, n_experts=4, n_experts_per_tok=2, mamba_d_state=8,
        moe_group_size=16, moe_capacity_factor=2.0,
        opt_state_dtype="float32"))}


def _tiny_recurrent(name, mode="none"):
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    arch, kw = _TINY_RECURRENT[name]
    cfg = get_arch(arch).scaled(dtype="float32", vocab_pad_multiple=32,
                                mamba_chunk=8, **kw)
    cfg = cfg.scaled(quant=cfg.quant.with_mode(mode))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for lp in params["layers"]:         # a live SSM (conv taps at 10x)
        if "conv_w" in lp["mixer"]:
            lp["mixer"]["conv_w"].mul_(10)
    return cfg, params


@pytest.mark.parametrize("name", list(_TINY_RECURRENT))
def test_recurrent_train_step_on_the_card_equals_the_cpu(cuda, name):
    """One float32 train step of tiny rwkv6 (both wkv forms) or jamba (a
    whole period: the flash kernel, MoE, mamba's scan) without
    quantization, on the card and on the CPU: loss and grad norm within
    1e-5 relative, m / v within 5e-5 / 1e-4 of each leaf's largest entry,
    params within 2e-5, or 2 lr where the CPU's gradient is below 1e-6
    (the step ``lr * g / (|g| + eps)`` is set by its rounding there)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.tree import tree_leaves, tree_map
    cfg, cpu = _tiny_recurrent(name)
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=96,
                        seed=0).batch(0, 4)
    step = build_train_step(cfg, lambda s: warmup_cosine(s + 1, 1e-3, 2,
                                                         10))
    sc, mc = step(init_train_state(cpu, cfg), batch)
    sg, mg = step(init_train_state(gpu, cfg), batch)
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(mg[k].cpu(), mc[k], rtol=1e-5, atol=0)
    lr = float(mc["lr"])
    for a, b, m in zip(tree_leaves(sg.params), tree_leaves(sc.params),
                       tree_leaves(sc.opt["m"])):
        tol = torch.where(m.abs() < 0.1 * 1e-6, 2 * lr + 2e-5, 2e-5)
        assert bool(((a.cpu() - b).abs() <= tol).all())
    for key, tol in (("m", 5e-5), ("v", 1e-4)):
        for a, b in zip(tree_leaves(sg.opt[key]), tree_leaves(sc.opt[key])):
            assert (a.cpu() - b).abs().max() <= tol * b.abs().max()


@pytest.mark.parametrize("name", ["rwkv6-scan", "jamba"])
def test_dense_prefill_and_decode_on_the_card_equal_the_cpu(cuda, name):
    """The dense path, float32 without quantization: ``prefill`` of 2 x 8
    tokens (whole MoE dispatch groups of 16; jamba's attention through the
    flash kernel, once) and four ``decode_step``s, logits within
    ``atol=rtol=1e-4`` of the CPU's."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serving.engine import _pad_prefill_cache
    from repro_torch.tree import tree_map
    cfg, cpu = _tiny_recurrent(name)
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    out = []
    for params, dev in ((cpu, "cpu"), (gpu, cuda)):
        build.reset_launches()
        with torch.inference_mode():
            lg, cache = prefill(params, {"tokens": toks[:, :8].to(dev)}, cfg)
            cache = _pad_prefill_cache(cache, 12)
            logits = [lg[:, -1]]
            for t in range(8, 12):
                lg, cache = decode_step(params, cache,
                                        toks[:, t:t + 1].to(dev), cfg)
                logits.append(lg[:, 0])
        out.append(torch.stack(logits).cpu())
        if dev is cuda:
            assert build.LAUNCHES["flash_attention"] == \
                cfg.has_mixer("attn")
    torch.testing.assert_close(out[1], out[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("datapath,fmt", [("qat", "fp"), ("sc_int", "int8")])
def test_exact_engine_and_dense_oracle_on_the_card_equal_the_cpu(
        cuda, datapath, fmt):
    """Tiny float32 jamba: the dense ``sequential_generate`` (fp) and the
    ``prefill_mode="exact"`` engine give the card the CPU's tokens."""
    from repro_torch.serving import ServeEngine, sequential_generate
    from repro_torch.tree import tree_map
    cfg, cpu = _tiny_recurrent("jamba", "sc_qat")
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12, 13, 14]]
    toks = []
    for params, dev in ((cpu, "cpu"), (gpu, cuda)):
        dense = sequential_generate(params, cfg, prompts, max_new_tokens=5,
                                    max_len=32, datapath=datapath,
                                    device=dev)
        eng = ServeEngine(params, cfg, max_slots=2, max_len=32, page_size=4,
                          datapath=datapath, kv_format=fmt,
                          prefill_mode="exact", device=dev)
        for p in prompts:
            eng.submit(p, max_new_tokens=5)
        toks.append((dense, [r.generated for r in sorted(
            eng.run_to_completion(), key=lambda r: r.rid)]))
    assert toks[1] == toks[0]


def _sampler_case(V=49152, S=8, seed=0):
    """Seeded logits (scale 3) and a mix of lanes: sampled under every
    filter, greedy, with and without logprobs."""
    from repro_torch.serving import SamplingParams
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn((S, V + 256), generator=gen) * 3
    sps = [SamplingParams(temperature=0.9, top_p=0.8, top_k=50, seed=100),
           SamplingParams(),
           SamplingParams(temperature=1.3, top_p=0.95, seed=2 ** 31 + 5),
           SamplingParams(temperature=0.7, min_p=0.05, seed=-3),
           SamplingParams(temperature=1.0, top_k=1, seed=7),
           SamplingParams(temperature=2.0, seed=8),
           SamplingParams(top_k=5, seed=9),
           SamplingParams(temperature=0.5, top_k=400, top_p=0.5, seed=10)]
    positions = torch.arange(S, dtype=torch.int32) * 37 + 5
    return logits, positions, sps[:S]


def _sample_rows(dev, logits, positions, sps, V, rows):
    from repro_torch.serving.sampling import (pack_sampling, sample_tokens,
                                              token_logprobs)
    samp = pack_sampling([sps[r] for r in rows], device=dev)
    lg, pos = logits[rows].to(dev), positions[rows].to(dev)
    tok = sample_tokens(lg, pos, samp, V)
    lp = token_logprobs(lg, tok, samp, V, 8)
    return tok.cpu(), tuple(a.cpu() for a in lp)


def test_sampler_on_the_card_is_batch_invariant_and_equals_the_cpu(cuda):
    """At granite's vocabulary: each lane draws the same token at batch
    1, 4 and 8 on the card and its logprobs are the same bits; the tokens
    equal the CPU's and the logprobs agree within 1e-5 (exp / log differ
    in the last ulp between the devices)."""
    V = 49152
    logits, positions, sps = _sampler_case(V)
    full_tok, full_lp = _sample_rows(cuda, logits, positions, sps, V,
                                     list(range(8)))
    for rows in ([0, 1, 2, 3], [4, 5, 6, 7], [2], [7], [0]):
        tok, lp = _sample_rows(cuda, logits, positions, sps, V, rows)
        assert torch.equal(tok, full_tok[rows])
        for a, b in zip(lp, full_lp):
            assert torch.equal(a, b[rows])
    cpu_tok, cpu_lp = _sample_rows("cpu", logits, positions, sps, V,
                                   list(range(8)))
    assert torch.equal(full_tok, cpu_tok)
    assert torch.equal(full_lp[1], cpu_lp[1])
    for a, b in ((full_lp[0], cpu_lp[0]), (full_lp[2], cpu_lp[2])):
        assert torch.equal(torch.isfinite(a), torch.isfinite(b))
        fin = torch.isfinite(b)
        torch.testing.assert_close(a[fin], b[fin], rtol=0, atol=1e-5)


@pytest.mark.parametrize("datapath,fmt", [("qat", "fp"), ("sc_int", "int8"),
                                          ("sc_int_approx", "sc")])
def test_verify_window_logits_equal_plain_decode_steps(cuda, datapath, fmt):
    """A bf16 granite-shaped model (head_dim 64: the split decode kernel):
    the verify window's logits row t equal, bit for bit, the logits of the
    decode step after window tokens 0..t, and each row of the window is
    one launch of the decode kernel."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import (init_paged_cache, init_params,
                                    paged_decode_step, paged_verify_step)
    from repro_torch.tree import tree_map
    cfg = get_arch("granite-3-2b").scaled(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=512, vocab_pad_multiple=64)
    if datapath != "qat":
        cfg = cfg.scaled(quant=dataclasses.replace(
            cfg.quant, mode="sc_int",
            int_approx=datapath == "sc_int_approx"))
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    S, page, maxp, T = 3, 16, 4, 5
    cache = init_paged_cache(cfg, S, S * maxp + 1, page, fmt, device=cuda)
    tables = (1 + torch.arange(S * maxp, dtype=torch.int32,
                               device=cuda)).reshape(S, maxp)
    slots = torch.arange(S, dtype=torch.int32, device=cuda)
    gen = torch.Generator(cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (S, 20), generator=gen,
                         device=cuda, dtype=torch.int32)
    lengths = torch.tensor([13, 16, 30], dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        for t in range(30):                 # fill positions 0..29
            pos = torch.clamp(torch.full((S,), t, dtype=torch.int32,
                                         device=cuda), max=lengths - 1)
            _, cache = paged_decode_step(params, cache, toks[:, t % 20],
                                         slots, tables, pos, cfg)
        plain = tree_map(torch.clone, cache)
        win = toks[:, :T]
        build.reset_launches()
        vl, _, _ = paged_verify_step(params, cache, win, slots, tables,
                                     lengths, cfg)
        assert build.LAUNCHES["paged_attn_decode"] == cfg.n_layers * T
        for t in range(T):
            lg, plain = paged_decode_step(params, plain, win[:, t], slots,
                                          tables, lengths + t, cfg)
            assert torch.equal(vl[:, t], lg), t


# ---------------------------------------------------------------------------
# mesh serving: 2 ranks on the one card, gloo (tests/mesh_worker.py)
# ---------------------------------------------------------------------------

MESH_TINY = {"granite-3-2b": dict(d_ff=128, vocab_size=64),
             "qwen3-moe-235b-a22b": dict(d_ff=48, vocab_size=131,
                                         n_experts=8, n_experts_per_tok=2,
                                         moe_group_size=16,
                                         moe_capacity_factor=4.0)}


@pytest.mark.parametrize("arch", list(MESH_TINY))
def test_mesh_on_the_card_equals_mesh_off(cuda, arch):
    """Two ranks on cuda:0 under gloo (NCCL refuses two ranks on one
    card) serve tiny float32 granite and qwen3-moe (4 experts a rank) on
    the three datapaths: every rank's tokens equal the mesh-off engine's
    on the card, which runs the same kernels on whole heads."""
    import mesh_worker as mw
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map
    cfg = get_arch(arch).scaled(n_layers=2, d_model=64, n_heads=4,
                                n_kv_heads=2, vocab_pad_multiple=32,
                                dtype="float32", **MESH_TINY[arch])
    params = tree_map(lambda t: t.numpy(), init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    cases = {dp: dict(cfg=cfg, port_params=params, device="cuda",
                      engine=dict(datapath=dp))
             for dp in ("qat", "sc_int", "sc_int_approx")}
    ranks = mw.Job({"1x2": (2, 1)}, cases).collect()["1x2"]
    for dp, case in cases.items():
        want = mw.serve(case)["generated"]
        for r in ranks:
            assert r[dp]["generated"] == want, (arch, dp)


def test_mesh_gather_is_exact_on_cuda(cuda):
    """The gather over gloo stages CUDA tensors through the host: bf16,
    int8 and int32 come back bit for bit, -0.0 included (an all-reduce
    of zero-padded blocks would turn it into +0.0)."""
    import numpy as np

    import mesh_worker as mw
    gen = torch.Generator().manual_seed(0)

    def blocks(dtype, shape):
        out = []
        for r in range(2):
            x = torch.randn(shape, generator=gen) * 50
            x[0] = -0.0
            out.append(x.to(dtype).view(mw._raw(dtype)).numpy())
        return out
    parts = {"bf16": (blocks(torch.bfloat16, (3, 4, 8)), "bfloat16", -1),
             "int8": (blocks(torch.int8, (5, 6)), "int8", 0),
             "int32": (blocks(torch.int32, (2, 7)), "int32", 1)}
    for res in mw.on_ranks(mw.gathered, 2, parts, "cuda"):
        for name, (arrays, _, dim) in parts.items():
            np.testing.assert_array_equal(
                res[name], np.concatenate(arrays, axis=dim))
    assert (parts["bf16"][0][0][0].view(np.uint16) == 0x8000).all()


# ---------------------------------------------------------------------------
# the vision and audio front ends
# ---------------------------------------------------------------------------

# tiny float32 front-end configs at the kernel's head shapes: hubert's D 80
# (bidirectional, LayerNorm, ungated gelu, no RoPE) and llava's GQA 7
_TINY_FRONTEND = {
    "hubert-xlarge": dict(n_layers=2, d_model=160, n_heads=2, n_kv_heads=2,
                          d_ff=256, vocab_size=67),
    "llava-next-34b": dict(n_layers=2, d_model=224, n_heads=14, n_kv_heads=2,
                           d_ff=256, vocab_size=131),
}


def _frontend_batch(cfg, gen):
    if cfg.frontend == "audio_stub":
        return {"frames": 0.1 * torch.randn((2, 150, 512), generator=gen)}
    return {"patch_embeds": 0.02 * torch.randn((2, 40, 1024), generator=gen),
            "tokens": torch.randint(0, cfg.vocab_size, (2, 24),
                                    generator=gen)}


@pytest.mark.parametrize("arch", sorted(_TINY_FRONTEND))
def test_frontend_forward_on_the_card_equals_the_cpu(cuda, arch):
    """A tiny float32 front-end model without quantization: ``forward``'s
    logits on the card (the float32 flash kernel, one launch a layer) and
    llava's dense prefill + two decode steps within ``atol=rtol=1e-4`` of
    the CPU's, as the dense path's card test."""
    from repro_torch.configs import get_arch
    from repro_torch.models import decode_step, forward, init_params, prefill
    from repro_torch.serving.engine import _pad_prefill_cache
    from repro_torch.tree import tree_map
    cfg = get_arch(arch).scaled(dtype="float32", vocab_pad_multiple=32,
                                **_TINY_FRONTEND[arch])
    cfg = cfg.scaled(quant=cfg.quant.with_mode("none"))
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    batch = _frontend_batch(cfg, torch.Generator().manual_seed(1))
    out = []
    for params, dev in ((cpu, "cpu"), (gpu, cuda)):
        b = {k: v.to(dev) for k, v in batch.items()}
        build.reset_launches()
        with torch.inference_mode():
            logits = [forward(params, b, cfg)[0]]
            if cfg.frontend == "vision_stub":
                lg, cache = prefill(params, b, cfg)
                cache = _pad_prefill_cache(cache, 66)
                logits.append(lg)
                for t in (3, 5):
                    lg, cache = decode_step(params, cache, torch.full(
                        (2, 1), t, device=dev), cfg)
                    logits.append(lg)
        out.append([t.cpu() for t in logits])
        if dev is cuda:
            assert build.LAUNCHES["flash_attention"] == cfg.n_layers * (
                1 + (cfg.frontend == "vision_stub"))
    for got, want in zip(out[1], out[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the analysis gates on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(build.KERNELS))
def test_launch_plans_equal_the_c_geometry(cuda, name):
    """Every registered case's plan (kernels/plan.py) launches what the
    launcher's C++ computes (its ``*_geometry`` entry point)."""
    from repro_torch.kernels.dispatch import KERNEL_REGISTRY
    entry = KERNEL_REGISTRY[name]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, kw in entry.cases():
        got = build.geometry(entry.geometry_entry, *entry.geometry_args(**kw))
        assert got == entry.plan(sms=sms, **kw).geometry(), label


def test_contracts_and_host_pass_on_a_tiny_engine(cuda):
    """inplace, dtype and host on a tiny float32 granite engine's prefill
    and decode step: every sync at an allowed site."""
    from repro_torch.analysis.contracts import run_engine_contracts
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine
    cfg = get_arch("granite-3-2b").scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=64, vocab_pad_multiple=32, dtype="float32")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    for dp, fmt in (("qat", "fp"), ("sc_int", "int8")):
        eng = ServeEngine(params, cfg, max_slots=4, max_len=64,
                          num_pages=1024, datapath=dp, kv_format=fmt,
                          device=cuda)
        results = run_engine_contracts(eng, f"{dp}/{fmt}",
                                       [[1, 2, 3], [4, 5, 6, 7], [8, 9]],
                                       on_card=True)
        bad = [v.message for r in results for v in r.violations]
        assert not bad, bad
        host = next(r for r in results if r.passname == "host")
        assert "serving/engine.py:_decode" in " ".join(host.notes)


def test_served_steps_sync_only_at_the_token_read_backs(cuda):
    """A prefill and a decode step of a tiny engine, watched by
    ``set_sync_debug_mode``: the lane tensors go up through pinned host
    memory without a sync (ROADMAP Queue 3 item 13), so the only syncs
    are the two token read-backs, one each."""
    from repro_torch.analysis.contracts import provenance, sync_sites
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine
    cfg = get_arch("granite-3-2b").scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=64, vocab_pad_multiple=32, dtype="float32")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    for dp, fmt in (("qat", "fp"), ("sc_int", "int8")):
        eng = ServeEngine(params, cfg, max_slots=4, max_len=64,
                          datapath=dp, kv_format=fmt, device=cuda)
        for p in ([1, 2, 3], [4, 5, 6, 7], [8, 9]):
            eng.submit(p, max_new_tokens=4)
        torch.cuda.synchronize()
        sites = []
        with sync_sites(sites):
            eng._admit()
            eng.step()
        torch.cuda.synchronize()
        assert sorted(provenance(f) for _, f in sites) == [
            "serving/engine.py:_decode",
            "serving/engine.py:_prefill_group"], (dp, sites)


# ---------------------------------------------------------------------------
# the paper's TNN: SyntheticClassification, the QAT MLP, serve_sc part 1
# ---------------------------------------------------------------------------

# one AdamW step of the W2-A8 MLP, card against CPU, from one init whose
# LSQ scales are powers of two: 4.0e-6 read on an H100.  At the init's own
# scales the sums of the quantized blocks are inexact in float32 and run
# in another order on the card, which decides levels at the lattice's
# rounding boundaries (the step-0 loss parts by 5.0e-3, ROADMAP Queue 3
# item 16)
TNN_STEP_TOL = 1e-5


def test_synthetic_classification_on_the_card_equals_the_cpu(cuda):
    """Batches drawn on the card: ``x`` within 1e-6 of the CPU's (the
    erfinv polynomial's ops may round differently) and the same labels in
    the same order (at these steps no two kept margins lie within 1e-5)."""
    from repro_torch.data import SyntheticClassification
    ds = SyntheticClassification()
    for step, rows in ((0, 32), (0, 256), (30_000, 16)):
        got = ds.batch(step, rows, cuda)
        want = ds.batch(step, rows, "cpu")
        assert got["x"].is_cuda and got["y"].dtype == torch.int32
        torch.testing.assert_close(got["x"].cpu(), want["x"], rtol=0,
                                   atol=1e-6)
        assert torch.equal(got["y"].cpu(), want["y"])


def test_served_tnn_codes_on_the_card_equal_the_cpu(cuda):
    """``serve_codes`` at 256 rows: two ``ternary_matmul`` launches (the
    fused SI), and every layer's codes equal the CPU's bit for bit."""
    from repro_torch import prng
    from repro_torch.examples import _qat_mlp as qat
    from repro_torch.examples import serve_sc
    from repro_torch.tree import tree_map
    params = qat.init_mlp(prng.key(0), serve_sc.SPEC, "cpu")
    x = qat.DATASET.batch(30_000, 256, "cpu")["x"]
    want = serve_sc.serve_codes(params, serve_sc.export_int_model(params), x)
    on_card = tree_map(lambda t: t.to(cuda), params)
    layers = serve_sc.export_int_model(on_card)
    build.reset_launches()
    got = serve_sc.serve_codes(on_card, layers, x.to(cuda))
    torch.cuda.synchronize()
    assert build.LAUNCHES["ternary_matmul"] == 2
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_tnn_train_step_on_the_card_equals_the_cpu(cuda):
    """One ``fit_mlp`` step at batch 16 from one init with power-of-two
    scales: loss and every parameter within ``TNN_STEP_TOL``."""
    from repro_torch import prng
    from repro_torch.examples import _qat_mlp as qat
    from repro_torch.examples import serve_sc
    from repro_torch.tree import tree_leaves, tree_map
    init = qat.init_mlp(prng.key(0), serve_sc.SPEC, "cpu")
    for blk in init["blocks"]:
        blk.update(alpha_w=torch.tensor(2.0 ** -4),
                   alpha_a=torch.tensor(2.0 ** -1),
                   alpha_r=torch.tensor(2.0 ** -3))
    runs = []
    for dev in ("cpu", cuda):
        params = tree_map(lambda t: t.to(dev, copy=True), init)
        losses = qat.fit_mlp(params, serve_sc.SPEC, 1, 16)
        runs.append((losses, [t.cpu() for t in tree_leaves(params)]))
    (l_cpu, p_cpu), (l_card, p_card) = runs
    assert abs(l_card[0] - l_cpu[0]) <= TNN_STEP_TOL
    for a, b in zip(p_card, p_cpu):
        assert float((a - b).abs().max()) <= TNN_STEP_TOL

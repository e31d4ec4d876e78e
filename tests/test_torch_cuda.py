"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; the
file imports torch only (no JAX), so it runs where the card is:

    python -m pytest -q tests/test_torch_cuda.py

float32 inputs at small shapes; attention within ``atol=rtol=1e-5``
(fp32 online softmax against the gathered softmax: the sums run in a
different order); the BSN adders, the ternary matmul (with and without
its SI epilogue) and the sort bit for bit.  The flash kernel in bfloat16
(the tensor-core kernel) within ``atol=1e-2`` on O (one bf16 ulp at
|o| <= 2 is 7.8e-3) and ``atol=rtol=1e-5`` on its float32 LSE; in
float32 (the CUDA-core kernel) within ``atol=rtol=1e-5`` on both.
"""

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


def _case(dev, fmt, S=3, Hkv=2, D=16, page=8, maxp=4, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)
    n = S * maxp + 1
    pools = {}
    for name in ("k", "v"):
        qd = kv_quant(torch.randn((n, page, Hkv, D), generator=gen,
                                  device=dev), fmt)
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
    (128-row q tiles, 64-key tiles)."""
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


def test_flash_dtype_picks_the_tensor_core_or_cuda_core_kernel(cuda):
    """By the profiler's kernel names: a bf16 call runs the tensor-core
    kernel (mma.sync), a float32 call the CUDA-core one; one launch each."""
    from torch.profiler import ProfilerActivity, profile
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _flash_case(cuda, 1, 256, 4, 2, 64, dtype)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash_attention_cuda(q, k, v)
            torch.cuda.synchronize()
        names[dtype] = [e.key for e in prof.key_averages()
                        if "flash_fwd" in e.key for _ in range(e.count)]
    assert len(names[torch.bfloat16]) == 1
    assert "flash_fwd_mma_kernel" in names[torch.bfloat16][0]
    assert len(names[torch.float32]) == 1
    assert "flash_fwd_kernel" in names[torch.float32][0]


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

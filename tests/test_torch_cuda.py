"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; the
file imports torch only (no JAX), so it runs where the card is:

    python -m pytest -q tests/test_torch_cuda.py

float32 inputs at small shapes; attention within ``atol=rtol=1e-5``
(fp32 online softmax against the gathered softmax: the sums run in a
different order), the BSN adder bit for bit.
"""

import pytest
import torch

from repro_torch.core.bsn import default_approx_spec, spec_stages
from repro_torch.core.kv_quant import kv_quant
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.approx_bsn import approx_bsn_cuda, approx_bsn_plain
from repro_torch.kernels.paged_attention import (paged_attn_decode_cuda,
                                                 paged_attn_prefill_cuda)
from repro_torch.kernels.ref import (paged_attn_decode_ref,
                                     paged_attn_prefill_ref)

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

"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: each test skips where torch sees no CUDA device. On a GPU
machine with nvcc: python -m pytest tests/test_torch_cuda.py -m cuda -q
Tolerance 1e-4 in f32: the kernels sum in another order. In bf16 the
JAX package's bounds: 4e-2 for the conv tail, 3e-2 for attention and
pooling (one output rounding, or a few across the six conv layers).
"""

import pytest
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    layers as tl, classifier as tclf)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
    attentive_pooling as ap, conv_tail as ct, flash_attention as fa,
    residual_stack as rs)

TOL = 1e-4
BF16_TOL = {"conv_tail": 4e-2, "attention": 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _perturbed_stack(device, L, D, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    stacked = tclf.init_classifier(tl.Init(g, device), 8, 4, L, D)["layers"]
    for sub in stacked.values():
        for k, v in sub.items():
            if k != "kernel":
                v += 0.1 * torch.randn(v.shape, device=device, generator=g)
    return stacked, torch.randn(300, D, device=device, generator=g)


@pytest.mark.cuda
@pytest.mark.parametrize("L,D", [(35, 512), (3, 32), (2, 768), (2, 1500)])
def test_residual_stack_kernel_matches_plain(cuda, L, D):
    """B=300 has more row groups than the grid has row blocks, so blocks
    loop over several of them; D=1500 takes two tensor copies per strip
    plane and leaves the last column group ragged."""
    stacked, x = _perturbed_stack(cuda, L, D, seed=D)
    before = rs.residual_stack.launches
    batches = (1, 4, 11, 128, 300)
    for B in batches:
        got = rs.residual_stack(stacked, x[:B].contiguous())
        want = rs.residual_stack_plain(stacked, x[:B])
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert rs.residual_stack.launches == before + len(batches)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4, 128])
def test_residual_stack_kernel_repeats_bitwise(cuda, B):
    stacked, x = _perturbed_stack(cuda, 35, 512, seed=B)
    x = x[:B].contiguous()
    first = rs.residual_stack(stacked, x)
    second = rs.residual_stack(stacked, x)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("L,D,B,col_width", [
    (35, 512, 4, 8), (35, 512, 300, 16), (35, 512, 128, 32),
    (3, 516, 4, 8), (3, 516, 128, 16), (2, 2048, 4, 16)])
def test_residual_stack_kernel_every_column_width(cuda, L, D, B, col_width):
    """Each width the plan picks, at shapes where it picks it; D=516
    leaves the last column group ragged."""
    assert rs.plan(B, L, D, torch.cuda.get_device_properties(cuda).multi_processor_count
                   ).col_width == col_width
    stacked, x = _perturbed_stack(cuda, L, D, seed=col_width)
    x = x[:B].contiguous()
    got = rs.residual_stack(stacked, x)
    want = rs.residual_stack_plain(stacked, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_residual_stack_kernel_rejects_what_it_does_not_take(cuda):
    stacked, x = _perturbed_stack(cuda, 2, 32, seed=0)
    with pytest.raises(ValueError, match="f32"):
        rs.residual_stack(stacked, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        rs.residual_stack(stacked, x.t().contiguous().t())


def _tail_convs(device, C, *, has_ln, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, device=device, generator=g)
    convs = [{"kernel": rnd(C, 1, 10)}]
    for K in ct.TAIL_KERNELS:
        conv = {"kernel": rnd(C, C, K) * (2.0 / (K * C)) ** 0.5, "bias": 0.1 * rnd(C)}
        if has_ln:
            conv["ln"] = {"scale": 1 + 0.1 * rnd(C), "bias": 0.1 * rnd(C)}
        convs.append(conv)
    return convs, rnd(2, 3199, C)


@pytest.mark.cuda
@pytest.mark.parametrize("has_ln", [False, True], ids=["gelu", "ln-gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_conv_tail_kernel_matches_plain(cuda, dtype, has_ln):
    convs, x1 = _tail_convs(cuda, 256, has_ln=has_ln, seed=3)
    convs = [{k: (v.to(dtype) if k != "ln" else v) for k, v in c.items()} for c in convs]
    x1 = x1.to(dtype)
    before = ct.conv_tail.launches
    got = ct.conv_tail(convs, x1, has_ln=has_ln)
    want = ct.conv_tail_plain(convs, x1, has_ln=has_ln)
    torch.cuda.synchronize()
    assert ct.conv_tail.launches == before + 1
    tol = TOL if dtype == torch.float32 else BF16_TOL["conv_tail"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("has_ln", [False, True], ids=["gelu", "ln-gelu"])
@pytest.mark.parametrize("B,C", [(1, 256), (1, 512), (1, 384), (3, 128), (8, 512)],
                         ids=["b1-c256", "b1-c512", "b1-c384", "b3-c128", "b8-c512"])
def test_conv_tail_bf16_wgmma_edges(cuda, B, C, has_ln):
    """The TMA + wgmma route at its edges: one batch row, every layer's last
    128-frame tile ragged, C of 128 to 512, LN on and off, and (B=8, C=512)
    more tiles than SMs, so that each block's two consumer warpgroups take
    turns over several tiles."""
    T1 = 3199
    assert all(t % 128 for t in ct.tail_lengths(T1))
    convs, _ = _tail_convs(cuda, C, has_ln=has_ln, seed=C + B)
    convs = [{k: (v.bfloat16() if k != "ln" else v) for k, v in c.items()} for c in convs]
    g = torch.Generator(device=cuda).manual_seed(B)
    x1 = torch.randn(B, T1, C, device=cuda, generator=g).bfloat16()
    before = ct.conv_tail.launches
    got = ct.conv_tail(convs, x1, has_ln=has_ln)
    want = ct.conv_tail_plain(convs, x1, has_ln=has_ln)
    torch.cuda.synchronize()
    assert ct.conv_tail.launches == before + 1
    assert tuple(got.shape) == (B, ct.tail_lengths(T1)[-1], C)
    tol = BF16_TOL["conv_tail"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_conv_tail_kernel_rejects_what_it_does_not_take(cuda):
    convs, x1 = _tail_convs(cuda, 128, has_ln=False, seed=0)
    with pytest.raises(ValueError, match="bf16 or f32"):
        ct.conv_tail(convs, x1.half(), has_ln=False)
    narrow, x64 = _tail_convs(cuda, 64, has_ln=False, seed=0)
    with pytest.raises(ValueError, match="C % 128"):
        ct.conv_tail(narrow, x64, has_ln=False)
    with pytest.raises(ValueError, match="no 'ln'"):
        ct.conv_tail(convs, x1, has_ln=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Sq,Skv,D,H", [(199, 199, 768, 12), (32, 199, 256, 8),
                                        (70, 33, 64, 8), (5, 130, 256, 2)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, Sq, Skv, D, H):
    g = torch.Generator(device=cuda).manual_seed(Sq + Skv)
    q = torch.randn(3, Sq, D, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(3, Skv, D, device=cuda, generator=g).to(dtype) for _ in range(2))
    mask = torch.ones(3, Skv, device=cuda)
    mask[0, Skv // 2:] = 0
    mask[2, ::3] = 0
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, mask, num_heads=H)
    want = fa.flash_attention_plain(q, k, v, mask, num_heads=H)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    tol = TOL if dtype == torch.float32 else BF16_TOL["attention"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,D,H,offset", [
    (1, 37, 93, 64, 8, 0),      # Dh 8, zero-padded to 64 in shared memory
    (2, 70, 129, 256, 8, 0),    # Dh 32
    (2, 65, 47, 768, 12, 0),    # Dh 64, Skv shorter than one tile
    (1, 100, 211, 256, 2, 0),   # Dh 128: two 64-column panels
    (3, 13, 255, 384, 8, 0),    # Dh 48
    (2, 70, 129, 256, 8, 1),    # rows not on 16 bytes: the synchronous copy
], ids=["dh8-b1", "dh32", "dh64", "dh128-b1", "dh48", "unaligned"])
def test_flash_attention_bf16_tensor_core_edges(cuda, B, Sq, Skv, D, H, offset):
    """The wgmma route at its edges: Sq and Skv multiples of neither 64
    nor 16, head widths padded to one and to two panels, B=1, and one row
    whose keys are all masked but its first three (a long masked tail)."""
    g = torch.Generator(device=cuda).manual_seed(Sq * Skv + offset)

    def make(S):
        flat = torch.randn(B * S * D + offset, device=cuda, generator=g).bfloat16()
        return flat[offset:].view(B, S, D)

    q, k, v = make(Sq), make(Skv), make(Skv)
    assert q.is_contiguous() and (q.data_ptr() % 16 != 0) == bool(offset)
    mask = torch.ones(B, Skv, device=cuda)
    mask[0, 3:] = 0
    mask[-1, 1::4] = 0
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, mask, num_heads=H)
    want = fa.flash_attention_plain(q, k, v, mask, num_heads=H)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    tol = BF16_TOL["attention"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn(2, 9, 32, device=cuda)
    mask = torch.ones(2, 9, device=cuda)
    with pytest.raises(ValueError, match="head width"):
        fa.flash_attention(q, q, q, mask, num_heads=8)        # Dh 4
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_attention(q, q.bfloat16(), q, mask, num_heads=2)
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_attention(q.half(), q.half(), q.half(), mask, num_heads=2)


def _pool_params(device, D, H, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, device=device, generator=g)
    return {"w1": {"kernel": (rnd(D, H) / D ** 0.5).to(dtype), "bias": (0.1 * rnd(H)).to(dtype)},
            "w2": {"kernel": (rnd(H, 1) / H ** 0.5).to(dtype), "bias": (0.1 * rnd(1)).to(dtype)}}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("S,D,H", [(199, 768, 128), (32, 768, 128), (45, 64, 32), (7, 1536, 256)])
def test_attentive_pooling_kernel_matches_plain(cuda, dtype, S, D, H):
    params = _pool_params(cuda, D, H, dtype, seed=S)
    x = torch.randn(5, S, D, device=cuda).to(dtype)
    mask = torch.ones(5, S, device=cuda)
    mask[1, S // 3:] = 0
    mask[3] = 0                                    # a row with no valid frame
    before = ap.attentive_stats_pooling.launches
    got = ap.attentive_stats_pooling(params, x, mask)
    want = ap.attentive_stats_pooling_plain(params, x, mask)
    torch.cuda.synchronize()
    assert ap.attentive_stats_pooling.launches == before + 1
    tol = TOL if dtype == torch.float32 else BF16_TOL["attention"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_attentive_pooling_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn(2, 10, 64, device=cuda)
    mask = torch.ones(2, 10, device=cuda)
    with pytest.raises(ValueError, match="H in"):
        ap.attentive_stats_pooling(_pool_params(cuda, 64, 100, torch.float32, 0), x, mask)
    with pytest.raises(ValueError, match="D <="):
        ap.attentive_stats_pooling(_pool_params(cuda, 1540, 128, torch.float32, 0),
                                   torch.randn(2, 10, 1540, device=cuda), mask)
    with pytest.raises(ValueError, match="bf16 or f32"):
        ap.attentive_stats_pooling(_pool_params(cuda, 64, 128, torch.float32, 0),
                                   x.half(), mask)

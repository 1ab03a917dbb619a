"""The port's CUDA kernels against their plain versions on the card, and
the front-end DSP and the TTA eval step on the card against the port's CPU
result.

Marked `cuda`: each test skips where torch sees no CUDA device. On a GPU
machine with nvcc: python -m pytest tests/test_torch_cuda.py -m cuda -q
Tolerance 1e-4 in f32: the kernels sum in another order. In bf16 the
JAX package's bounds: 4e-2 for the conv tail, 3e-2 for attention and
pooling (one output rounding, or a few across the six conv layers).
"""

import warnings

import numpy as np
import pytest
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu_torch import frontend
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    layers as tl, classifier as tclf)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
    attentive_pooling as ap, conv_tail as ct, flash_attention as fa,
    residual_stack as rs)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import profiling

TOL = 1e-4
BF16_TOL = {"conv_tail": 4e-2, "attention": 3e-2}


def _launches(*kernels):
    """The launch table's counts of `kernels`."""
    table = profiling.counters()
    return tuple(table[f"{k}.launches"] for k in kernels)


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
    return stacked, torch.randn(640, D, device=device, generator=g)


@pytest.mark.cuda
@pytest.mark.parametrize("L,D", [(35, 512), (3, 32), (2, 768), (2, 1500), (8, 256), (3, 64)])
def test_residual_stack_kernel_matches_plain(cuda, L, D):
    """B=300 and 640 have more row groups than the grid has row blocks, so
    blocks loop over several of them; 8 is the CLIs' batch (the eval, the
    academic battery and distillation); 20, 40 and 640 are the TTA step's
    rows at B=4, 8 and 128 (20 ends on a partial row group); D=1500 takes
    two tensor copies per strip plane and leaves the last column group
    ragged."""
    stacked, x = _perturbed_stack(cuda, L, D, seed=D)
    before = profiling.counters()["residual_stack.launches"]
    batches = (1, 4, 8, 11, 20, 40, 128, 300, 640)
    for B in batches:
        got = rs.residual_stack(stacked, x[:B].contiguous())
        want = rs.residual_stack_plain(stacked, x[:B])
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert profiling.counters()["residual_stack.launches"] == before + len(batches)


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
    before = profiling.counters()["conv_tail.launches"]
    got = ct.conv_tail(convs, x1, has_ln=has_ln)
    want = ct.conv_tail_plain(convs, x1, has_ln=has_ln)
    torch.cuda.synchronize()
    assert profiling.counters()["conv_tail.launches"] == before + 1
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
    before = profiling.counters()["conv_tail.launches"]
    got = ct.conv_tail(convs, x1, has_ln=has_ln)
    want = ct.conv_tail_plain(convs, x1, has_ln=has_ln)
    torch.cuda.synchronize()
    assert profiling.counters()["conv_tail.launches"] == before + 1
    assert tuple(got.shape) == (B, ct.tail_lengths(T1)[-1], C)
    tol = BF16_TOL["conv_tail"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False], ids=["wav2vec2-large", "wavlm-large"])
def test_conv_tail_ln_route_at_the_large_geometry(cuda, bias):
    """The layer-norm route of the large presets' extractor (wav2vec2-large
    and HuBERT-Large with conv biases, WavLM-Large without) at 4 s clips,
    [4, 12799, 512] bf16, against its plain version."""
    convs, _ = _tail_convs(cuda, 512, has_ln=True, seed=11 + bias)
    convs = [{k: (v.bfloat16() if k != "ln" else v) for k, v in c.items()
              if bias or k != "bias"} for c in convs]
    g = torch.Generator(device=cuda).manual_seed(12)
    x1 = torch.nn.functional.gelu(torch.randn(4, 12799, 512, device=cuda, generator=g)).bfloat16()
    before = profiling.counters()["conv_tail.launches"]
    got = ct.conv_tail(convs, x1, has_ln=True)
    want = ct.conv_tail_plain(convs, x1, has_ln=True)
    torch.cuda.synchronize()
    assert profiling.counters()["conv_tail.launches"] == before + 1
    assert tuple(got.shape) == (4, 199, 512)
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


def _front_inputs(device, B, seconds, C=512, seed=0, short_rows=True):
    """conv 0 (He-scaled, bf16), a perturbed group norm, and B normalised
    bf16 clips in a `seconds` bucket with ragged lengths: row 0 at the
    bucket's full length, with `short_rows` row 1 shorter than conv 0's
    kernel (no valid frame) and row 2 one frame, the rest uniform in a
    quarter to all of it."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        wav2vec2 as w2v)
    g = torch.Generator(device=device).manual_seed(seed)
    T = seconds * 16000
    samples = torch.randint(T // 4, T + 1, (B,), device=device, generator=g)
    samples[:3 if short_rows else 1] = torch.tensor([T, 7, 10][:3 if short_rows else 1],
                                                    device=device)
    mask = (torch.arange(T, device=device)[None, :] < samples[:, None]).float()
    wave = w2v.normalize_waveform(torch.randn(B, T, device=device, generator=g), mask)
    conv0 = {"kernel": (torch.randn(C, 1, 10, device=device, generator=g)
                        * (2.0 / 10) ** 0.5).bfloat16()}
    gn = {"scale": 1 + 0.1 * torch.randn(C, device=device, generator=g),
          "bias": 0.1 * torch.randn(C, device=device, generator=g)}
    return conv0, gn, wave.bfloat16(), mask, samples


@pytest.mark.cuda
@pytest.mark.parametrize("B,seconds", [(512, 2), (256, 4), (128, 8)],
                         ids=["b512-2s", "b256-4s", "b128-8s"])
def test_conv_front_kernel_matches_plain_at_the_buckets(cuda, B, seconds):
    """The front kernel at the benchmark's three bucket shapes against its
    plain version, with ragged rows (a full one, one with no valid frame,
    one with a single frame): the same rounding points, so values differ
    only where an f32 sum in another order flips a bf16 rounding, by at
    most the tail's bf16 bound and in a small share of the outputs."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
        conv_front as cf)
    conv0, gn, wave, _, samples = _front_inputs(cuda, B, seconds, seed=B)
    before = profiling.counters()["conv_front.launches"]
    with torch.no_grad():
        got = cf.conv_front(conv0, gn, wave, samples, 5)
        torch.cuda.synchronize()
        assert profiling.counters()["conv_front.launches"] == before + 1
        assert got.is_contiguous() and got.dtype == torch.bfloat16
        assert tuple(got.shape) == (B, (seconds * 16000 - 10) // 5 + 1, 512)
        for rows in torch.arange(B, device=cuda).split(32):   # the plain version's f32 copies
            want = cf.conv_front_plain(conv0, gn, wave[rows], samples[rows], 5)
            part = got[rows].float()
            tol = BF16_TOL["conv_tail"]
            torch.testing.assert_close(part, want.float(), rtol=tol, atol=tol)
            assert float((part != want.float()).float().mean()) < 1e-3
            del want, part


def _front_f64(conv0, gn, wave, samples, eps=1e-5):
    """The plain version's rounding points (conv 0 rounded to bf16, the
    normalised value rounded, the tanh GELU rounded) with every sum and
    product in f64: [B, T1, C]."""
    x = torch.nn.functional.conv1d(wave.double()[:, None, :], conv0["kernel"].double(),
                                   stride=5).bfloat16().double()
    frames = (samples - 10) // 5 + 1
    m = (torch.arange(x.shape[-1], device=x.device)[None, :]
         < frames[:, None]).double()[:, None]
    n = m.sum(-1, keepdim=True).clamp(min=1.0)
    mean = (x * m).sum(-1, keepdim=True) / n
    var = ((x - mean).square() * m).sum(-1, keepdim=True) / n
    y = ((x - mean) / torch.sqrt(var + eps) * gn["scale"].double()[:, None]
         + gn["bias"].double()[:, None]).bfloat16().double()
    g = 0.5 * y * (1 + torch.tanh((2 / torch.pi) ** 0.5 * (y + 0.044715 * y ** 3)))
    return g.bfloat16().transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,seconds", [(512, 2), (256, 4), (128, 8)],
                         ids=["b512-2s", "b256-4s", "b128-8s"])
def test_conv_front_kernel_is_as_near_f64_as_plain(cuda, B, seconds):
    """Against the same rounding points computed in f64, the front kernel
    is off on about as many outputs as its plain version (each of them
    sums in f32, in its own order): a rounding point moved, dropped or
    computed otherwise would set it off on many more. 32 rows a bucket."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
        conv_front as cf)
    conv0, gn, wave, _, samples = _front_inputs(cuda, B, seconds, seed=B)
    off = {"kernel": 0, "plain": 0}
    with torch.no_grad():
        got = cf.conv_front(conv0, gn, wave, samples, 5)
        for rows in torch.arange(3, 35, device=cuda).split(4):
            want = _front_f64(conv0, gn, wave[rows], samples[rows])
            off["kernel"] += int((got[rows] != want).sum())
            off["plain"] += int((cf.conv_front_plain(conv0, gn, wave[rows], samples[rows], 5)
                                 != want).sum())
    assert off["plain"] > 0 and off["kernel"] <= 1.25 * off["plain"], off


@pytest.mark.cuda
def test_conv_front_kernel_rejects_what_it_does_not_take(cuda):
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
        conv_front as cf)
    conv0, gn, wave, _, samples = _front_inputs(cuda, 4, 1, C=128)
    with torch.no_grad():
        with pytest.raises(ValueError, match="bf16 wave"):
            cf.conv_front(conv0, gn, wave.float(), samples, 5)
        with pytest.raises(ValueError, match="stride"):
            cf.conv_front(conv0, gn, wave, samples, 4)
        with pytest.raises(ValueError, match="int64"):
            cf.conv_front(conv0, gn, wave, samples.int(), 5)
        narrow = {"kernel": conv0["kernel"][:64]}
        with pytest.raises(ValueError, match="C % 128"):
            cf.conv_front(narrow, {k: v[:64] for k, v in gn.items()}, wave, samples, 5)
    kernel = {"kernel": conv0["kernel"].clone().requires_grad_()}
    with pytest.raises(RuntimeError, match="no backward"):
        cf.conv_front(kernel, gn, wave, samples, 5)


def _base_extractor(device, C=512, seed=0):
    """wav2vec2-base's extractor geometry (7 convs of C channels) with
    He-scaled bf16 kernels and a perturbed group norm."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
        Wav2Vec2Config)
    cfg = Wav2Vec2Config(conv_dim=(C,) * 7)
    g = torch.Generator(device=device).manual_seed(seed)
    convs, c_in = [], 1
    for K in cfg.conv_kernel:
        convs.append({"kernel": (torch.randn(C, c_in, K, device=device, generator=g)
                                 * (2.0 / (K * c_in)) ** 0.5).bfloat16()})
        c_in = C
    gn = {"scale": 1 + 0.1 * torch.randn(C, device=device, generator=g),
          "bias": 0.1 * torch.randn(C, device=device, generator=g)}
    return cfg, {"convs": convs, "group_norm": gn}


@pytest.mark.cuda
@pytest.mark.parametrize("B,seconds", [(16, 2), (8, 4), (4, 8)],
                         ids=["b16-2s", "b8-4s", "b4-8s"])
def test_feature_encoder_kernels_match_the_unfused_route(cuda, monkeypatch, B, seconds):
    """feature_encoder on the card at wav2vec2-base's geometry: the two
    kernels (one launch each a call) against the unfused route (cuDNN and
    the f32 group norm, `front_route` turned off), within the tail's bf16
    bound; the frame masks equal. No row is shorter than a quarter of
    the bucket: a row with no valid frame or one has no variance, and
    its group norm scales conv 0 by rsqrt(eps), about 316, past what a
    bf16 bound for O(1) activations covers."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        wav2vec2 as w2v)
    cfg, params = _base_extractor(cuda, seed=B)
    _, _, wave, mask, _ = _front_inputs(cuda, B, seconds, seed=B + 1, short_rows=False)
    with torch.no_grad():
        assert w2v.front_route(params, cfg, wave)
        launches = _launches("conv_front", "conv_tail")
        got, got_mask = w2v.feature_encoder(params, cfg, wave, mask)
        torch.cuda.synchronize()
        assert _launches("conv_front", "conv_tail") == (
            launches[0] + 1, launches[1] + 1)
        monkeypatch.setattr(w2v, "front_route", lambda *a: False)
        want, want_mask = w2v.feature_encoder(params, cfg, wave, mask)
        torch.cuda.synchronize()
        assert _launches("conv_front", "conv_tail") == (
            launches[0] + 1, launches[1] + 1)
    assert torch.equal(got_mask, want_mask)
    tol = BF16_TOL["conv_tail"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_eval_step_on_the_kernels_reads_the_card_back_as_often(cuda, monkeypatch):
    """A bf16 eval step with the front-end DSP on, at wav2vec2-base's
    extractor geometry (128 channels): the route launches each kernel once
    a step and reads the card back as often as the unfused route (the
    DSP's three gates); its outputs agree within the bf16 bound."""
    import dataclasses

    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
        evaluate as ev)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as tm, wav2vec2 as w2v)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        tree_to)
    cfg = _tiny_eval_config().model
    cfg = dataclasses.replace(
        cfg, compute_dtype="bfloat16", frontend_dsp=True,
        audio=dataclasses.replace(cfg.audio, conv_dim=(128,) * 7,
                                  conv_stride=(5, 2, 2, 2, 2, 2, 2),
                                  conv_kernel=(10, 3, 3, 3, 3, 2, 2)))
    wave, mask = _dsp_batch()
    rng = np.random.default_rng(0)
    batch = tree_to({"audio": wave, "audio_mask": mask,
                     "text_ids": torch.from_numpy(rng.integers(2, 100, (4, 10)).astype(np.int32)),
                     "text_mask": torch.ones(4, 10)}, cuda)
    params = tree_to(tm.init_model(cfg, torch.Generator().manual_seed(0), "cpu"), cuda)
    step = ev.make_eval_step(cfg, device=cuda)
    step(params, batch)
    launches = _launches("conv_front", "conv_tail")
    reads = _host_reads(lambda: step(params, batch))
    got = step(params, batch)
    assert _launches("conv_front", "conv_tail") == (
        launches[0] + 2, launches[1] + 2)
    monkeypatch.setattr(w2v, "front_route", lambda *a: False)
    assert _host_reads(lambda: step(params, batch)) == reads == 3
    want = step(params, batch)
    for field, g, w in zip(("logits", "features", "uncertainty"), got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=3e-2, atol=3e-2,
                                   msg=lambda m: f"{field}: {m}")


# (B, T, C, Cg, K): the flagship's three buckets (wav2vec2-base), WavLM-Large's
# 8 s bucket and the small student at 4 s
POS_CONV_SHAPES = {"b512-t99": (512, 99, 768, 48, 128), "b256-t199": (256, 199, 768, 48, 128),
                   "b128-t399": (128, 399, 768, 48, 128),
                   "wavlm-b32-t399": (32, 399, 1024, 64, 128),
                   "student-b16-t199": (16, 199, 384, 48, 64)}
POS_CONV_FLIP_SHARE = 1e-3   # outputs a bf16 step off the plain chain's: sum order


def _pos_conv_inputs(device, B, T, C, Cg, K, seed=0):
    """A kernel scaled as the init scales it, a bias, and h [B, T, C] zero
    past each clip's frames: row 0 at the bucket's T, row 1 with none,
    row 2 with one, the rest uniform in a quarter to all of it."""
    g = torch.Generator(device=device).manual_seed(seed)
    frames = torch.randint(T // 4, T + 1, (B,), device=device, generator=g)
    frames[:3] = torch.tensor([T, 0, 1], device=device)
    mask = (torch.arange(T, device=device)[None, :] < frames[:, None]).float()
    h = (torch.randn(B, T, C, device=device, generator=g) * mask[..., None]).bfloat16()
    conv = {"kernel": (torch.randn(C, Cg, K, device=device, generator=g)
                       * (4.0 / (K * C)) ** 0.5).bfloat16(),
            "bias": (0.1 * torch.randn(C, device=device, generator=g)).bfloat16()}
    return conv, h


def _conv_product(conv, h):
    """The plain chain's conv product, before its bias, rounded to bf16:
    [B, T, C]."""
    K = conv["kernel"].shape[-1]
    c = torch.nn.functional.conv1d(h.transpose(1, 2), conv["kernel"], padding=K // 2,
                                   groups=h.shape[-1] // conv["kernel"].shape[1])
    return c[:, :, : h.shape[1]].transpose(1, 2)


# How far F2's f32 product may sit from cuDNN's: two sums of 6144 bf16
# products in other orders, at partial sums of O(1), differ by up to a few
# 1e-6 (an H100 read 4e-6); 2**-16 is about 4x that.
POS_CONV_SUM_ORDER = 2.0 ** -16
GELU_MIN = -0.7517915   # tanh GELU's minimum: it is monotone above


def _pos_conv_flips_explained(got, product, bias):
    """Where F2's output `got` is the plain chain's bias add and GELU of a
    bf16 product within one bf16 step plus POS_CONV_SUM_ORDER of the plain
    chain's `product`: between the chain's outputs at the window's two ends
    (every rounding and the GELU above its minimum are monotone)."""
    p = product.float()
    step = torch.where(p != 0, torch.exp2(torch.floor(torch.log2(p.abs())) - 7),
                       torch.zeros_like(p))
    ends = [(p + s * (step + POS_CONV_SUM_ORDER)).bfloat16() for s in (-1, 1)]
    z = [e + bias for e in ends]                         # bf16 adds, rounded
    out = [tl.gelu(e).float() for e in z]
    lo, hi = torch.minimum(*out), torch.maximum(*out)
    lo = torch.where((z[0] <= GELU_MIN) & (z[1] >= GELU_MIN),
                     tl.gelu(torch.full_like(z[0], GELU_MIN)).float(), lo)
    return (got.float() >= lo) & (got.float() <= hi)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(POS_CONV_SHAPES))
def test_pos_conv_kernel_matches_plain(cuda, shape):
    """F2 against its plain chain at the benchmark's shapes: the same
    rounding points, so an output differs only where the f32 sum in
    another order moves the product (by one bf16 step where it is large,
    by a few 1e-6 where it is small) and the bias add and GELU round that
    product the other way: every flipped output is the chain's output of
    such a product, and flips are under POS_CONV_FLIP_SHARE of the
    outputs. One launch a call."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
        pos_conv as pc)
    B, T, C, Cg, K = POS_CONV_SHAPES[shape]
    conv, h = _pos_conv_inputs(cuda, B, T, C, Cg, K, seed=B + T)
    before = profiling.counters()["pos_conv.launches"]
    with torch.no_grad():
        got = pc.pos_conv(conv, h)
        torch.cuda.synchronize()
        assert profiling.counters()["pos_conv.launches"] == before + 1
        assert got.is_contiguous() and got.dtype == torch.bfloat16 and got.shape == h.shape
        want = pc.pos_conv_plain(conv, h)
        tol = BF16_TOL["conv_tail"]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        flipped = got != want
        share = float(flipped.float().mean())
        assert share < POS_CONV_FLIP_SHARE, share
        explained = _pos_conv_flips_explained(got[flipped], _conv_product(conv, h)[flipped],
                                              conv["bias"].expand_as(h)[flipped])
        assert bool(explained.all()), f"{int((~explained).sum())} of {explained.numel()} flips"


def _pos_conv_f64(conv, h):
    """The chain's rounding points (the product rounded to bf16, the bias
    add rounded, the tanh GELU rounded) with every sum and product in f64."""
    K = conv["kernel"].shape[-1]
    c = torch.nn.functional.conv1d(h.double().transpose(1, 2), conv["kernel"].double(),
                                   padding=K // 2,
                                   groups=h.shape[-1] // conv["kernel"].shape[1])
    c = c[:, :, : h.shape[1]].transpose(1, 2).bfloat16().double()
    z = (c + conv["bias"].double()).bfloat16().double()
    return (0.5 * z * (1 + torch.tanh((2 / torch.pi) ** 0.5 * (z + 0.044715 * z ** 3)))
            ).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(POS_CONV_SHAPES))
def test_pos_conv_kernel_is_as_near_f64_as_plain(cuda, shape):
    """Against the same rounding points computed in f64, F2 is off on at
    most 1.25x as many outputs as its plain chain (each sums in f32, in
    its own order): a rounding point moved, dropped or computed otherwise
    would set it off on many more. 32 rows a shape."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
        pos_conv as pc)
    B, T, C, Cg, K = POS_CONV_SHAPES[shape]
    conv, h = _pos_conv_inputs(cuda, B, T, C, Cg, K, seed=B + T)
    rows = torch.arange(3, min(B, 35), device=cuda)
    with torch.no_grad():
        got = pc.pos_conv(conv, h)[rows]
        want = _pos_conv_f64(conv, h[rows])
        off = {"kernel": int((got != want).sum()),
               "plain": int((pc.pos_conv_plain(conv, h[rows]) != want).sum())}
    assert off["plain"] > 0 and off["kernel"] <= 1.25 * off["plain"], off


@pytest.mark.cuda
def test_pos_conv_kernel_rejects_what_it_does_not_take(cuda):
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
        pos_conv as pc)
    conv, h = _pos_conv_inputs(cuda, 4, 40, 96, 48, 16)
    with torch.no_grad():
        with pytest.raises(ValueError, match="bf16"):
            pc.pos_conv(conv, h.float())
        with pytest.raises(ValueError, match="contiguous"):
            pc.pos_conv(conv, h.transpose(0, 1))
        with pytest.raises(ValueError, match="even K"):
            pc.pos_conv({"kernel": conv["kernel"][..., :15], "bias": conv["bias"]}, h)
        narrow, hn = _pos_conv_inputs(cuda, 4, 40, 64, 16, 16)
        with pytest.raises(ValueError, match="Cg in"):
            pc.pos_conv(narrow, hn)
    kernel = {"kernel": conv["kernel"].clone().requires_grad_(), "bias": conv["bias"]}
    with pytest.raises(RuntimeError, match="no backward"):
        pc.pos_conv(kernel, h)


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
    before = profiling.counters()["flash_attention.launches"]
    got = fa.flash_attention(q, k, v, mask, num_heads=H)
    want = fa.flash_attention_plain(q, k, v, mask, num_heads=H)
    torch.cuda.synchronize()
    assert profiling.counters()["flash_attention.launches"] == before + 1
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
    before = profiling.counters()["flash_attention.launches"]
    got = fa.flash_attention(q, k, v, mask, num_heads=H)
    want = fa.flash_attention_plain(q, k, v, mask, num_heads=H)
    torch.cuda.synchronize()
    assert profiling.counters()["flash_attention.launches"] == before + 1
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
    """x from a seeded generator, so that a failing draw replays
    (scripts/torch_pool_f32_seeds.py runs the f32 case over many draws)."""
    params = _pool_params(cuda, D, H, dtype, seed=S)
    g = torch.Generator(device=cuda).manual_seed(100 + S)
    x = torch.randn(5, S, D, device=cuda, generator=g).to(dtype)
    mask = torch.ones(5, S, device=cuda)
    mask[1, S // 3:] = 0
    mask[3] = 0                                    # a row with no valid frame
    before = profiling.counters()["attentive_stats_pooling.launches"]
    got = ap.attentive_stats_pooling(params, x, mask)
    want = ap.attentive_stats_pooling_plain(params, x, mask)
    torch.cuda.synchronize()
    assert profiling.counters()["attentive_stats_pooling.launches"] == before + 1
    tol = TOL if dtype == torch.float32 else BF16_TOL["attention"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_attentive_pooling_f32_route_over_seeded_draws(cuda):
    """The f32 route at the 2-valid-frame case over 64 seeded draws, each
    within 1e-4 of the plain version: rows whose weight sits on one frame,
    where E[x^2] - mean^2 loses a few ulps of x^2, are among them
    (scripts/torch_pool_f32_seeds.py runs 256)."""
    S, D, H = 7, 1536, 256
    params = _pool_params(cuda, D, H, torch.float32, seed=S)
    mask = torch.ones(5, S, device=cuda)
    mask[1, S // 3:] = 0
    mask[3] = 0
    for seed in range(64):
        g = torch.Generator(device=cuda).manual_seed(seed)
        x = torch.randn(5, S, D, device=cuda, generator=g)
        got = ap.attentive_stats_pooling(params, x, mask)
        want = ap.attentive_stats_pooling_plain(params, x, mask)
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL, msg=lambda m: f"{seed}: {m}")


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


def _pool_mask(device, B, S, seed):
    """Row 0 fully masked, row 1's whole last 64-frame tile (its second half
    if S <= 64) masked, row 2 fractional, the rest valid; one row: fractional."""
    g = torch.Generator(device=device).manual_seed(seed)
    mask = torch.ones(B, S, device=device)
    if B == 1:
        return torch.rand(1, S, device=device, generator=g)
    mask[0] = 0
    mask[1, ((S - 1) // 64 * 64 if S > 64 else S // 2):] = 0
    if B > 2:
        mask[2] = torch.rand(S, device=device, generator=g)
    return mask


# The largest B*S*D*H a case runs, so that each launch of the f32 route (its
# MLP on the CUDA cores) takes milliseconds: B=300 at S=1499 keeps D*H <= 24576.
POOL_WORK = 1.2e10
def _assert_pool_close(got, want, D, tol, what=""):
    """The mean half within tol, the std half through std^2 = max(var, 0)
    + 1e-6 within tol: where a row's variance is about 0 (one frame, or all
    weight on one frame) the square root multiplies the f32 rounding of
    E[x^2] - mean^2 by 1 / (2 std) = 500, so one ulp of E[x^2] (an FMA
    contracted on one side only) moves std by 1e-4."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got[:, :D], want[:, :D], rtol=tol, atol=tol,
                               msg=lambda m: f"{what} mean: {m}")
    torch.testing.assert_close(got[:, D:] ** 2, want[:, D:] ** 2, rtol=tol, atol=tol,
                               msg=lambda m: f"{what} std^2: {m}")


# x dtype, W1 dtype, route, tolerance
POOL_ROUTES = {"bf16": (torch.bfloat16, torch.bfloat16, "bf16", BF16_TOL["attention"]),
               "f32": (torch.float32, torch.float32, "f32", TOL),
               "bf16x_f32w": (torch.bfloat16, torch.float32, "f32", BF16_TOL["attention"])}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(POOL_ROUTES))
@pytest.mark.parametrize("B", [1, 5, 300])
@pytest.mark.parametrize("S", [1, 7, 32, 45, 199, 1499])
def test_attentive_pooling_routes_match_plain(cuda, route, B, S):
    x_dtype, w_dtype, want_route, tol = POOL_ROUTES[route]
    for D, H in ((64, 32), (768, 128), (1536, 256), (768, 32)):
        if B * S * D * H > POOL_WORK:
            continue
        params = _pool_params(cuda, D, H, w_dtype, seed=S + D + H)
        g = torch.Generator(device=cuda).manual_seed(B * S)
        x = torch.randn(B, S, D, device=cuda, generator=g).to(x_dtype)
        mask = _pool_mask(cuda, B, S, seed=S)
        got = ap.attentive_stats_pooling(params, x, mask)
        assert ap.attentive_stats_pooling.last_route == want_route
        want = ap.attentive_stats_pooling_plain(params, x, mask)
        torch.cuda.synchronize()
        assert got.dtype == x_dtype and tuple(got.shape) == (B, 2 * D)
        _assert_pool_close(got, want, D, tol, f"D={D} H={H}")
        if B > 1:  # a row with no valid frame: mean 0, std 1e-3
            torch.testing.assert_close(got[0].float(), torch.cat(
                [torch.zeros(D), torch.full((D,), 1e-3)]).to(cuda), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(4, 199), (128, 199), (128, 32), (5, 1499)])
def test_attentive_pooling_bf16_repeats_bitwise(cuda, B, S):
    params = _pool_params(cuda, 768, 128, torch.bfloat16, seed=B)
    x = torch.randn(B, S, 768, device=cuda).bfloat16()
    mask = _pool_mask(cuda, B, S, seed=B)
    first = ap.attentive_stats_pooling(params, x, mask)
    second = ap.attentive_stats_pooling(params, x, mask)
    torch.cuda.synchronize()
    assert ap.attentive_stats_pooling.last_route == "bf16"
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_attentive_pooling_bf16_without_a_tensor_map_takes_the_f32_route(cuda):
    """D % 8 != 0 or an x off 16 bytes: no TMA; W1 widened to f32 (exact)."""
    for D, offset in ((36, 0), (64, 1)):
        params = _pool_params(cuda, D, 32, torch.bfloat16, seed=D)
        flat = torch.randn(3 * 40 * D + offset, device=cuda).bfloat16()
        x = flat[offset:].view(3, 40, D)
        mask = _pool_mask(cuda, 3, 40, seed=D)
        got = ap.attentive_stats_pooling(params, x, mask)
        assert ap.attentive_stats_pooling.last_route == "f32"
        want = ap.attentive_stats_pooling_plain(params, x, mask)
        torch.cuda.synchronize()
        _assert_pool_close(got, want, D, BF16_TOL["attention"])


def _dsp_batch(B=4, T=16000, seed=5):
    """1 s rows at 16 kHz: a 50 Hz hum over 130 Hz energy (notch and HPF),
    an AM square wave (denoise), a speech-like tone mix, and the hum row
    padded to 0.7 s."""
    t = np.arange(T) / 16000
    rng = np.random.default_rng(seed)
    fade = np.minimum(1.0, np.minimum(np.arange(T), np.arange(T)[::-1]) / (0.12 * T))
    am = 1.0 + 0.6 * np.sin(2 * np.pi * 3.0 * t)
    hum = (0.3 * np.sin(2 * np.pi * 50 * t) + 0.3 * np.sin(2 * np.pi * 130 * t)
           + 0.12 * np.sin(2 * np.pi * 220 * t) * am) * fade
    square = 0.35 * am * np.sign(np.sin(2 * np.pi * 370 * t)) * fade
    speech = am * (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 880 * t))
    rows = [hum, square, speech, hum][:B]
    wave = np.stack(rows) + 0.02 * rng.standard_normal((len(rows), T))
    mask = np.ones_like(wave)
    mask[3:, int(0.7 * T):] = 0
    return (torch.from_numpy((wave * mask).astype(np.float32)),
            torch.from_numpy(mask.astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("zero_non_accept", [False, True])
def test_frontend_process_on_the_card_matches_the_cpu(cuda, zero_non_accept):
    """The front-end DSP on the card against the port's own CPU result:
    gate decisions and conditioning flags equal, features within 1e-4,
    the wave within 1e-4 of each row's peak (cuFFT against pocketfft)."""
    wave, mask = _dsp_batch()
    ent, conf = torch.ones(4), torch.full((4,), 0.5)
    kw = dict(zero_non_accept=zero_non_accept)
    want = frontend.frontend_process(wave, mask, lid_entropy=ent, lid_confidence=conf, **kw)
    got = frontend.frontend_process(wave.to(cuda), mask.to(cuda), lid_entropy=ent.to(cuda),
                                    lid_confidence=conf.to(cuda), **kw)
    torch.cuda.synchronize()
    assert got[0].device.type == "cuda"
    peak = want[0].abs().amax(-1, keepdim=True).clamp(min=1e-30)
    assert ((got[0].cpu() - want[0]).abs() <= 1e-4 * peak).all()
    for g, w in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(g.cpu(), w, rtol=TOL, atol=TOL)
    assert torch.equal(got[3]["quality"].decision.cpu(), want[3]["quality"].decision)
    for flag in ("hum_filtered", "hpf_applied", "denoise_applied", "dereverb_applied",
                 "noise_type"):
        assert torch.equal(getattr(got[3]["conditioning"], flag).cpu(),
                           getattr(want[3]["conditioning"], flag)), flag


@pytest.mark.cuda
def test_frontend_process_reads_only_its_branch_predicates(cuda):
    """The DSP's only device-to-host reads are condition_audio's three gates
    (notch/HPF, denoise, dereverb): torch's sync debug mode warns once for
    each synchronising call."""
    wave, mask = (x.to(cuda) for x in _dsp_batch())
    ent, conf = torch.ones(4, device=cuda), torch.zeros(4, device=cuda)
    frontend.frontend_process(wave, mask, lid_entropy=ent, lid_confidence=conf)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            frontend.frontend_process(wave, mask, lid_entropy=ent, lid_confidence=conf)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 3, [str(w.message) for w in syncs]


def _host_reads(fn) -> int:
    """How many calls inside fn() waited for the card (torch's sync debug
    mode warns once for each)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _tiny_eval_config():
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
    return tcfg.Config(model=tcfg.ModelConfig(
        num_labels=4, adapter_dim=8, shared_dim=16, num_heads=4, proj_dim=32,
        classifier_layers=3, classifier_base_dim=32,
        audio=tcfg.Wav2Vec2Config(conv_dim=(8, 8), conv_stride=(10, 8), conv_kernel=(10, 3),
                                  hidden_size=16, num_hidden_layers=2, num_attention_heads=4,
                                  intermediate_size=32, num_conv_pos_embeddings=16,
                                  num_conv_pos_embedding_groups=4),
        text=tcfg.XLMRConfig(vocab_size=100, hidden_size=16, num_hidden_layers=2,
                             num_attention_heads=4, intermediate_size=32,
                             max_position_embeddings=40)))


def _tiny_large(preset, compute_dtype="float32"):
    """A large preset's flags at tiny widths (3 convs of 16 channels, hidden
    32, 2 layers; WavLM's buckets 16 / 40), and 3 padded 0.1 s rows with
    precomputed front-end features."""
    import dataclasses

    from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
    audio = dataclasses.replace(
        tcfg.AUDIO_BACKBONE_PRESETS[preset](), conv_dim=(16, 16, 16), conv_stride=(5, 2, 2),
        conv_kernel=(10, 3, 3), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        num_buckets=16, max_bucket_distance=40)
    cfg = dataclasses.replace(_tiny_eval_config().model, audio=audio,
                              compute_dtype=compute_dtype, frontend_dsp=False)
    rng = np.random.default_rng(1)
    mask = np.ones((3, 1600), np.float32)
    mask[1, 1100:] = 0
    mask[2, 700:] = 0
    batch = {"audio": rng.standard_normal((3, 1600)).astype(np.float32) * mask,
             "audio_mask": mask,
             "text_ids": rng.integers(2, 100, (3, 10)).astype(np.int32),
             "text_mask": np.ones((3, 10), np.float32),
             "quality_feats": rng.standard_normal((3, 8)).astype(np.float32),
             "cond_feats": rng.standard_normal((3, 12)).astype(np.float32)}
    return cfg, batch


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("preset", ["wav2vec2-large", "wavlm-large"])
def test_large_preset_forward_on_the_card_matches_the_cpu(cuda, preset, dtype, tol):
    """A large preset's flags (layer-norm convs, stable pre-LN, WavLM's
    gated bias) at tiny widths: model_forward on the card against the CPU
    on padded rows, one A1 launch. cuDNN's convolutions run without TF32,
    as chip_smoke.py's card-against-CPU phases run them."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as tm)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        tree_to)
    cfg, batch = _tiny_large(preset, dtype)
    params = tm.init_model(cfg, torch.Generator().manual_seed(2), "cpu")
    want = tm.model_forward(params, cfg, batch)
    before = profiling.counters()["residual_stack.launches"]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = tm.model_forward(tree_to(params, cuda), cfg, batch)
        torch.cuda.synchronize()
    assert profiling.counters()["residual_stack.launches"] == before + 1
    for field, g, w in zip(want._fields, got, want):
        torch.testing.assert_close(g.float().cpu(), w.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"{field}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 3e-2)])
def test_tta_step_on_the_card_matches_the_cpu(cuda, dtype, tol):
    """The TTA views within 1e-5 (the resampler is an f32 matmul, no TF32)
    and the 5-view step's logits within the dtype's bound, both sides fed
    the same noise draws; one step reads the card back 4 times: the DSP's
    three branch predicates and the logits."""
    import dataclasses

    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
        evaluate as ev)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as tm)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import audio_dsp
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        tree_to)
    wave, mask = _dsp_batch()
    draws = [torch.randn(wave.shape, generator=torch.Generator().manual_seed(s))
             for s in (1, 2)]
    want_w, want_m = audio_dsp.tta_expand(wave, mask, noise=draws)
    got_w, got_m = audio_dsp.tta_expand(wave.to(cuda), mask.to(cuda),
                                        noise=[d.to(cuda) for d in draws])
    assert torch.equal(got_m.cpu(), want_m)
    torch.testing.assert_close(got_w.cpu(), want_w, rtol=1e-5, atol=1e-5)

    cfg = _tiny_eval_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype))
    rng = np.random.default_rng(0)
    batch = {"audio": wave, "audio_mask": mask,
             "text_ids": torch.from_numpy(rng.integers(2, 100, (4, 10)).astype(np.int32)),
             "text_mask": torch.ones(4, 10), "lid_entropy": torch.ones(4),
             "lid_conf": torch.full((4,), 0.5)}
    params = tm.init_model(cfg.model, torch.Generator().manual_seed(0), "cpu")
    want = ev.make_tta_eval_step(cfg, device="cpu")(params, batch, noise=draws)
    card_params = tree_to(params, cuda)
    card_batch = tree_to(batch, cuda)
    step = ev.make_tta_eval_step(cfg, device=cuda)
    got = step(card_params, card_batch, noise=[d.to(cuda) for d in draws])
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)
    generator = torch.Generator(device=cuda).manual_seed(0)
    assert _host_reads(lambda: step(card_params, card_batch, generator).cpu()) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("preset,reads", [(None, 3), ("wavlm-large", 4)])
def test_every_host_read_of_a_dsp_forward_is_in_a_sync_span(cuda, preset, reads):
    """The eval step with the front-end DSP on reads the card back as many
    times as it opens `ser.sync.*` spans (utils/profiling): the DSP's three
    gates, and WavLM's bucket table copied from pageable memory."""
    import dataclasses

    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
        evaluate as ev)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as tm)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        tree_to)
    cfg = (_tiny_eval_config().model if preset is None
           else dataclasses.replace(_tiny_large(preset)[0], frontend_dsp=True))
    wave, mask = _dsp_batch()
    rng = np.random.default_rng(0)
    batch = tree_to({"audio": wave, "audio_mask": mask,
                     "text_ids": torch.from_numpy(rng.integers(2, 100, (4, 10)).astype(np.int32)),
                     "text_mask": torch.ones(4, 10)}, cuda)
    params = tree_to(tm.init_model(cfg, torch.Generator().manual_seed(0), "cpu"), cuda)
    step = ev.make_eval_step(cfg, device=cuda)
    step(params, batch)
    with profiling.tracing(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        syncs = _host_reads(lambda: step(params, batch))
    spans = [e.name for e in prof.events() if e.name.startswith("ser.sync.")]
    assert syncs == len(spans) == reads, spans


@pytest.mark.cuda
def test_prefetch_copies_without_host_reads(cuda):
    """The prefetch's pinned copies on its side stream read nothing back,
    and the consumer sees every batch's values."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import prefetch
    rng = np.random.default_rng(3)
    host = [{"audio": rng.standard_normal((8, 16000)).astype(np.float32),
             "labels": np.arange(8, dtype=np.int32)} for _ in range(6)]
    seen = []
    reads = _host_reads(lambda: seen.extend(
        prefetch.device_prefetch(iter(host), cuda, skip=("labels",))))
    assert reads == 0
    assert len(seen) == len(host)
    for (dev, hb), want in zip(seen, host):
        assert set(dev) == {"audio"} and dev["audio"].device.type == "cuda"
        assert hb is want
        np.testing.assert_array_equal(dev["audio"].cpu().numpy(), want["audio"])


@pytest.mark.cuda
def test_residual_stack_kernel_raises_under_autograd(cuda):
    """The kernel writes its output through a raw pointer and has no
    backward: where autograd records and x or a layer parameter wants a
    gradient, the wrapper raises instead of returning a tensor without
    history. Under no_grad it launches; on the CPU the plain version keeps
    its gradients."""
    stacked, x = _perturbed_stack(cuda, 3, 32, seed=1)
    x = x[:4].contiguous()
    with pytest.raises(RuntimeError, match="no backward"):
        rs.residual_stack(stacked, x.clone().requires_grad_(True))
    wants = {k: {n: (t.clone().requires_grad_(True) if n == "kernel" else t)
                 for n, t in v.items()} for k, v in stacked.items()}
    with pytest.raises(RuntimeError, match="no backward"):
        rs.residual_stack(wants, x)
    with torch.no_grad():
        before = profiling.counters()["residual_stack.launches"]
        out = rs.residual_stack(wants, x.clone().requires_grad_(True))
        assert profiling.counters()["residual_stack.launches"] == before + 1
        assert out.grad_fn is None
    cpu_x = x.cpu().requires_grad_(True)
    cpu_stack = {k: {n: t.cpu() for n, t in v.items()} for k, v in stacked.items()}
    (g,) = torch.autograd.grad(rs.residual_stack(cpu_stack, cpu_x).sum(), [cpu_x])
    assert g.abs().sum() > 0


def _train_setup(device, seed=0):
    """A tiny model with every dropout out (card and CPU draw differently),
    its optimizer and state, and a labelled batch with precomputed
    features."""
    import dataclasses

    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as tm)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        optimizer as topt)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        tree_to)
    m = _tiny_eval_config().model
    cfg = dataclasses.replace(
        m, classifier_dropout=0.0, cross_dropout=0.0, fusion_dropout=0.0, anchor_dropout=0.0,
        use_quality_gates=False, use_audio_conditioning=False, frontend_dsp=False,
        audio=dataclasses.replace(m.audio, hidden_dropout=0.0, attention_dropout=0.0,
                                  activation_dropout=0.0, apply_spec_augment=False),
        text=dataclasses.replace(m.text, hidden_dropout=0.0, attention_dropout=0.0))
    params = tree_to(tm.init_model(cfg, torch.Generator().manual_seed(seed), "cpu"), device)
    opt = topt.make_train_optimizer(params, lr=1e-3, total_steps=8)
    rng = np.random.default_rng(seed)
    batch = {"audio": torch.from_numpy(0.1 * rng.standard_normal((4, 8000)).astype(np.float32)),
             "audio_mask": torch.ones(4, 8000),
             "text_ids": torch.from_numpy(rng.integers(2, 100, (4, 10)).astype(np.int32)),
             "text_mask": torch.ones(4, 10), "labels": torch.arange(4, dtype=torch.int32),
             "quality_feats": torch.zeros(4, 8), "cond_feats": torch.zeros(4, 12)}
    return cfg, params, opt, opt.init(params), tree_to(batch, device)


def _noise_leaves(cfg, params, opt, batch):
    """The trainable leaves whose gradient is below 1e-5 of the largest
    one: zero but for rounding (the attention key biases)."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import TrainConfig
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        train_step as tts)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import runtime
    alias = {p: t.detach().requires_grad_(True) for p, t in opt.trainable(params)}
    view = runtime.map_leaves(params, lambda p, t: alias.get(p, t))
    loss, _ = tts.compute_loss(view, cfg, TrainConfig(), batch, generator=torch.Generator())
    grads = torch.autograd.grad(loss, list(alias.values()), allow_unused=True,
                                materialize_grads=True)
    scale = max(float(g.abs().max()) for g in grads)
    return {p for p, g in zip(alias, grads) if float(g.abs().max()) < 1e-5 * scale}


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Two steps, f32, dropout out: parameters within TOL of the CPU's,
    except the leaves whose gradient is zero but for rounding, which
    AdamW's g / sqrt(v) moves by about lr of either sign a step (held to
    2 lr a step); the frozen backbones bitwise unchanged; the count 2."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import TrainConfig
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        optimizer as topt, train_step as tts)
    noise = _noise_leaves(*[_train_setup("cpu")[i] for i in (0, 1, 2, 4)])
    runs = {}
    for dev in ("cpu", cuda):
        cfg, params, opt, state, batch = _train_setup(dev)
        start = {p: t.clone() for p, t in topt.leaves_with_paths(params)}
        step = tts.make_train_step(cfg, TrainConfig(grad_clip=1.0), opt, device=dev)
        for seed in (0, 1):
            step(params, state, batch, seed)
        assert int(state["count"]) == 2
        for p, t in topt.leaves_with_paths(params):
            if opt.labels[p] == topt.FROZEN:
                assert torch.equal(t, start[p]), p
        runs[str(dev)] = dict(topt.leaves_with_paths(params))
    for p, want in runs["cpu"].items():
        tol = 2 * 1e-3 * 2 if p in noise else TOL
        torch.testing.assert_close(runs[str(cuda)][p].cpu(), want, rtol=tol, atol=tol, msg=p)


@pytest.mark.cuda
@pytest.mark.parametrize("augment", [False, True])
def test_train_step_reads_nothing_back_with_precomputed_features(cuda, augment):
    """With the features in the batch (no DSP) a train step, augmentation
    with one speed factor a batch included, reads no value back from the
    card: the non-finite guard and the step count stay on it."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import TrainConfig
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import audio_dsp
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        train_step as tts)
    cfg, params, opt, state, batch = _train_setup(cuda)
    step = tts.make_train_step(cfg, TrainConfig(augment=augment), opt, device=cuda)
    probe = torch.zeros(1, 16000, device=cuda)
    for f in audio_dsp.SPEED_FACTORS:       # each resampler kernel reaches the card once
        audio_dsp.speed_perturb(probe, f)
    step(params, state, batch, 0)
    assert _host_reads(lambda: step(params, state, batch, 1)) == 0
    assert int(state["count"]) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_on_the_card_gives_the_gradients_of_no_remat(cuda, remat):
    """Unfrozen, every dropout and SpecAugment on, one CUDA generator seed:
    a checkpointed layer replays its generator's state in the backward, so
    the gradients are those without remat (up to the order of the atomic
    adds of the embedding gradient)."""
    import dataclasses

    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import TrainConfig
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as tm)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        train_step as tts)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import runtime
    base = _tiny_eval_config().model
    base = dataclasses.replace(base, frontend_dsp=False, audio=dataclasses.replace(
        base.audio, mask_time_prob=0.3, mask_time_length=3))
    params = tm.init_model(base, torch.Generator(device=cuda).manual_seed(0), cuda)
    _, _, _, _, batch = _train_setup(cuda)
    grads = {}
    for mode in ("none", remat):
        cfg = dataclasses.replace(base, remat_encoders=mode)
        alias = {p: t.detach().requires_grad_(True)
                 for p, t in runtime.leaves_with_paths(params)}
        view = runtime.map_leaves(params, lambda p, t: alias[p])
        loss, _ = tts.compute_loss(view, cfg, TrainConfig(freeze_backbones=False), batch,
                                   generator=torch.Generator(device=cuda).manual_seed(5))
        grads[mode] = dict(zip(alias, torch.autograd.grad(loss, list(alias.values()),
                                                          allow_unused=True,
                                                          materialize_grads=True)))
    for p, g in grads["none"].items():
        torch.testing.assert_close(grads[remat][p], g, rtol=1e-5, atol=1e-6, msg=p)
    assert grads["none"]["audio_backbone/layers/q/kernel"].abs().sum() > 0


@pytest.mark.cuda
def test_registered_op_on_the_card_is_the_kernel(cuda):
    """`ser_torch::residual_stack` on CUDA tensors launches the kernel (the
    wrapper's count moves) and equals the plain version."""
    stacked, x = _perturbed_stack(cuda, 35, 512, seed=7)
    x = x[:20].contiguous()
    before = profiling.counters()["residual_stack.launches"]
    got = torch.ops.ser_torch.residual_stack(x, *(stacked[a][b] for a, b in rs._LAYER_TENSORS))
    torch.cuda.synchronize()
    assert profiling.counters()["residual_stack.launches"] == before + 1
    torch.testing.assert_close(got, rs.residual_stack_plain(stacked, x), rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "int16"])
def test_exported_program_on_the_card_launches_a1_and_matches_eager(cuda, tmp_path, wire):
    """A tiny model with the DSP on, exported on the card: each predict
    launches the residual-stack kernel once, and its outputs equal the
    eager forward's on the same rows (the same ops on the same card)."""
    import dataclasses

    from multilingual_multimodal_speech_emotion_recognition_tpu_torch import export as ex
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as tm)
    cfg = dataclasses.replace(_tiny_eval_config().model, frontend_dsp=True)
    params = tm.init_model(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    art = ex.export_forward(params, cfg, tmp_path / "art", batch_size=4, audio_seconds=1.0,
                            text_tokens=10, wire=wire, device=cuda)
    served = ex.ServingModel(art, device=cuda)
    wave, mask = _dsp_batch()
    pcm = torch.clamp(torch.round(wave * 32768.0), -32768, 32767) * mask
    wave = pcm / 32768.0
    rng = np.random.default_rng(1)
    text = {"text_ids": rng.integers(2, 100, (4, 10)).astype(np.int32),
            "text_mask": np.ones((4, 10), np.float32),
            "lid_entropy": np.ones(4, np.float32), "lid_conf": np.full(4, 0.5, np.float32)}
    batch = dict(text, audio=wave.numpy(), audio_mask=mask.numpy())
    if wire == "int16":
        wire_batch = dict(text, audio=pcm.numpy().astype(np.int16),
                          audio_len=mask.sum(-1).numpy().astype(np.int32))
    else:
        wire_batch = batch
    before = profiling.counters()["residual_stack.launches"]
    got = served.predict(wire_batch)
    assert profiling.counters()["residual_stack.launches"] == before + 1
    with torch.inference_mode():
        want = tm.model_forward(params, cfg, batch, use_openmax=True)
    for name, w in (("logits", want.logits), ("uncertainty", want.uncertainty),
                    ("features", want.features)):
        np.testing.assert_allclose(got[name], w.float().cpu().numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)
    with pytest.raises(ValueError, match="traced for"):
        ex.ServingModel(art, device="cpu")


@pytest.mark.cuda
def test_exported_wavlm_large_on_the_card_matches_eager(cuda, tmp_path):
    """The stable pre-LN layers and WavLM's gated bias (its CPU bucket table
    copied to the card inside the program) exported on the card: a predict
    launches A1 once and equals the eager forward."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch import export as ex
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as tm)
    cfg, batch = _tiny_large("wavlm-large")
    params = tm.init_model(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    art = ex.export_forward(params, cfg, tmp_path / "art", batch_size=3, audio_seconds=0.1,
                            text_tokens=10, with_dsp=False, device=cuda)
    before = profiling.counters()["residual_stack.launches"]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = ex.ServingModel(art, device=cuda).predict(batch)
        assert profiling.counters()["residual_stack.launches"] == before + 1
        with torch.inference_mode():
            want = tm.model_forward(params, cfg, batch, use_openmax=True)
    for name, w in (("logits", want.logits), ("uncertainty", want.uncertainty),
                    ("features", want.features)):
        np.testing.assert_allclose(got[name], w.float().cpu().numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.cuda
def test_pipeline_and_interface_on_the_card_launch_a1(cuda, tmp_path):
    """The staged pipeline, the stream and the interface run the eval
    forward on the card: one kernel launch a segment, a call or a TTA call."""
    import dataclasses

    from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
        config as tcfg, integration, interface)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
        audio_io, tokenizer)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as tm)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        checkpoint as ck)
    cfg = _tiny_eval_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, frontend_dsp=True),
                              data=dataclasses.replace(cfg.data, max_text_tokens=10))
    params = tm.init_model(cfg.model, torch.Generator(device=cuda).manual_seed(0), cuda)
    wave = _dsp_batch()[0][0].numpy()
    tok = tokenizer.HashTokenizer(100)
    before = profiling.counters()["residual_stack.launches"]
    pipe = integration.DataFlowPipeline(params, cfg, tokenizer=tok)
    out = pipe.process_long_audio(np.tile(wave, 2), "hello", segment_seconds=1.0)
    # 50 % overlap
    assert profiling.counters()["residual_stack.launches"] == before + len(out) == before + 3
    stream = integration.StreamingRecognizer(params, cfg, segment_seconds=0.5, tokenizer=tok)
    results = stream.push_audio(wave, "hello") + [stream.flush("hello")]
    assert results[-1] is None and len(results) == 3
    assert profiling.counters()["residual_stack.launches"] == before + 5
    ck.save_checkpoint(tmp_path / "ck", params=params, config_json=tcfg.to_json(cfg))
    audio_io.write_wav(tmp_path / "a.wav", wave, 16000)
    iface = interface.EmotionRecognitionInterface(str(tmp_path / "ck"), tokenizer=tok)
    for tta in (False, True):
        res = iface.predict_emotion(str(tmp_path / "a.wav"), "hello", use_tta=tta)
        assert np.isfinite(res["logits"]).all()
    assert profiling.counters()["residual_stack.launches"] == before + 7


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 16, 17, 796])
@pytest.mark.parametrize("I,O", [(768, 3072), (64, 24), (512, 8)])
def test_int8_matmul_on_the_card_is_the_exact_product(cuda, rows, I, O):
    """torch._int_mm on the card, rows under 17 padded, against the plain
    int32 product on the same int8 inputs: bitwise; a row-major kernel_q
    and dims off a multiple of 8 raise."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import quant
    g = torch.Generator().manual_seed(rows + I)
    xq = torch.randint(-127, 128, (rows, I), generator=g, dtype=torch.int8)
    kq = quant.card_layout(torch.randint(-127, 128, (I, O), generator=g, dtype=torch.int8))
    before = profiling.counters()["int8_matmul.launches"]
    got = quant.int8_matmul(xq.to(cuda), kq.to(cuda))
    assert profiling.counters()["int8_matmul.launches"] == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), quant.int8_matmul_plain(xq, kq))
    with pytest.raises(ValueError, match="column-major"):
        quant.int8_matmul(xq.to(cuda), kq.contiguous().to(cuda))
    with pytest.raises(ValueError, match="multiple of 8"):
        quant.int8_matmul(xq[:, :I - 4].to(cuda), kq[:I - 4].to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_int8_on_the_card_matches_the_cpu(cuda, dtype):
    """The same quantised slot and input: the activations quantise to the
    same int8 values and the product is exact, so the card's output is the
    CPU's up to the dequantisation's f32 products (equal) and the cast."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import quant
    g = torch.Generator().manual_seed(0)
    p = quant.quantize_linear({"kernel": torch.randn(3, 768, 3072, generator=g),
                               "bias": torch.randn(3, 3072, generator=g)})
    p = {k: v[1] for k, v in p.items()}
    for rows in (4, 4 * 199):
        x = torch.randn(rows, 768, generator=g).to(dtype)
        want = quant.linear_int8(p, x)
        got = quant.linear_int8({k: v.to(cuda) for k, v in p.items()}, x.to(cuda))
        assert got.dtype == dtype
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_whisper_decode_on_the_card_matches_the_cpu(cuda, int8):
    """A tiny Whisper (d 64, 2 + 2 layers, quantised at min_size 16 for
    the int8 case) transcribes 2 s clips on the card as on the CPU: tokens
    equal, confidences within 1e-4 (f32, TF32 off)."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        whisper as tw)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import quant
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        tree_to)
    cfg = tw.WhisperConfig(vocab_size=320, d_model=64, encoder_layers=2,
                           encoder_attention_heads=4, decoder_layers=2,
                           decoder_attention_heads=4, encoder_ffn_dim=128,
                           decoder_ffn_dim=128, max_target_positions=64,
                           decoder_start_token_id=1, eos_token_id=2)
    params = tw.init_whisper(cfg, torch.Generator().manual_seed(0), "cpu")
    if int8:
        params = quant.quantize_whisper(params, min_size=16)
    wave = 0.1 * torch.randn(3, 32000, generator=torch.Generator().manual_seed(1))
    prefix = torch.tensor([[1, 5, 9]] * 3, dtype=torch.int32)
    want_t, want_c = tw.transcribe_batch(params, cfg, wave, prefix, max_new_tokens=8)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            got_t, got_c = tw.transcribe_batch(tree_to(params, cuda), cfg, wave.to(cuda),
                                               prefix.to(cuda), max_new_tokens=8)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.equal(got_t.cpu(), want_t)
    torch.testing.assert_close(got_c.cpu(), want_c, rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("noise_type", ["gaussian", "babble", "music"])
def test_add_noise_at_snr_on_the_card_matches_the_cpu(cuda, noise_type):
    """eval/robustness.add_noise_at_snr on 4 s rows, two padded: the sines'
    phases and the SNR scaling in f32 on both devices, the gaussian case fed
    one standard-normal draw; within 1e-5 (f32 summation order)."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import robustness
    rng = np.random.default_rng(2)
    mask = np.ones((4, 64000), np.float32)
    mask[1, 40000:] = 0
    mask[3, 9000:] = 0
    wave = torch.from_numpy((0.3 * rng.standard_normal((4, 64000))).astype(np.float32) * mask)
    mask = torch.from_numpy(mask)
    draw = torch.from_numpy(rng.standard_normal((4, 64000)).astype(np.float32))
    for snr in (20.0, 0.0):
        want = robustness.add_noise_at_snr(wave, mask, snr, noise_type=noise_type, noise=draw)
        got = robustness.add_noise_at_snr(wave.to(cuda), mask.to(cuda), snr,
                                          noise_type=noise_type, noise=draw.to(cuda))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_few_shot_adapt_on_the_card_matches_the_cpu(cuda):
    """eval/few_shot.adapt over two batches of a dropout-free tiny model on
    the card and on the CPU from the same parameters: the trained leaves
    within TOL (f32, TF32 off), the frozen leaves and the base unchanged."""
    import dataclasses

    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import few_shot
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import model as tm
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import runtime
    cfg = _tiny_eval_config().model
    cfg = dataclasses.replace(
        cfg, frontend_dsp=False, use_quality_gates=False, use_audio_conditioning=False,
        classifier_dropout=0.0, cross_dropout=0.0, fusion_dropout=0.0, anchor_dropout=0.0,
        audio=dataclasses.replace(cfg.audio, hidden_dropout=0.0, attention_dropout=0.0,
                                  activation_dropout=0.0, apply_spec_augment=False),
        text=dataclasses.replace(cfg.text, hidden_dropout=0.0, attention_dropout=0.0))
    base = tm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    batches = [{"audio": rng.standard_normal((4, 1600)).astype(np.float32),
                "audio_mask": np.ones((4, 1600), np.float32),
                "text_ids": rng.integers(2, 100, (4, 10)).astype(np.int32),
                "text_mask": np.ones((4, 10), np.float32),
                "labels": np.array([0, 1, 2, 3], np.int32),
                "example_mask": np.array([1, 1, 1, i == 0], np.float32)} for i in range(2)]
    want = few_shot.adapt(base, cfg, lambda: batches, num_epochs=1, lr=1e-3)
    card_base = runtime.tree_to(base, cuda)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            got = few_shot.adapt(card_base, cfg, lambda: batches, num_epochs=1, lr=1e-3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    before = dict(runtime.leaves_with_paths(base))
    card_before = dict(runtime.leaves_with_paths(card_base))
    for path, t in runtime.leaves_with_paths(got):
        torch.testing.assert_close(t.cpu(), dict(runtime.leaves_with_paths(want))[path],
                                   rtol=TOL, atol=TOL, msg=path)
        if path.split("/")[0] not in few_shot.TRAINABLE:
            assert torch.equal(t.cpu(), before[path]), path
        assert torch.equal(card_before[path].cpu(), before[path]), path

"""The grouped positional conv (ops/pos_conv) and its route onto the kernel
(models/wav2vec2.pos_conv_route), on the CPU.

The kernel runs only on a card (tests/test_torch_cuda.py); here the plain
version is held to the chain `_positional_conv` ran before it bit for bit
and to the JAX package's conv, the route is checked on fake CUDA tensors
(torch's FakeTensorMode, which needs no card) with the op's fake kernel,
and torch.export of the op shows one node.
"""

import dataclasses

import numpy as np
import pytest
import jax
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from multilingual_multimodal_speech_emotion_recognition_tpu import config as jcfg
from multilingual_multimodal_speech_emotion_recognition_tpu.models import (
    layers as jl, wav2vec2 as jw)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
    Wav2Vec2Config)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    layers, wav2vec2 as tw)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import pos_conv as pc
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import distill

from test_model import tiny_config
from torch_port_helpers import META, assert_close, bridge, j, perturb, t

RNG = np.random.default_rng(23)
# (Cg, K, groups): wav2vec2-base's and WavLM's widths a group at their K,
# the small student's K, and the tiny student's groups
SHAPES = {"cg48-k128": (48, 128, 2), "cg64-k64": (64, 64, 2), "cg16-k16": (16, 16, 4)}
# valid frames of each row of h: all, some, none
FRAMES = (37, 20, 0)
T = 37


def _conv(Cg, K, G, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    C = Cg * G
    return {"kernel": (torch.randn(C, Cg, K, generator=g) * (4.0 / (K * C)) ** 0.5).to(dtype),
            "bias": (0.1 * torch.randn(C, generator=g)).to(dtype)}


def _h(C, dtype=torch.float32, seed=1):
    """h [3, T, C] zero on each row's padded frames, as wav2vec2_encode
    hands it to the conv."""
    g = torch.Generator().manual_seed(seed)
    mask = (torch.arange(T)[None, :] < torch.tensor(FRAMES)[:, None]).float()
    return (torch.randn(len(FRAMES), T, C, generator=g) * mask[..., None]).to(dtype)


def _old_chain(conv, h, G, K):
    """`_positional_conv` as it ran before the kernel, without `tp`."""
    pos = layers.conv1d(conv, h.transpose(1, 2), 1, groups=G, padding=K // 2)
    return layers.gelu(pos[:, :, : h.shape[1]].transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_pos_conv_plain_is_the_old_chain(shape, dtype):
    """Bit for bit, on rows with all, some and no valid frames."""
    Cg, K, G = SHAPES[shape]
    conv, h = _conv(Cg, K, G, dtype), _h(Cg * G, dtype)
    got = pc.pos_conv_plain(conv, h)
    assert got.dtype == dtype and tuple(got.shape) == tuple(h.shape)
    assert torch.equal(got, _old_chain(conv, h, G, K))
    assert torch.equal(pc.pos_conv(conv, h), got)   # the registered op's CPU implementation


@pytest.mark.parametrize("shape", list(SHAPES))
def test_pos_conv_plain_matches_jax(shape):
    """Against the JAX package's conv (lax.conv, kernel [K, Cg, C] WIO),
    cut to T frames, and its GELU, in f32."""
    Cg, K, G = SHAPES[shape]
    conv, h = _conv(Cg, K, G), _h(Cg * G)
    jconv = {"kernel": j(conv["kernel"].permute(2, 1, 0).numpy()), "bias": j(conv["bias"].numpy())}
    want = jw._conv1d(jconv, j(h.numpy()), 1, groups=G, padding=K // 2)[:, :T, :]
    assert_close(pc.pos_conv_plain(conv, h), jl.gelu(want), 1e-5)


def test_pos_conv_keeps_its_history_on_cpu():
    """Where autograd records and the kernel wants a gradient, the wrapper
    takes the plain version on the CPU, so the gradient reaches it."""
    conv, h = _conv(48, 16, 2), _h(96)
    conv["kernel"].requires_grad_()
    pc.pos_conv(conv, h).square().sum().backward()
    assert conv["kernel"].grad is not None and conv["kernel"].grad.abs().sum() > 0


@pytest.mark.parametrize("shape,supported", [
    ((48, 128), True), ((64, 128), True), ((48, 64), True), ((48, 2), True),
    ((16, 16), False), ((32, 128), False), ((48, 127), False), ((64, 130), False),
], ids=["base", "large", "small-student", "k2", "tiny-student", "cg32", "k-odd", "k130"])
def test_pos_conv_supported(shape, supported):
    assert pc.pos_conv_supported(*shape) is supported


def test_encode_matches_jax_at_a_kernel_shape():
    """wav2vec2_encode on the CPU against the JAX package where the groups
    are the kernel's width (Cg = 48): the CPU takes the plain chain, held
    as tests/test_torch_encoders.py holds the tiny model, in f32."""
    jc = tiny_config()
    jc = dataclasses.replace(jc, audio=dataclasses.replace(
        jc.audio, hidden_size=96, num_attention_heads=4, num_conv_pos_embedding_groups=2))
    tc = tcfg.from_json(jcfg.to_json(jc))
    jp = perturb(jw.init_wav2vec2(jax.random.key(3), jc.audio), RNG, 0.02)
    tp = bridge(jp, tw.init_wav2vec2(META, tc.audio))
    wave = RNG.standard_normal((3, 800)).astype(np.float32)
    mask = np.ones((3, 800), np.float32)
    mask[1, 530:] = 0
    wave[1, 530:] = 0
    want_h, want_m = jax.jit(lambda p, w, m: jw.wav2vec2_encode(p, jc.audio, w, m))(
        jp, j(wave), j(mask))
    got_h, got_m = tw.wav2vec2_encode(tp, tc.audio, t(wave), t(mask))
    assert tp["pos_conv"]["kernel"].shape[1] == 48
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert_close(got_h, want_h, 1e-4)


# ------------------------------------------------------------ the route

BASE = Wav2Vec2Config()
WAVLM = tcfg.AUDIO_BACKBONE_PRESETS["wavlm-large"]()
SMALL = distill.student_model_config(tcfg.ModelConfig(), "small").audio
TINY = distill.student_model_config(tcfg.ModelConfig(), "tiny").audio
ROUTE_CASES = {
    # case: (config, h dtype, grad, tp, on the card, taken); grad "off":
    # nothing wants a gradient; "records": the kernel does, under grad
    # mode; "no-grad": it does, under torch.no_grad()
    "wav2vec2-base": (BASE, torch.bfloat16, "off", False, True, True),
    "wavlm-large": (WAVLM, torch.bfloat16, "off", False, True, True),
    "small-student": (SMALL, torch.bfloat16, "off", False, True, True),
    "no-grad-over-trainable": (BASE, torch.bfloat16, "no-grad", False, True, True),
    "grad-records": (BASE, torch.bfloat16, "records", False, True, False),
    "tp": (BASE, torch.bfloat16, "off", True, True, False),
    "f32": (BASE, torch.float32, "off", False, True, False),
    "tiny-student": (TINY, torch.bfloat16, "off", False, True, False),
    "cpu": (BASE, torch.bfloat16, "off", False, False, False),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_pos_conv_route(case):
    """The conv takes the kernel for a (fake) CUDA bf16 h at the
    wav2vec2-base, WavLM-Large and small-student shapes with no gradient
    recorded for it; not with a recorded gradient, under tensor
    parallelism, in f32, at the tiny student's Cg = 16 or on the CPU."""
    cfg, dtype, grad, tp, on_card, taken = ROUTE_CASES[case]
    C, G, K = cfg.hidden_size, cfg.num_conv_pos_embedding_groups, cfg.num_conv_pos_embeddings
    device = "cuda" if on_card else "cpu"
    with FakeTensorMode(), torch.set_grad_enabled(grad != "no-grad"):
        params = {"pos_conv": {
            "kernel": torch.empty(C, C // G, K, dtype=dtype, device=device,
                                  requires_grad=grad != "off"),
            "bias": torch.empty(C, dtype=dtype, device=device)}}
        h = torch.empty(2, 99, C, dtype=dtype, device=device)
        assert tw.pos_conv_route(params, cfg, h, object() if tp else None) is taken


def test_positional_conv_takes_the_kernel_where_the_route_holds(monkeypatch):
    """Where `pos_conv_route` holds, `_positional_conv` calls the op once;
    its CPU implementation then gives the plain chain's values bit for
    bit."""
    cfg = dataclasses.replace(BASE, hidden_size=96, num_conv_pos_embedding_groups=2,
                              num_conv_pos_embeddings=16)
    params = {"pos_conv": _conv(48, 16, 2, torch.bfloat16)}
    h = _h(96, torch.bfloat16)
    want = tw._positional_conv(params, cfg, h)
    calls = []
    real = pc.pos_conv
    monkeypatch.setattr(pc, "pos_conv", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tw, "pos_conv_route", lambda *a: True)
    got = tw._positional_conv(params, cfg, h)
    assert calls == [1] and got.is_contiguous()
    assert torch.equal(got, want)


# ------------------------------------------------ registered op, export

def test_fake_kernel_gives_the_shape_and_dtype():
    """`ser_torch::pos_conv`: h's shape, dtype and device."""
    with FakeTensorMode():
        h = torch.empty(3, 199, 768, dtype=torch.bfloat16, device="cuda")
        kernel = torch.empty(768, 48, 128, dtype=torch.bfloat16, device="cuda")
        bias = torch.empty(768, dtype=torch.bfloat16, device="cuda")
        pos = torch.ops.ser_torch.pos_conv(h, kernel, bias)
    assert tuple(pos.shape) == (3, 199, 768) and pos.dtype == torch.bfloat16 and pos.is_cuda


class _PosConv(torch.nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    def forward(self, h):
        return pc.pos_conv(self.conv, h)


def test_export_holds_one_node():
    """torch.export of a graph that calls the op traces one node for it
    (the kernel on the card), and the program computes the plain version."""
    module = _PosConv(_conv(48, 16, 2, torch.bfloat16))
    h = _h(96, torch.bfloat16)
    with torch.no_grad():
        program = torch.export.export(module, (h,), strict=False)
        got = program.module()(h)
        want = module(h)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("ser_torch.pos_conv.default") == 1, targets
    assert torch.equal(got, want)

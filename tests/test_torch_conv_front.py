"""The conv-extractor front (ops/conv_front) and the extractor's route onto
the two kernels (models/wav2vec2.front_route), on the CPU.

The kernels run only on a card (tests/test_torch_cuda.py); here the plain
version is held to the unfused chain bit for bit, the route is checked on
fake CUDA tensors (torch's FakeTensorMode, which needs no card) with the
ops' fake kernels, and torch.export of each op shows one node.
"""

import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
    Wav2Vec2Config)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    layers, wav2vec2 as tw)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
    conv_front as cf, conv_tail as ct)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import profiling

C = 128
TAIL = Wav2Vec2Config(conv_dim=(C,) * 7)   # the base extractor's geometry at C=128
# ragged rows: no valid frame (7 samples), one frame, the bucket's full
# length, and two in between
LENGTHS = (7, 10, 4000, 2345, 1234)


def _params(cfg: Wav2Vec2Config, seed: int = 0, dtype=torch.float32) -> dict:
    p = tw.init_wav2vec2(layers.Init(torch.Generator().manual_seed(seed), "cpu"), cfg)
    g = torch.Generator().manual_seed(seed + 1)
    if "group_norm" in p:
        c = cfg.conv_dim[0]
        p["group_norm"] = {"scale": 1 + 0.1 * torch.randn(c, generator=g),
                           "bias": 0.1 * torch.randn(c, generator=g)}
    convs = [{k: (v.to(dtype) if k != "ln" else v) for k, v in conv.items()}
             for conv in p["convs"]]
    return {"convs": convs, **{k: v for k, v in p.items() if k != "convs"}}


def _wave(dtype, T: int = 4000, lengths=LENGTHS, seed: int = 3):
    g = torch.Generator().manual_seed(seed)
    mask = (torch.arange(T)[None, :] < torch.tensor(lengths)[:, None]).float()
    wave = tw.normalize_waveform(torch.randn(len(lengths), T, generator=g), mask)
    return wave.to(dtype), mask


@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_conv_front_plain_is_the_unfused_chain(dtype, bias):
    """conv 0 (with its bias where it has one), the masked group norm
    over (len - 10) // 5 + 1 valid frames, GELU and the transpose to
    [B, T1, C], bit for bit; the row with no valid frame too."""
    p = _params(TAIL, dtype=dtype)
    conv0 = dict(p["convs"][0])
    if bias:
        conv0["bias"] = (0.1 * torch.randn(C, generator=torch.Generator().manual_seed(9))
                         ).to(dtype)
    wave, mask = _wave(dtype)
    samples = mask.to(torch.int32).sum(-1)
    x = layers.conv1d(conv0, wave[:, None, :], 5)
    frames = (samples - 10) // 5 + 1
    fm = torch.arange(x.shape[-1])[None, :] < frames[:, None]
    want = layers.gelu(cf.masked_group_norm_per_channel(p["group_norm"], x, fm)).transpose(1, 2)
    got = cf.conv_front_plain(conv0, p["group_norm"], wave, samples, 5)
    assert got.dtype == dtype and tuple(got.shape) == (len(LENGTHS), 799, C)
    assert torch.equal(got, want)
    assert frames[0] < 1 and frames[2] == got.shape[1]   # no frame; the full bucket
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_conv_front_on_cpu_is_the_plain_version(dtype):
    """The wrapper goes through `ser_torch::conv_front`, whose CPU
    implementation is the plain version: equal values, contiguous, and
    no launch counted."""
    p = _params(TAIL, dtype=dtype)
    wave, mask = _wave(dtype)
    samples = mask.to(torch.int32).sum(-1)
    before = profiling.counters()["conv_front.launches"]
    got = cf.conv_front(p["convs"][0], p["group_norm"], wave, samples, 5)
    assert profiling.counters()["conv_front.launches"] == before
    assert got.is_contiguous()
    assert torch.equal(got, cf.conv_front_plain(p["convs"][0], p["group_norm"], wave,
                                                samples, 5))


def test_conv_front_and_tail_keep_their_history_on_cpu():
    """Where autograd records and a parameter wants a gradient, both
    wrappers take the plain version on the CPU, so the gradient reaches
    the parameters."""
    p = _params(TAIL)
    wave, mask = _wave(torch.float32)
    samples = mask.to(torch.int32).sum(-1)
    kernel = p["convs"][0]["kernel"].requires_grad_()
    tail_kernel = p["convs"][3]["kernel"].requires_grad_()
    x1 = cf.conv_front(p["convs"][0], p["group_norm"], wave, samples, 5)
    ct.conv_tail(p["convs"], x1, has_ln=False).square().sum().backward()
    assert kernel.grad is not None and kernel.grad.abs().sum() > 0
    assert tail_kernel.grad is not None and tail_kernel.grad.abs().sum() > 0


@pytest.mark.parametrize("geometry,supported", [
    (((10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2), (512,) * 7), True),
    (((10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2), (128,) * 7), True),
    (((10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2), (100,) * 7), False),
    (((8, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2), (512,) * 7), False),
    (((10, 3, 3, 3, 3, 2, 2), (4, 2, 2, 2, 2, 2, 2), (512,) * 7), False),
    (((10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2), (8192,) * 7), False),
], ids=["base", "c128", "c100", "k8", "s4", "c8192"])
def test_conv_front_supported(geometry, supported):
    assert cf.conv_front_supported(*geometry) is supported


# ------------------------------------------------------------ the route

def _on_fake_card(mode, tree):
    """Fake CUDA tensors (no card is needed) of the tree's tensors' shapes,
    dtypes and requires_grad, made inside `mode`."""
    if isinstance(tree, dict):
        return {k: _on_fake_card(mode, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on_fake_card(mode, v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype, device="cuda",
                       requires_grad=tree.requires_grad)


def _spy(monkeypatch):
    calls = []
    for module, name in ((cf, "conv_front"), (ct, "conv_tail")):
        real = getattr(module, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(module, name, spy)
    return calls


ROUTE_CASES = {
    # case: (config, wave dtype, grad, on the card, taken); grad "off":
    # nothing wants a gradient; "records": conv 0 does, under grad mode;
    # "no-grad": it does, under torch.no_grad()
    "group-bf16": (TAIL, torch.bfloat16, "off", True, True),
    "no-grad-over-trainable": (TAIL, torch.bfloat16, "no-grad", True, True),
    "layer-mode": (dataclasses.replace(TAIL, feat_extract_norm="layer", conv_bias=True),
                   torch.bfloat16, "off", True, False),
    "f32": (TAIL, torch.float32, "off", True, False),
    "grad-records": (TAIL, torch.bfloat16, "records", True, False),
    "c100": (Wav2Vec2Config(conv_dim=(100,) * 7), torch.bfloat16, "off", True, False),
    "tail-geometry": (Wav2Vec2Config(conv_dim=(C,) * 7, conv_kernel=(10, 3, 3, 3, 3, 3, 2)),
                      torch.bfloat16, "off", True, False),
    "cpu": (TAIL, torch.bfloat16, "off", False, False),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_front_route(case):
    """The extractor takes the two kernels for a (fake) CUDA bf16 wave,
    group mode, both kernels' geometry and no gradient recorded for it;
    not for layer mode, f32, a recorded gradient, another geometry or a
    CPU wave (the CPU parity tests run the unfused path)."""
    cfg, dtype, grad, on_card, taken = ROUTE_CASES[case]
    params = _params(cfg, dtype=dtype)
    if grad != "off":
        for t in params["convs"][0].values():
            t.requires_grad_()
    wave, _ = _wave(dtype)
    with FakeTensorMode() as mode, torch.set_grad_enabled(grad != "no-grad"):
        if on_card:
            params, wave = _on_fake_card(mode, [params, wave])
        assert tw.front_route(params, cfg, wave) is taken


@pytest.mark.parametrize("allow_fused", [False, True])
def test_feature_encoder_takes_the_kernels_where_the_route_holds(monkeypatch, allow_fused):
    """Where `front_route` holds, feature_encoder calls conv_front and then
    conv_tail on its [B, T1, C] output, once each, whatever allow_fused
    says; their CPU ops (the plain versions) then give the unfused path's
    frames and mask, within the conv tail's bf16 bound (the tail's
    products are summed in another order)."""
    params = _params(TAIL, dtype=torch.bfloat16)
    wave, mask = _wave(torch.bfloat16)
    unfused, unfused_mask = tw.feature_encoder(params, TAIL, wave, mask)
    calls = _spy(monkeypatch)
    monkeypatch.setattr(tw, "front_route", lambda *a: True)
    got, got_mask = tw.feature_encoder(params, TAIL, wave, mask, allow_fused=allow_fused)
    assert calls == ["conv_front", "conv_tail"]
    assert got.dtype == torch.bfloat16 and got.shape == unfused.shape
    assert torch.equal(got_mask, unfused_mask)
    torch.testing.assert_close(got.float(), unfused.float(), rtol=4e-2, atol=4e-2)


# ------------------------------------------------ registered ops, export

def _fake_op_inputs(mode, B=3, T=4000):
    params = _on_fake_card(mode, _params(TAIL, dtype=torch.bfloat16))
    wave = torch.zeros(B, T, dtype=torch.bfloat16, device="cuda")
    samples = torch.full((B,), T, dtype=torch.int64, device="cuda")
    return params, wave, samples


def test_fake_kernels_give_the_shapes_and_dtypes():
    """`ser_torch::conv_front`: [B, (T - 10) // 5 + 1, C] bf16 on the
    wave's device; `ser_torch::conv_tail`: [B, T7, C] in x1's dtype."""
    with FakeTensorMode() as mode:
        params, wave, samples = _fake_op_inputs(mode)
        gn = params["group_norm"]
        x1 = torch.ops.ser_torch.conv_front(wave, samples, params["convs"][0]["kernel"], None,
                                            gn["scale"], gn["bias"], 5, 1e-5)
        x7 = torch.ops.ser_torch.conv_tail(x1, *ct._layer_tensors(params["convs"]),
                                           False, 1e-5)
    assert tuple(x1.shape) == (3, 799, C) and x1.dtype == torch.bfloat16 and x1.is_cuda
    assert tuple(x7.shape) == (3, ct.tail_lengths(799)[-1], C)
    assert x7.dtype == torch.bfloat16 and x7.is_cuda


class _Front(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.params = params

    def forward(self, wave, samples):
        return cf.conv_front(self.params["convs"][0], self.params["group_norm"], wave,
                             samples, 5)


class _Tail(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.params = params

    def forward(self, x1):
        return ct.conv_tail(self.params["convs"], x1, has_ln=False)


@pytest.mark.parametrize("op", ["conv_front", "conv_tail"])
def test_export_holds_one_node_per_op(op):
    """torch.export of a graph that calls each op traces one node for it
    (the kernel on the card), and the program computes the plain version."""
    params = _params(TAIL, dtype=torch.bfloat16)
    wave, mask = _wave(torch.bfloat16)
    samples = mask.to(torch.int32).sum(-1).to(torch.int64)
    if op == "conv_front":
        module, args = _Front(params), (wave, samples)
    else:
        x1 = cf.conv_front_plain(params["convs"][0], params["group_norm"], wave, samples,
                                 5).contiguous()
        module, args = _Tail(params), (x1,)
    with torch.no_grad():
        program = torch.export.export(module, args, strict=False)
        got = program.module()(*args)
        want = module(*args)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count(f"ser_torch.{op}.default") == 1, targets
    assert torch.equal(got, want)

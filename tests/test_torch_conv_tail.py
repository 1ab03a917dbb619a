"""The port's fused conv-extractor tail (ops/conv_tail.py) against the JAX
package's `conv_tail_pallas`, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs it, and the port's
`feature_encoder(allow_fused=True)` against the JAX one. f32 within 1e-5
(summation order only); bf16 within 4e-2, the JAX package's own bound for
the fused tail against the unfused loop (test_pallas_kernels.py:205)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.config import (
    Wav2Vec2Config as JaxWav2Vec2Config)
from multilingual_multimodal_speech_emotion_recognition_tpu.models import (
    wav2vec2 as jw)
from multilingual_multimodal_speech_emotion_recognition_tpu.ops import (
    pallas_kernels as pk)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
    Wav2Vec2Config)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    wav2vec2 as tw)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
    conv_tail as ct)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import profiling

from torch_port_helpers import assert_close, j, t

RNG = np.random.default_rng(23)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _tail_convs(C, *, has_ln, has_bias, K0=10, he=False):
    """A numpy conv stack in the JAX layout (kernels [K, C_in, C_out]): the
    JAX package's tests' 0.1 * N(0, 1) kernels, or with `he` the extractor's
    own N(0, 2 / fan_in), which keeps the activations of a deep stack O(1)."""
    convs = []
    for i, K in enumerate((K0, 3, 3, 3, 3, 2, 2)):
        cin = 1 if i == 0 else C
        std = np.sqrt(2.0 / (K * cin)) if he else 0.1
        conv = {"kernel": std * RNG.standard_normal((K, cin, C))}
        if has_bias:
            conv["bias"] = 0.1 * RNG.standard_normal(C)
        if has_ln:
            conv["ln"] = {"scale": 1.0 + 0.1 * RNG.standard_normal(C),
                          "bias": 0.1 * RNG.standard_normal(C)}
        convs.append(jax.tree.map(lambda a: a.astype(np.float32), conv))
    return convs


def _port_convs(convs, dtype):
    """The same stack in the port's layout (kernels [C_out, C_in, K])."""
    return [{k: (t(v.transpose(2, 1, 0), dtype) if k == "kernel"
                 else jax.tree.map(lambda a: t(a, dtype), v))
             for k, v in conv.items()} for conv in convs]


@pytest.mark.parametrize("dtype,has_ln,has_bias,B,T1,tol", [
    (torch.float32, False, False, 2, 2300, 1e-5),   # ragged last tile
    (torch.float32, True, True, 2, 1100, 1e-5),     # the large extractors' LN
    (torch.float32, False, True, 1, 1057, 1e-5),    # T1 past the padded length
    (torch.bfloat16, False, False, 2, 2300, 4e-2),  # the serving dtype
    (torch.bfloat16, True, True, 1, 1100, 4e-2),
], ids=["f32", "f32-ln-bias", "f32-t1-1057", "bf16", "bf16-ln-bias"])
def test_conv_tail_matches_pallas(dtype, has_ln, has_bias, B, T1, tol):
    C = 64
    convs = _tail_convs(C, has_ln=has_ln, has_bias=has_bias)
    x1 = RNG.standard_normal((B, T1, C)).astype(np.float32)
    jconvs = jax.tree.map(lambda a: j(a, JDT[dtype]), convs)
    want = pk.conv_tail_pallas(jconvs, j(x1, JDT[dtype]), has_ln=has_ln)
    before = profiling.counters()["conv_tail.launches"]
    got = ct.conv_tail(_port_convs(convs, dtype), t(x1, dtype), has_ln=has_ln)
    assert profiling.counters()["conv_tail.launches"] == before  # the CPU takes the plain version
    assert got.dtype == dtype
    assert tuple(got.shape) == want.shape == (B, ct.tail_lengths(T1)[-1], C)
    assert_close(got, want, tol)


@pytest.mark.parametrize("geometry", [
    ((10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2), (512,) * 7),
    ((10, 3), (10, 8), (8, 8)),
    ((10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2), (512,) * 6 + (256,)),
    ((10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2), (100,) * 7),
    ((10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 3), (512,) * 7),
])
def test_conv_tail_supported_matches_jax(geometry):
    assert ct.conv_tail_supported(*geometry) == pk.conv_tail_supported(*geometry)


def test_conv_tail_rejects_too_few_frames():
    with pytest.raises(ValueError, match="too few"):
        ct.conv_tail(_port_convs(_tail_convs(8, has_ln=False, has_bias=False),
                                 torch.float32),
                     torch.zeros(1, 60, 8), has_ln=False)


def test_feature_encoder_fused_path_matches_jax(monkeypatch):
    """The slice as a whole: the port's feature_encoder(allow_fused=True)
    goes through conv_tail and agrees with the JAX package's fused path
    (forced on in interpret mode) and with its own unfused loop; the frame
    masks are equal."""
    C = 128
    geometry = dict(conv_dim=(C,) * 7, conv_stride=(5, 2, 2, 2, 2, 2, 2),
                    conv_kernel=(10, 3, 3, 3, 3, 2, 2))
    jcfg = JaxWav2Vec2Config(**geometry)
    tcfg = Wav2Vec2Config(**geometry)
    convs = _tail_convs(C, has_ln=False, has_bias=False, he=True)
    gn = {"scale": 1.0 + 0.1 * RNG.standard_normal(C).astype(np.float32),
          "bias": 0.1 * RNG.standard_normal(C).astype(np.float32)}
    wave = RNG.standard_normal((3, 8000)).astype(np.float32)
    mask = np.ones((3, 8000), np.float32)
    mask[1, 4500:] = 0

    jparams = {"convs": jax.tree.map(lambda a: j(a, jnp.bfloat16), convs),
               "group_norm": jax.tree.map(j, gn)}
    monkeypatch.setattr(pk, "use_pallas", lambda: True)
    monkeypatch.setattr(pk, "_interpret", lambda: True)
    want, want_m = jw.feature_encoder(jparams, jcfg, j(wave, jnp.bfloat16), j(mask),
                                      allow_fused=True)

    tparams = {"convs": _port_convs(convs, torch.bfloat16),
               "group_norm": jax.tree.map(t, gn)}
    calls = []
    tail = ct.conv_tail
    monkeypatch.setattr(ct, "conv_tail", lambda *a, **k: calls.append(1) or tail(*a, **k))
    args = (tparams, tcfg, t(wave, torch.bfloat16), t(mask))
    got, got_m = tw.feature_encoder(*args, allow_fused=True)
    assert len(calls) == 1
    unfused, unfused_m = tw.feature_encoder(*args)
    assert len(calls) == 1
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got_m.float().numpy(),
                                  np.asarray(want_m.astype(jnp.float32)))
    assert torch.equal(got_m, unfused_m)
    assert_close(got, want, 4e-2)
    assert_close(got, jnp.asarray(unfused.float().numpy()), 4e-2)


def test_feature_encoder_fused_gate(monkeypatch):
    """allow_fused runs the unfused loop where the gate does not hold: f32
    input, or a stack without the tail's geometry."""
    calls = []
    monkeypatch.setattr(ct, "conv_tail", lambda *a, **k: calls.append(1))
    C = 128
    geometry = dict(conv_dim=(C,) * 7, conv_stride=(5, 2, 2, 2, 2, 2, 2),
                    conv_kernel=(10, 3, 3, 3, 3, 2, 2))
    convs = _port_convs(_tail_convs(C, has_ln=False, has_bias=False), torch.float32)
    params = {"convs": convs, "group_norm": {"scale": torch.ones(C),
                                             "bias": torch.zeros(C)}}
    wave, mask = torch.randn(2, 2000), torch.ones(2, 2000)
    x, _ = tw.feature_encoder(params, Wav2Vec2Config(**geometry), wave, mask,
                              allow_fused=True)
    small = Wav2Vec2Config(conv_dim=(8, 8), conv_stride=(10, 8), conv_kernel=(10, 3))
    small_params = {"convs": [{"kernel": torch.randn(8, 1, 10)},
                              {"kernel": torch.randn(8, 8, 3)}],
                    "group_norm": {"scale": torch.ones(8), "bias": torch.zeros(8)}}
    tw.feature_encoder(small_params, small, wave.bfloat16(), mask, allow_fused=True)
    assert calls == [] and x.shape[-1] == C


def test_conv_tail_routes_by_dtype():
    """bf16 goes to the TMA + wgmma GEMM with K-major weights, f32 to the
    CUDA-core GEMM with [K*C_in, C_out] weights; nothing else has a route."""
    assert ct.ROUTES == {torch.bfloat16: ("conv_tail_bf16", True),
                         torch.float32: ("conv_tail_f32", False)}


def test_packed_kernels_k_major_is_the_transpose():
    """The K-major packing ([C_out, K*C_in], column k*C_in + c) holds the
    same weights as the plain version's [K*C_in, C_out] matrix."""
    convs = _port_convs(_tail_convs(16, has_ln=False, has_bias=False), torch.float32)
    rows = ct._packed_kernels(convs, torch.bfloat16)
    k_major = ct._packed_kernels(convs, torch.bfloat16, k_major=True)
    for conv, K, r, km in zip(convs[1:], ct.TAIL_KERNELS, rows, k_major):
        assert tuple(km.shape) == (16, K * 16)
        assert torch.equal(km, r.t())
        kernel = conv["kernel"].to(torch.bfloat16)   # [C_out, C_in, K]
        assert torch.equal(km[5, 1 * 16 + 7], kernel[5, 7, 1])

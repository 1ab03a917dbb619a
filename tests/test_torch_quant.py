"""The port's int8 quantisation (ops/quant.py) against the JAX package's on
the CPU: the quantised weights, the int8 linear and the trees the two
quantisers touch (tests/test_torch_quant_serving.py holds the quantised
forward, its export and the interface).

Tolerances:
  * `quantize_linear`: kernel_q and w_scale bitwise equal (the same f32
    division and round-half-to-even);
  * `linear_int8`: f32 within 1e-6 relative; bf16 within one bf16 ulp of
    the output (the int32 product is exact, the dequantisation the same
    f32 products).
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import config as jcfg
from multilingual_multimodal_speech_emotion_recognition_tpu.models import (
    layers as jl, model as jm, whisper as jw)
from multilingual_multimodal_speech_emotion_recognition_tpu.ops import quant as jq
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
    config as tcfg, weights)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    layers as tl, model as tm)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import quant as tq
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
    leaves_with_paths)

from test_model import tiny_config
from test_torch_large_backbones import tiny_audio
from torch_port_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(31)
WHISPER = jw.WhisperConfig(vocab_size=320, num_mel_bins=80, d_model=32,
                           encoder_layers=2, encoder_attention_heads=4,
                           decoder_layers=2, decoder_attention_heads=4,
                           encoder_ffn_dim=64, decoder_ffn_dim=64,
                           max_target_positions=64, decoder_start_token_id=1,
                           eos_token_id=2)


def _numpy(tree):
    return jax.tree.map(np.array, tree)


@functools.lru_cache(maxsize=4)
def _jax_params(cfg, seed: int):
    """JAX init_model, jitted once per config (numpy leaves)."""
    return _numpy(jax.jit(jm.init_model, static_argnums=1)(jax.random.key(seed), cfg))


@functools.lru_cache(maxsize=4)
def _jax_quantised(cfg, seed: int):
    """JAX's quantize_backbones at min_size 16, eager as its callers run it
    (jitted, XLA may turn the division by the scale into a product with its
    reciprocal), on _jax_params(cfg, seed)."""
    return _numpy(jq.quantize_backbones(_jax_params(cfg, seed), min_size=16))

def _paths(tree):
    """Leaf paths of a JAX tree (numpy leaves) or a port tree, "/"-joined."""
    return {path for path, _ in leaves_with_paths(tree)}


def _assert_same_quantised_leaves(port_tree, jax_tree):
    """Equal leaf paths; kernel_q and w_scale bitwise equal."""
    assert _paths(port_tree) == _paths(jax_tree)
    want = dict(leaves_with_paths(jax_tree))
    n = 0
    for path, leaf in leaves_with_paths(port_tree):
        if path.endswith("kernel_q") or path.endswith("w_scale"):
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[path]), err_msg=path)
            n += 1
    assert n > 0


@pytest.mark.parametrize("shape", [(64, 96), (3, 64, 96)], ids=["flat", "stacked"])
def test_quantize_linear_matches_jax_bitwise(shape):
    w = RNG.standard_normal(shape).astype(np.float32)
    w[..., 5] = 0.0                     # a dead output channel: the 1e-12 scale floor
    w[..., 0, 7] = 3.0                  # exact .5 ties in the column it scales
    b = RNG.standard_normal(shape[:-2] + shape[-1:]).astype(np.float32)
    want = jq.quantize_linear({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)})
    got = tq.quantize_linear({"kernel": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    assert set(got) == set(want) == {"kernel_q", "w_scale", "bias"}
    assert got["kernel_q"].dtype == torch.int8 and got["w_scale"].dtype == torch.float32
    assert tuple(got["kernel_q"].shape) == shape
    assert got["kernel_q"].stride()[-2] == 1          # column-major, the card's layout
    for k in ("kernel_q", "w_scale", "bias"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_int8_matches_jax(dtype):
    p = jl.init_linear(jax.random.key(0), 256, 512)
    x = RNG.standard_normal((4, 10, 256)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    want = np.asarray(jl.linear(jq.quantize_linear(p), jnp.asarray(x).astype(jdt))
                      .astype(jnp.float32))
    tp = tq.quantize_linear({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    got = tl.linear(tp, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (4, 10, 512)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("rows", [1, 5, 16, 17, 40])
def test_padded_rows_route_equals_the_plain_product(rows):
    """The card's route pads fewer than 17 rows with zeros for
    torch._int_mm and slices them off: the same exact int32 product (run
    here through torch._int_mm on the CPU); the wrapper takes the plain
    product for CPU tensors."""
    xq = torch.from_numpy(RNG.integers(-127, 128, (rows, 64)).astype(np.int8))
    kq = tq.card_layout(torch.from_numpy(RNG.integers(-127, 128, (64, 24)).astype(np.int8)))
    want = xq.numpy().astype(np.int64) @ kq.numpy().astype(np.int64)
    plain = tq.int8_matmul_plain(xq, kq)
    padded = tq._int_mm_padded(xq, kq)
    assert plain.dtype == padded.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(padded.numpy(), want)
    launches = tq.int8_matmul.launches
    np.testing.assert_array_equal(tq.int8_matmul(xq, kq).numpy(), want)
    assert tq.int8_matmul.launches == launches


@pytest.mark.parametrize("backbone", ["wav2vec2-base", "wavlm-large"])
def test_quantize_backbones_matches_jax(backbone):
    """The same leaves quantised at min_size 16 (tiny widths), bitwise;
    WavLM's gate [L, Dh, 8] stays float."""
    cfg = tiny_config()
    if backbone != "wav2vec2-base":
        cfg = dataclasses.replace(cfg, audio=tiny_audio(backbone)[0])
    params = _jax_params(cfg, 0)
    port = weights.params_from_jax(params, tcfg.from_json(jcfg.to_json(cfg)), device="cpu")
    want = _jax_quantised(cfg, 0)
    got = tq.quantize_backbones(port, min_size=16)
    _assert_same_quantised_leaves(got, want)
    assert "kernel_q" in got["audio_backbone"]["layers"]["q"]
    assert "kernel_q" in got["text_backbone"]["layers"]["ffn_in"]
    assert "kernel" in got["classifier"]["input_proj"]
    if backbone == "wavlm-large":
        assert "kernel" in got["audio_backbone"]["layers"]["gru_lin"]
    # at the default min_size nothing of these widths is quantised
    assert _paths(tq.quantize_backbones(port)) == _paths(port)


def test_quantize_whisper_matches_jax():
    params = _numpy(jw.init_whisper(jax.random.key(2), WHISPER))
    port = weights.whisper_params_from_jax(params, WHISPER, device="cpu")
    want = _numpy(jq.quantize_whisper(params, min_size=16))
    got = tq.quantize_whisper(port, min_size=16)
    _assert_same_quantised_leaves(got, want)
    assert "kernel_q" in got["decoder"]["layers"]["cross_attn"]["k"]
    assert "kernel" in got["encoder"]["conv1"]
    assert got["decoder"]["embed_tokens"].dtype == torch.float32


def test_cast_floating_keeps_w_scale_f32():
    qp = {"lin": tq.quantize_linear({"kernel": torch.randn(64, 64), "bias": torch.randn(64)})}
    cast = tm.cast_floating(qp, torch.bfloat16)
    assert cast["lin"]["w_scale"].dtype == torch.float32
    assert cast["lin"]["kernel_q"].dtype == torch.int8
    assert cast["lin"]["kernel_q"].stride() == qp["lin"]["kernel_q"].stride()
    assert cast["lin"]["bias"].dtype == torch.bfloat16
    want = jm.cast_floating(jq.quantize_linear(jl.init_linear(jax.random.key(0), 64, 64)),
                            jnp.bfloat16)
    assert {k: str(v.dtype) for k, v in want.items()} == {
        "kernel_q": "int8", "w_scale": "float32", "bias": "bfloat16"}

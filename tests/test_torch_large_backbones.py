"""The port's large audio backbones (wav2vec2-large, HuBERT-Large,
WavLM-Large) against the JAX package on the CPU, at the presets' flags cut
to tiny widths: hidden 32, 2 layers, 4 heads, 3 convs of 16 channels
(WavLM's 320 buckets / distance 800 cut to 16 / 40, so that the test's 79
frames reach the log-spaced and the clamped buckets).

Tolerances: f32 within 1e-4 (summation order only). bf16 within 6e-2 for
the encoder, as tests/test_torch_encoders.py holds the base encoder (a few
bf16 ulps at the normalised outputs: the frameworks round bf16 at other
places), and within 3e-2 for the model's outputs, as
tests/test_torch_model.py does. The bucket function is held exactly."""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import config as jcfg
import multilingual_multimodal_speech_emotion_recognition_tpu.models.model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu.models import wav2vec2 as jw
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
    config as tcfg, export as tex, weights)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    model as tm, wav2vec2 as tw)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import conv_tail

from test_model import tiny_batch, tiny_config
from torch_port_helpers import META, assert_close, bridge, j, perturb, t
from torch_port_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(23)
PRESETS = ("wav2vec2-large", "hubert-large", "wavlm-large")
LARGE = ("wav2vec2-large", "wavlm-large")   # hubert-large is wav2vec2-large's config
ENCODER_DTYPES = [(jnp.float32, torch.float32, 1e-4), (jnp.bfloat16, torch.bfloat16, 6e-2)]
MODEL_DTYPES = [("float32", 1e-4), ("bfloat16", 3e-2)]
TINY = dict(conv_dim=(16, 16, 16), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 3),
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, apply_spec_augment=False)


def tiny_audio(preset: str, **kw):
    """(JAX, port) Wav2Vec2Config: the preset's flags at tiny widths."""
    cfg = jcfg.AUDIO_BACKBONE_PRESETS[preset]()
    extra = dict(num_buckets=16, max_bucket_distance=40) if cfg.gated_relpos_bias else {}
    cfg = dataclasses.replace(cfg, **{**TINY, **extra, **kw})
    return cfg, tcfg.Wav2Vec2Config(**dataclasses.asdict(cfg))


def _audio(B=3, T=1600):
    wave = RNG.standard_normal((B, T)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 1100:] = 0
    mask[2, 700:] = 0
    return wave * mask, mask


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def test_presets_match_jax():
    """The JAX package's presets, field for field as both write them; the
    port adds w2v-BERT 2.0 (tests/test_torch_w2v_bert.py), which JAX lacks."""
    assert set(tcfg.AUDIO_BACKBONE_PRESETS) == set(jcfg.AUDIO_BACKBONE_PRESETS) | {"w2v-bert-2.0"}
    for name, make in jcfg.AUDIO_BACKBONE_PRESETS.items():
        assert json.loads(tcfg.to_json(tcfg.AUDIO_BACKBONE_PRESETS[name]())) == json.loads(
            jcfg.to_json(make())), name
        assert tcfg.Wav2Vec2Config(**dataclasses.asdict(make())) == tcfg.AUDIO_BACKBONE_PRESETS[
            name](), name
    assert tcfg.hubert_large_audio_config() == tcfg.wav2vec2_large_audio_config()


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("jdt,tdt,tol", ENCODER_DTYPES, ids=["f32", "bf16"])
def test_wav2vec2_encode_matches_jax(preset, jdt, tdt, tol):
    jc, tc = tiny_audio(preset)
    jp = perturb(jw.init_wav2vec2(jax.random.key(3), jc), RNG, 0.05)
    tp = bridge(jp, tw.init_wav2vec2(META, tc))
    assert ("bias" in tp["convs"][1]) == tc.conv_bias
    assert "ln" in tp["convs"][0] and "group_norm" not in tp
    assert ("rel_attn_embed" in tp) == tc.gated_relpos_bias
    wave, mask = _audio()
    want_h, want_m = jax.jit(lambda p, w, m: jw.wav2vec2_encode(p, jc, w, m))(
        jax.tree.map(lambda a: j(a, jdt), jp), j(wave, jdt), j(mask))
    got_h, got_m = tw.wav2vec2_encode(jax.tree.map(lambda v: v.to(tdt), tp), tc,
                                      t(wave, tdt), t(mask))
    assert got_h.dtype == tdt and got_h.shape == want_h.shape
    assert_close(got_m, want_m, 0)
    assert_close(got_h, want_h, tol)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("dtype,tol", MODEL_DTYPES, ids=["f32", "bf16"])
def test_model_forward_matches_jax(preset, dtype, tol):
    jc, _ = tiny_audio(preset)
    cfg = dataclasses.replace(tiny_config(compute_dtype=dtype), audio=jc)
    params = jm.init_model(jax.random.key(4), cfg)
    params["audio_backbone"] = perturb(params["audio_backbone"], RNG, 0.05)
    batch = tiny_batch(T=1600)
    want = jax.jit(lambda p, b: jm.model_forward(p, cfg, b))(params, batch)
    port_cfg = tcfg.from_json(jcfg.to_json(cfg))
    assert port_cfg.audio == tcfg.Wav2Vec2Config(**dataclasses.asdict(jc))
    got = tm.model_forward(weights.params_from_jax(_numpy(params), port_cfg, device="cpu"),
                           port_cfg, _numpy(batch))
    for field, g, w in zip(want._fields, got, want):
        assert g.shape == w.shape, field
        assert_close(g, w, tol)


@pytest.mark.parametrize("num_buckets,max_distance", [(320, 800), (16, 40), (32, 128)])
def test_relative_position_bucket_is_exact(num_buckets, max_distance):
    """Every relative position of T = 1000 frames, past max_distance."""
    rel = np.arange(-999, 1000)
    want = np.asarray(jw._relative_positions_bucket(jnp.asarray(rel), num_buckets,
                                                    max_distance))
    got = tw._relative_positions_bucket(torch.from_numpy(rel), num_buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() == num_buckets - 1 and want.min() == 0


@pytest.mark.parametrize("T", [1, 79, 1000])
def test_relative_position_bias_matches_jax(T):
    jc = jcfg.wavlm_large_audio_config()
    tc = tcfg.wavlm_large_audio_config()
    embed = RNG.standard_normal((jc.num_buckets, jc.num_attention_heads)).astype(np.float32)
    want = jw.relative_position_bias({"rel_attn_embed": j(embed)}, jc, T)
    got = tw.relative_position_bias({"rel_attn_embed": t(embed)}, tc, T)
    assert got.dtype == torch.float32 and got.shape == (jc.num_attention_heads, T, T)
    assert_close(got, want, 0)


@pytest.mark.parametrize("preset", LARGE)
def test_fused_feature_encoder_takes_the_plain_tail_on_cpu(preset, monkeypatch):
    """bf16 at the tail's geometry (7 convs of 128 channels): on CPU
    tensors allow_fused=True runs conv_tail's plain version with the
    per-layer LN, and equals the unfused layer-norm extractor."""
    jc, tc = tiny_audio(preset, conv_dim=(128,) * 7, conv_stride=(5,) + (2,) * 6,
                        conv_kernel=(10, 3, 3, 3, 3, 2, 2))
    assert conv_tail.conv_tail_supported(tc.conv_kernel, tc.conv_stride, tc.conv_dim)
    tp = bridge(perturb(jw.init_wav2vec2(jax.random.key(5), jc), RNG, 0.05),
                tw.init_wav2vec2(META, tc))
    tp = jax.tree.map(lambda v: v.to(torch.bfloat16), tp)
    calls = []
    plain = conv_tail.conv_tail_plain

    def spy(convs, x1, *, has_ln, ln_eps=1e-5):
        calls.append(has_ln)
        return plain(convs, x1, has_ln=has_ln, ln_eps=ln_eps)

    monkeypatch.setattr(conv_tail, "conv_tail_plain", spy)
    wave, mask = _audio(T=4000)
    wave = tw.normalize_waveform(t(wave), t(mask)).to(torch.bfloat16)
    fused, fused_m = tw.feature_encoder(tp, tc, wave, t(mask), allow_fused=True)
    assert calls == [True]
    unfused, unfused_m = tw.feature_encoder(tp, tc, wave, t(mask))
    assert calls == [True]
    assert fused.dtype == torch.bfloat16 and fused.shape == unfused.shape
    assert torch.equal(fused_m, unfused_m)
    assert_close(fused, unfused.float().numpy(), 4e-2)


def test_bridge_carries_the_large_leaves():
    """The strict bridge fills conv LNs and biases and WavLM's gate and
    bias table, and refuses a tree that lacks one."""
    jc, _ = tiny_audio("wavlm-large", conv_bias=True)
    cfg = dataclasses.replace(tiny_config(), audio=jc)
    port_cfg = tcfg.from_json(jcfg.to_json(cfg))
    tree = _numpy(jm.init_model(jax.random.key(6), cfg))
    params = weights.params_from_jax(tree, port_cfg, device="cpu")
    backbone = params["audio_backbone"]
    for conv, jconv in zip(backbone["convs"], tree["audio_backbone"]["convs"]):
        np.testing.assert_array_equal(conv["ln"]["scale"].numpy(), jconv["ln"]["scale"])
        np.testing.assert_array_equal(conv["bias"].numpy(), jconv["bias"])
    for leaf in ("gru_const",):
        np.testing.assert_array_equal(backbone["layers"][leaf].numpy(),
                                      tree["audio_backbone"]["layers"][leaf])
    np.testing.assert_array_equal(backbone["layers"]["gru_lin"]["kernel"].numpy(),
                                  tree["audio_backbone"]["layers"]["gru_lin"]["kernel"])
    np.testing.assert_array_equal(backbone["rel_attn_embed"].numpy(),
                                  tree["audio_backbone"]["rel_attn_embed"])
    del tree["audio_backbone"]["layers"]["gru_const"]
    with pytest.raises(KeyError, match="audio_backbone/layers/gru_const"):
        weights.params_from_jax(tree, port_cfg, device="cpu")


def test_exported_wavlm_large_matches_eager(tmp_path):
    """torch.export traces the stable pre-LN layers, the layer-norm convs and
    WavLM's gated bias (its bucket table made in the trace); the served
    program equals the eager forward."""
    jc, _ = tiny_audio("wavlm-large")
    cfg = tcfg.from_json(jcfg.to_json(dataclasses.replace(tiny_config(), audio=jc)))
    params = tm.init_model(cfg, torch.Generator().manual_seed(7), device="cpu")
    art = tex.export_forward(params, cfg, tmp_path / "art", batch_size=2, audio_seconds=0.1,
                             text_tokens=8, with_dsp=False, device="cpu")
    batch = {k: v[:2, :8] if k.startswith("text") else v[:2]
             for k, v in tiny_batch(T=1600).items()}
    got = tex.ServingModel(art, device="cpu").predict(batch)
    want = tm.model_forward(params, cfg, batch, use_openmax=True)
    for name, w in (("logits", want.logits), ("uncertainty", want.uncertainty),
                    ("features", want.features)):
        np.testing.assert_allclose(got[name], w.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)

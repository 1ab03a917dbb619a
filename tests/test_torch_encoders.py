"""The port's wav2vec2 (base preset) and XLM-R encoders against the JAX
package (CPU, tiny widths). f32 within 1e-4 (two layers of attention and
FFN, summation order only). bf16 within 6e-2, about four bf16 ulps at the
post-LN outputs' magnitude of 2: the frameworks round bf16 at other
places, and one flipped rounding inside a layer passes through the LNs of
every later layer."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import config as jcfg
from multilingual_multimodal_speech_emotion_recognition_tpu.models import (
    wav2vec2 as jw, xlmr as jx)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    wav2vec2 as tw, xlmr as tx)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import conv_front as tcf

from test_model import tiny_config
from torch_port_helpers import META, assert_close, bridge, j, perturb, t

RNG = np.random.default_rng(19)
F32_TOL = 1e-4
BF16_TOL = 6e-2
DTYPES = [(jnp.float32, torch.float32, F32_TOL),
          (jnp.bfloat16, torch.bfloat16, BF16_TOL)]


def _configs():
    jc = tiny_config()
    return jc, tcfg.from_json(jcfg.to_json(jc))


def _audio(B=3, T=800):
    wave = RNG.standard_normal((B, T)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 530:] = 0
    wave[1, 530:] = 0
    return wave, mask


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_wav2vec2_encode_with_masked_row(jdt, tdt, tol):
    jc, tc = _configs()
    jp = perturb(jw.init_wav2vec2(jax.random.key(0), jc.audio), RNG, 0.02)
    tp = bridge(jp, tw.init_wav2vec2(META, tc.audio))
    wave, mask = _audio()
    cast = lambda a: j(a, jdt)
    want_h, want_m = jax.jit(lambda p, w, m: jw.wav2vec2_encode(p, jc.audio, w, m))(
        jax.tree.map(cast, jp), j(wave, jdt), j(mask))
    got_h, got_m = tw.wav2vec2_encode(
        jax.tree.map(lambda v: v.to(tdt), tp), tc.audio, t(wave, tdt), t(mask))
    assert got_h.dtype == tdt and got_m.dtype == tdt
    np.testing.assert_array_equal(got_m.float().numpy(),
                                  np.asarray(want_m.astype(jnp.float32)))
    assert_close(got_h, want_h, tol)


def test_wav2vec2_pieces():
    jc, tc = _configs()
    jp = perturb(jw.init_wav2vec2(jax.random.key(1), jc.audio), RNG, 0.02)
    tp = bridge(jp, tw.init_wav2vec2(META, tc.audio))
    wave, mask = _audio()
    jn = jw.normalize_waveform(j(wave), j(mask))
    tn = tw.normalize_waveform(t(wave), t(mask))
    assert_close(tn, jn, 1e-5)
    jf, jm = jw.feature_encoder(jp, jc.audio, jn, j(mask))
    tf, tm = tw.feature_encoder(tp, tc.audio, tn, t(mask))
    assert_close(tf, jf, 1e-5)
    assert_close(tm, jm, 0)
    lengths = tc.audio.feat_extract_output_lengths(t(mask).sum(-1).long())
    assert lengths.tolist() == tm.sum(-1).long().tolist()
    x = RNG.standard_normal((2, 9, 8)).astype(np.float32)
    fm = np.ones((2, 9), np.float32)
    fm[0, 5:] = 0
    assert_close(tcf.masked_group_norm_per_channel(tp["group_norm"], t(x).transpose(1, 2),
                                                   t(fm)).transpose(1, 2),
                 jw.masked_group_norm_per_channel(jax.tree.map(j, jp["group_norm"]),
                                                  j(x), j(fm)), 1e-5)


def test_wav2vec2_unported_paths_raise():
    """Only an extractor norm the JAX package lacks too is refused; the
    large presets' layer-norm stack runs (tests/test_torch_large_backbones.py)."""
    jc, tc = _configs()
    tp = tw.init_wav2vec2(tw.layers.Init(None, "cpu"), tc.audio)
    wave, mask = _audio()
    unknown = dataclasses.replace(tc.audio, feat_extract_norm="instance")
    with pytest.raises(NotImplementedError, match="feat_extract_norm='instance'"):
        tw.wav2vec2_encode(tp, unknown, t(wave), t(mask))
    with pytest.raises(NotImplementedError, match="feat_extract_norm='instance'"):
        tw.init_wav2vec2(tw.layers.Init(None, "meta"), unknown)


def test_position_ids_from_input_ids():
    ids = np.array([[0, 5, 7, 1, 1], [3, 1, 4, 1, 9]], np.int32)
    np.testing.assert_array_equal(
        tx.position_ids_from_input_ids(t(ids), 1).numpy(),
        np.asarray(jx.position_ids_from_input_ids(j(ids), 1)))


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_xlmr_encode_with_padding(jdt, tdt, tol):
    jc, tc = _configs()
    jp = perturb(jx.init_xlmr(jax.random.key(2), jc.text), RNG, 0.02)
    tp = bridge(jp, tx.init_xlmr(META, tc.text))
    ids = RNG.integers(2, 100, (3, 8)).astype(np.int32)
    mask = np.ones((3, 8), np.float32)
    ids[1, 5:] = 1
    mask[1, 5:] = 0
    want = jax.jit(lambda p, i, m: jx.xlmr_encode(p, jc.text, i, m))(
        jax.tree.map(lambda a: j(a, jdt), jp), j(ids), j(mask))
    got = tx.xlmr_encode(jax.tree.map(lambda v: v.to(tdt), tp), tc.text,
                         t(ids), t(mask))
    assert got.dtype == tdt
    assert_close(got, want, tol)

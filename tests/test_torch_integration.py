"""The port's staged pipeline and streaming recognizer (integration.py) and
the research modules they use (research/temporal.py,
research/dual_gate_ood.py) against the JAX package's on the CPU, on bridged
parameters of one tiny model with the front-end DSP on.

Tolerance: f32 within 1e-4 (summation order only); functions of the
research modules within 1e-5 on their own small inputs."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import (
    config as jcfg, integration as jinteg)
from multilingual_multimodal_speech_emotion_recognition_tpu.data import tokenizer as jtok
from multilingual_multimodal_speech_emotion_recognition_tpu.models import model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu.research import (
    dual_gate_ood as jdg, temporal as jtm)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
    config as tcfg, integration as tinteg, weights)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
    tokenizer as ttok)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import layers as tl
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.research import (
    dual_gate_ood as tdg, temporal as ttm)

from test_model import tiny_config
from torch_port_helpers import assert_close, bridge, perturb, t

SR = 16000
TOL = 1e-4
FN_TOL = 1e-5
RNG = np.random.default_rng(5)
META = tl.Init(None, "meta")


@pytest.fixture(scope="module")
def model():
    jc = jcfg.Config(model=tiny_config(frontend_dsp=True),
                     data=jcfg.DataConfig(max_text_tokens=12, max_audio_seconds=1.0))
    params = jax.tree.map(np.asarray, jm.init_model(jax.random.key(0), jc.model))
    params["classifier"] = perturb(params["classifier"], np.random.default_rng(1), 0.5)
    tc = tcfg.config_from_json(jcfg.to_json(jc))
    return jc, params, tc, weights.params_from_jax(params, tc.model, device="cpu")


def clip(n, seed):
    """A hum over a tone and a little noise: the notch and HPF fire."""
    tt = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 50 * tt) + 0.3 * np.sin(2 * np.pi * (200 + 40 * seed) * tt)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("n,seconds,overlap", [(10 * SR, 4.0, 0.5), (SR, 4.0, 0.5),
                                               (37_000, 1.0, 0.25), (48_000, 1.0, 0.0)])
def test_segment_waveform_matches_jax(n, seconds, overlap):
    x = RNG.standard_normal(n).astype(np.float32)
    got = tinteg.segment_waveform(x, SR, segment_seconds=seconds, overlap=overlap)
    want = jinteg.segment_waveform(x, SR, segment_seconds=seconds, overlap=overlap)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_process_audio_segment_matches_jax(model):
    jc, params, tc, port_params = model
    pipe = tinteg.DataFlowPipeline(port_params, tc, tokenizer=ttok.HashTokenizer(100))
    jpipe = jinteg.DataFlowPipeline(params, jc, tokenizer=jtok.HashTokenizer(100))
    for n, text in ((SR, "the cat sat on the mat"), (12_000, "")):
        audio = clip(n, seed=n % 7)
        got, want = pipe.process_audio_segment(audio, text), jpipe.process_audio_segment(audio,
                                                                                        text)
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["probabilities"], want["probabilities"], rtol=TOL,
                                   atol=TOL)
        for key in ("uncertainty", "energy_score"):
            assert got[key] == pytest.approx(want[key], abs=TOL), key
        assert got["prediction"] == want["prediction"]
        assert got["language"] == want["language"]
        assert ([m.stage_name for m in got["stage_metrics"]]
                == [m.stage_name for m in want["stage_metrics"]])
        assert got["total_time"] == pytest.approx(sum(m.processing_time
                                                      for m in got["stage_metrics"]))
        for g, w in zip(got["stage_metrics"], want["stage_metrics"]):
            assert g.metadata == w.metadata


def test_process_long_audio_matches_jax(model):
    jc, params, tc, port_params = model
    audio = clip(40_000, seed=3)
    got = tinteg.DataFlowPipeline(port_params, tc, tokenizer=ttok.HashTokenizer(100)
                                  ).process_long_audio(audio, "hello", segment_seconds=1.0)
    want = jinteg.DataFlowPipeline(params, jc, tokenizer=jtok.HashTokenizer(100)
                                   ).process_long_audio(audio, "hello", segment_seconds=1.0)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["logits"], w["logits"], rtol=TOL, atol=TOL)


def test_streaming_recognizer_matches_jax(model):
    """The same chunks into both recognizers, with JAX's temporal
    parameters bridged: smoothed logits, confidences and the speaker-change
    flags agree segment by segment, the tail included."""
    jc, params, tc, port_params = model
    dim = jc.model.classifier_base_dim // 2
    jtemporal = perturb(jtm.init_temporal_module(jax.random.key(4), feature_dim=dim,
                                                 num_emotions=4), np.random.default_rng(6))
    template = ttm.init_temporal_module(dim, 4, device="meta")
    kw = dict(segment_seconds=0.5, tokenizer=None)
    rec = tinteg.StreamingRecognizer(port_params, tc, temporal_params=bridge(jtemporal, template),
                                     **{**kw, "tokenizer": ttok.HashTokenizer(100)})
    jrec = jinteg.StreamingRecognizer(params, jc, temporal_params=jtemporal,
                                      **{**kw, "tokenizer": jtok.HashTokenizer(100)})
    # two "speakers": a 50 Hz hum clip, then another tone
    stream = np.concatenate([clip(16_000, seed=1), clip(14_000, seed=6)])
    got, want = [], []
    for start in range(0, stream.size, 3_000):
        chunk = stream[start:start + 3_000]
        got += rec.push_audio(chunk, "hello there")
        want += jrec.push_audio(chunk, "hello there")
    got.append(rec.flush("hello there"))
    want.append(jrec.flush("hello there"))
    assert len(got) == len(want) == 4 and got[-1]["segment_index"] == 3
    for g, w in zip(got, want):
        for key in ("raw_logits", "smoothed_logits", "probabilities"):
            np.testing.assert_allclose(g[key], w[key], rtol=TOL, atol=TOL, err_msg=key)
        for key in ("confidence", "uncertainty", "speaker_similarity"):
            assert g[key] == pytest.approx(w[key], abs=TOL), key
        assert g["speaker_changed"] is w["speaker_changed"]
        assert (g["prediction"], g["language"], g["segment_index"]) == (
            w["prediction"], w["language"], w["segment_index"])
    rec.reset()
    assert rec.segment_index == 0 and rec.push_audio(stream[:100]) == []
    assert rec.flush() is not None and rec.flush() is None


def test_verify_integration_matches_jax(model):
    jc, params, tc, port_params = model
    got = tinteg.verify_integration(port_params, tc)
    assert got == jinteg.verify_integration(params, jc)
    assert got["all_passed"] and got["dual_gate_ood_available"]
    broken = {k: v for k, v in port_params.items() if k != "prototypes"}
    jbroken = {k: v for k, v in params.items() if k != "prototypes"}
    got = tinteg.verify_integration(broken, tc)
    assert got == jinteg.verify_integration(jbroken, jc)
    assert not got["prototypes"] and not got["all_passed"]


# ------------------------------------------------------------- temporal

@pytest.fixture(scope="module")
def temporal_params():
    jp = perturb(jtm.init_temporal_module(jax.random.key(0), feature_dim=16, num_emotions=4),
                 np.random.default_rng(2))
    return jp, bridge(jp, ttm.init_temporal_module(16, 4, device="meta"))


def init_bound(path, leaf, tree):
    """The bound of a leaf's init distribution in both frameworks: conv
    weights the JAX module's xavier bound, linear kernels torch's default,
    linear biases 1/sqrt(fan_in); None for the constant leaves."""
    *parents, name = path
    node = tree
    for k in parents:
        node = node[k]
    if name == "w":
        return tl.xavier_bound(leaf.shape[0], leaf.shape[2])
    if name == "kernel":
        return tl.kaiming_bound(leaf.shape[0])
    if name == "bias" and "kernel" in node:
        return 1.0 / np.sqrt(node["kernel"].shape[0])
    return None


def test_positional_encoding_and_init_match_jax():
    np.testing.assert_array_equal(ttm.positional_encoding(10, 16), jtm.positional_encoding(10, 16))
    jp = jax.tree.map(np.asarray, jtm.init_temporal_module(jax.random.key(0), 16, 4))
    tp = ttm.init_temporal_module(16, 4, generator=torch.Generator().manual_seed(0),
                                  device="cpu")
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    tflat = dict(jax.tree_util.tree_flatten_with_path(tp, is_leaf=torch.is_tensor)[0])
    assert jflat.keys() == tflat.keys()
    for key, want in jflat.items():
        got = tflat[key].numpy()
        path = [k.key for k in key]
        assert got.shape == want.shape and got.dtype == want.dtype, path
        bound = init_bound(path, got, tp)
        if bound is None:       # LN scales / biases, conv biases, the PE table
            np.testing.assert_array_equal(got, want, err_msg=str(path))
        else:
            assert np.abs(got).max() <= bound and np.abs(want).max() <= bound, path
            assert got.size < 16 or np.abs(got).max() > 0.5 * bound, path


@pytest.mark.parametrize("dilation", [1, 2])
def test_causal_conv_matches_jax(temporal_params, dilation):
    jp, tp = temporal_params
    x = RNG.standard_normal((2, 3, 16)).astype(np.float32)
    want = jtm.causal_conv(jp["tcn"]["layer1"], jnp.asarray(x), dilation=dilation)
    got = ttm.causal_conv(tp["tcn"]["layer1"], t(x), dilation=dilation)
    assert_close(got, want, FN_TOL)


def test_tcn_matches_jax(temporal_params):
    jp, tp = temporal_params
    x = RNG.standard_normal((2, 3, 16)).astype(np.float32)
    assert_close(ttm.tcn(tp["tcn"], t(x)), jtm.tcn(jp["tcn"], jnp.asarray(x)), FN_TOL)


def test_confidence_smoothing_and_speaker_change_match_jax(temporal_params):
    jp, tp = temporal_params
    cur = RNG.standard_normal((4, 4)).astype(np.float32)
    hist = RNG.standard_normal((4, 4)).astype(np.float32)
    cc = np.array([[0.95], [0.5], [1.2], [-0.1]], np.float32)
    hc = np.array([[0.2], [0.6], [0.1], [0.0]], np.float32)
    for g, w in zip(ttm.confidence_smoothing(t(cur), t(cc), t(hist), t(hc)),
                    jtm.confidence_smoothing(*map(jnp.asarray, (cur, cc, hist, hc)))):
        assert_close(g, w, FN_TOL)
    a = RNG.standard_normal((4, 16)).astype(np.float32)
    b = np.stack([a[0], -a[1], a[2] + 0.01, RNG.standard_normal(16).astype(np.float32)])
    changed, sim = ttm.speaker_change(tp["speaker"], t(a), t(b))
    jchanged, jsim = jtm.speaker_change(jp["speaker"], jnp.asarray(a), jnp.asarray(b))
    assert_close(sim, jsim, FN_TOL)
    np.testing.assert_array_equal(changed.numpy(), np.asarray(jchanged))


def test_temporal_steps_match_jax(temporal_params):
    """Five steps through the buffer (it fills at 3, then rolls)."""
    jp, tp = temporal_params
    state, jstate = ttm.init_buffer(2, 16, device="cpu"), jtm.init_buffer(2, 16)
    for step in range(5):
        feat = RNG.standard_normal((2, 16)).astype(np.float32)
        conf = RNG.random((2, 1)).astype(np.float32)
        state, smoothed, final, info = ttm.temporal_step(tp, state, t(feat), t(conf))
        jstate, jsmoothed, jfinal, jinfo = jtm.temporal_step(jp, jstate, jnp.asarray(feat),
                                                             jnp.asarray(conf))
        assert_close(smoothed, jsmoothed, FN_TOL)
        assert_close(final, jfinal, FN_TOL)
        for k in ("speaker_similarity", "current_confidence", "historical_confidence"):
            assert_close(info[k], jinfo[k], FN_TOL)
        np.testing.assert_array_equal(info["speaker_changed"].numpy(),
                                      np.asarray(jinfo["speaker_changed"]))
        for g, w in zip(state, jstate):
            assert_close(g, w, 0.0)
        np.testing.assert_array_equal(ttm.buffer_valid_mask(state).numpy(),
                                      np.asarray(jtm.buffer_valid_mask(jstate)))


# ------------------------------------------------------------- dual gate

def quality(B=5):
    return {"snr_db": np.array([20.0, 3.0, 20.0, 12.0, 25.0], np.float32)[:B],
            "clipping_percent": np.array([0.0, 0.0, 50.0, 0.0, 0.0], np.float32)[:B],
            "speech_prob": np.array([0.9, 0.9, 0.9, 0.3, 0.95], np.float32)[:B],
            "music_prob": np.array([0.0, 0.9, 0.0, 0.0, 0.7], np.float32)[:B]}


def both(q):
    return ({k: t(v) for k, v in q.items()}, {k: jnp.asarray(v) for k, v in q.items()})


def test_early_ood_matches_jax():
    tq, jq = both(quality())
    got, want = tdg.early_ood(tq), jdg.early_ood(jq)
    np.testing.assert_array_equal(got.is_ood.numpy(), np.asarray(want.is_ood))
    np.testing.assert_array_equal(got.reason.numpy(), np.asarray(want.reason))
    assert_close(got.confidence_score, want.confidence_score, FN_TOL)


def test_energy_scores_and_temperature_match_jax():
    logits = (3 * RNG.standard_normal((100, 4))).astype(np.float32)
    assert_close(tdg.energy_scores(t(logits), 2.0), jdg.energy_scores(jnp.asarray(logits), 2.0),
                 FN_TOL)
    assert tdg.calibrate_energy_temperature(t(logits)) == pytest.approx(
        jdg.calibrate_energy_temperature(jnp.asarray(logits)), abs=1e-6)


@pytest.fixture(scope="module")
def late_params():
    jp = perturb(jdg.init_late_detector(jax.random.key(0), num_classes=4, feature_dim=8),
                 np.random.default_rng(3))
    return jp, bridge(jp, tdg.init_late_detector(META, 4, 8))


def test_prototypes_match_jax(late_params):
    jp, tp = late_params
    feats = np.r_[RNG.normal(0, 0.1, (20, 8)), RNG.normal(5, 0.1, (20, 8))].astype(np.float32)
    labels = np.array([0] * 20 + [1] * 20, np.int32)
    got = tdg.update_prototypes(tp["prototype"], t(feats), t(labels), 4)
    want = jdg.update_prototypes(jp["prototype"], jnp.asarray(feats), jnp.asarray(labels), 4)
    # the variance is E[x^2] - mean^2: at mean 5 the f32 rounding of E[x^2]
    # (~25) is ~2e-6 before the difference, so the summation order shows
    # at the f32 tolerance, not the functions' one
    assert_close(got["prototypes"], want["prototypes"], FN_TOL)
    assert_close(got["covariances"], want["covariances"], TOL)
    for g, w in zip(tdg.prototype_distances(got, t(feats[:3])),
                    jdg.prototype_distances(want, jnp.asarray(feats[:3]))):
        assert_close(g, w, FN_TOL)


def test_late_and_dual_gate_match_jax(late_params):
    jp, tp = late_params
    thr = jdg.init_threshold_manager()
    thr = {"thresholds": np.asarray(thr["thresholds"]).copy(), "global_threshold":
           np.asarray(thr["global_threshold"])}
    thr["thresholds"][0, 0] = 0.05       # extreme: the global threshold
    thr["thresholds"][1, 1] = 0.7
    logits = (2 * RNG.standard_normal((5, 4))).astype(np.float32)
    feats = RNG.standard_normal((5, 8)).astype(np.float32)
    lang = np.array([0, 1, 1, 3, 9], np.int32)
    tq, jq = both(quality())
    got = tdg.dual_gate_ood(tp, {k: t(v) for k, v in thr.items()}, tq, t(logits), t(feats),
                            language_id=t(lang))
    want = jdg.dual_gate_ood(jp, {k: jnp.asarray(v) for k, v in thr.items()}, jq,
                             jnp.asarray(logits), jnp.asarray(feats),
                             language_id=jnp.asarray(lang))
    for field, g, w in zip(want._fields, got, want):
        if g.dtype.is_floating_point:
            assert_close(g, w, FN_TOL)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)
    snr = np.array([-5.0, 9.99, 10.0, 19.9, 20.0, 40.0], np.float32)
    np.testing.assert_array_equal(tdg.snr_band_index(t(snr)).numpy(),
                                  np.asarray(jdg.snr_band_index(jnp.asarray(snr))))
    late = tdg.late_ood(tp, t(logits), t(feats), threshold=0.6)
    jlate = jdg.late_ood(jp, jnp.asarray(logits), jnp.asarray(feats), threshold=0.6)
    for g, w in zip(late, jlate):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), rtol=FN_TOL,
                                   atol=FN_TOL)


def test_outlier_exposure_loss_matches_jax():
    inl = RNG.standard_normal((4, 4)).astype(np.float32)
    outl = RNG.standard_normal((3, 4)).astype(np.float32)
    labels = np.array([0, 3, 1, 2], np.int32)
    assert_close(tdg.outlier_exposure_loss(t(inl), t(labels), t(outl)),
                 jdg.outlier_exposure_loss(jnp.asarray(inl), jnp.asarray(labels),
                                           jnp.asarray(outl)), FN_TOL)

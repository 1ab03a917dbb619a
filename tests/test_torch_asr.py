"""The port's ASR integration (frontend/asr.py) against the JAX package's
on the CPU: every copied function, the integration with the port's
Whisper backend (TorchWhisperASR) against JAX's (JaxWhisperASR) on the
same random-weight transformers model, the loader's `asr_feats`, and
`--use_asr` through the eval and train CLIs.

Hub lookups are offline and sockets blocked wherever the default backend
(WhisperASR, transformers) might be asked for a model: it reports itself
unavailable, as it does on a machine without the weights, and the
integration takes the empty-result path.

Tolerances: the copied functions are equal; the integration's word
confidences and 8-dim features within 1e-6 (the decode's confidences agree
to 1e-5 in tests/test_torch_whisper.py, and a word's is a mean of them).
"""

import dataclasses
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import config as jcfg
from multilingual_multimodal_speech_emotion_recognition_tpu.data import (
    audio_io as jaio, manifest as jman, pipeline as jpipe, tokenizer as jtok)
from multilingual_multimodal_speech_emotion_recognition_tpu.eval import evaluate as jev
from multilingual_multimodal_speech_emotion_recognition_tpu.frontend import asr as jasr
from multilingual_multimodal_speech_emotion_recognition_tpu.models import model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu.train import checkpoint as jckpt
from multilingual_multimodal_speech_emotion_recognition_tpu.utils import runtime as jruntime
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
    config as tcfg, weights)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli import (
    eval as eval_cli, train as train_cli)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
    pipeline as tpipe, tokenizer as ttok)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import evaluate as tev
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.frontend import asr as tasr
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import model as tm
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
    checkpoint as tckpt)

from test_model import tiny_config
from test_whisper import hf_whisper  # noqa: F401  (a fixture)
from torch_port_helpers import offline_hub  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parents[1]
SR = 16000
TOL = 1e-6
TEXTS = ["angry shouting words", "", "привет hello мир", "", "नमस्ते दुनिया", "calm words"]


def _tone(seconds, freq, seed, silence=0.0):
    """A tone with a little noise, after `silence` seconds of silence."""
    n = int(SR * seconds)
    x = 0.4 * np.sin(2 * np.pi * freq * np.arange(n) / SR)
    x += 0.01 * np.random.default_rng(seed).standard_normal(n)
    x[:int(SR * silence)] = 0.0
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Six clips of 0.6-1.1 s (some opening on silence), text on four of
    them; the manifest's path."""
    root = tmp_path_factory.mktemp("asr")
    (root / "datasets" / "synth").mkdir(parents=True)
    items = []
    for i, text in enumerate(TEXTS):
        x = _tone(0.6 + 0.1 * i, 200.0 * (i + 1), i, silence=0.2 * (i % 2))
        jaio.write_wav(root / "datasets" / "synth" / f"a{i}.wav", x, SR)
        items.append({"audio": f"synth/a{i}.wav", "text": text, "label": i % 4})
    jman.write_manifest(root / "m.jsonl", items)
    return root, str(root / "m.jsonl")


# ------------------------------------------------------------ the copies

@pytest.mark.parametrize("confs", [[0.1, 0.4, 0.9], [], [0.3, 0.6, 0.2999, 0.5999, 1.0]])
def test_confidence_weighted_mask_matches_jax(confs):
    got, want = tasr.confidence_weighted_mask(confs), jasr.confidence_weighted_mask(confs)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tokens,confs", [
    ([" the", " qu", "ick", " fox"], [0.9, 0.8, 0.6, 1.0]),
    (["▁hola", "▁mun", "do"], [0.5, 0.25, 0.75]),
    (["a", "b", "c"], [0.1, 0.2, 0.3]),
    ([], [])])
def test_token_grouping_matches_jax(tokens, confs):
    assert (tasr.group_token_confidences_to_words(tokens, confs)
            == jasr.group_token_confidences_to_words(tokens, confs))


@pytest.mark.parametrize("text", ["hello world", "привет hello мир", "नमस्ते", "বাংলা",
                                  "hello привет world", "", "123 !!",
                                  "日本語 and 한국어 తెలుగు مرحبا カタカナ"])
def test_script_and_code_switch_detection_match_jax(text):
    assert tasr.detect_scripts(text) == jasr.detect_scripts(text)
    assert tasr.detect_code_switches(text) == jasr.detect_code_switches(text)


@pytest.mark.parametrize("text,duration", [("ab cd", 2.0), ("", 1.0), ("one two three", 0.7)])
def test_alignment_matches_jax(text, duration):
    ts = tasr.uniform_word_timestamps(text, duration)
    assert ts == jasr.uniform_word_timestamps(text, duration)
    assert tasr.char_phone_alignment(text, ts) == jasr.char_phone_alignment(text, ts)


@pytest.mark.parametrize("kind", ["tone_after_silence", "noise", "shorter_than_a_frame",
                                  "silent", "gaps"])
def test_silence_regions_match_jax(kind):
    audio = {"tone_after_silence": _tone(1.0, 300.0, 0, silence=0.3),
             "noise": np.random.default_rng(1).standard_normal(SR).astype(np.float32),
             "shorter_than_a_frame": np.ones(100, np.float32),
             "silent": np.zeros(SR, np.float32),
             "gaps": _tone(1.5, 440.0, 2) * (np.arange(int(1.5 * SR)) % 8000 < 5000)}[kind]
    assert tasr.silence_regions_rms(audio, SR) == jasr.silence_regions_rms(audio, SR)


def test_calibrator_matches_jax():
    x = np.array([0.2, 0.5, 0.8])
    t, j = tasr.ConfidenceCalibrator(), jasr.ConfidenceCalibrator()
    np.testing.assert_array_equal(t.calibrate(x), j.calibrate(x))
    conf = np.linspace(0, 1, 100)
    correct = (conf + 0.2 * np.sin(40 * conf) > 0.5).astype(float)
    t.fit(conf, correct)
    j.fit(conf, correct)
    probe = np.linspace(-0.5, 1.5, 41)
    np.testing.assert_array_equal(t.calibrate(probe), j.calibrate(probe))


def test_feature_vector_matches_jax():
    fields = dict(text="one two three", detected_languages=["en", "hi"],
                  code_switches=[{}] * 3, silence_regions=[(0.0, 0.5)] * 2,
                  word_timestamps=[(0.0, 0.5), (0.5, 1.0), (1.0, 1.75)],
                  overall_confidence=0.8, text_reliability_score=0.7)
    got = tasr.EnhancedASRIntegration.features(tasr.ASRResult(**fields))
    want = jasr.EnhancedASRIntegration.features(jasr.ASRResult(**fields))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert ([f.name for f in dataclasses.fields(tasr.ASRResult)]
            == [f.name for f in dataclasses.fields(jasr.ASRResult)])


def assert_same_result(got, want, tol=0.0):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name in ("word_confidences", "segment_confidence", "overall_confidence",
                      "text_reliability_score", "asr_features", "attention_mask_weighted"):
            np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                       rtol=tol, atol=tol, err_msg=f.name)
        else:
            assert g == w, f.name


@pytest.mark.parametrize("text", ["the quick brown fox", None])
def test_integration_without_a_backend_matches_jax(offline_hub, text):
    """Manifest text: no backend is asked. No text and no usable backend
    (the default, offline): the empty result."""
    audio = _tone(1.0, 300.0, 3, silence=0.4)
    t, j = tasr.create_enhanced_asr(), jasr.create_enhanced_asr()
    got, want = t.process(audio, SR, text=text), j.process(audio, SR, text=text)
    assert_same_result(got, want)
    assert isinstance(t.backend, tasr.WhisperASR)
    if text is None:
        assert not t.backend.available and got.text == "" and got.asr_features[7] == 0.0
    else:
        assert t.backend._model is None and not t.backend._failed   # never asked


# ------------------------------------------------------- the Whisper backend

@pytest.mark.parametrize("prefix", [None, [1, 5, 9]], ids=["start", "3-token"])
def test_torch_whisper_backend_matches_jax_backend(hf_whisper, prefix):  # noqa: F811
    """EnhancedASRIntegration over TorchWhisperASR and over JaxWhisperASR,
    the same transformers model converted by each: the same transcription
    (raw ids, no tokenizer), word confidences and features."""
    model, _, _ = hf_whisper
    audio = _tone(1.0, 330.0, 4, silence=0.3)
    t = tasr.TorchWhisperASR.from_hf_model(model, max_new_tokens=6, prefix_ids=prefix,
                                           device="cpu")
    j = jasr.JaxWhisperASR.from_hf_model(model, max_new_tokens=6, prefix_ids=prefix)
    assert t.available and t.device.type == "cpu"
    text, tokens, confs = t.transcribe(audio, SR)
    want_text, want_tokens, want_confs = j.transcribe(audio, SR)
    assert (text, tokens) == (want_text, want_tokens) and 1 <= len(tokens) <= 6
    np.testing.assert_allclose(confs, want_confs, rtol=1e-5, atol=1e-5)
    got = tasr.EnhancedASRIntegration(backend=t).process(audio, SR)
    want = jasr.EnhancedASRIntegration(backend=j).process(audio, SR)
    assert got.text == text and got.asr_features.shape == (8,)
    assert_same_result(got, want, TOL)


def test_torch_whisper_backend_defaults_to_the_card(hf_whisper):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tasr.TorchWhisperASR.from_hf_model(hf_whisper[0])


# ------------------------------------------------------------ the loader

def test_loader_asr_feats_match_jax(clips, offline_hub):
    """emit_asr_feats: per-row features, from the manifest text where there
    is one, else from the (unavailable) default backend; padded rows stay
    zero."""
    root, manifest = clips
    data = dict(audio_buckets=(1.0, 2.0), max_text_tokens=8, emit_asr_feats=True,
                dataset_root=str(root / "datasets"))
    kw = dict(batch_size=4, shuffle=False, num_workers=2)
    t = tpipe.BucketedLoader(tpipe.SERDataset(manifest, tcfg.DataConfig(**data)),
                             tokenizer=ttok.HashTokenizer(100), **kw)
    j = jpipe.BucketedLoader(jpipe.SERDataset(manifest, jcfg.DataConfig(**data)),
                             tokenizer=jtok.HashTokenizer(100), **kw)
    got, want = list(t.epoch(0)), list(j.epoch(0))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and "asr_feats" in g
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert not g["asr_feats"][g["example_mask"] == 0].any()
    rows = np.concatenate([b["asr_feats"][b["example_mask"] > 0] for b in got])
    assert (rows[:, 7] == 1.0).sum() == 4           # the four rows with text
    assert not t._asr_integration.backend.available


# -------------------------------------------------------------- the CLIs

def test_eval_cli_use_asr_builds_the_repo_cli_config(clips, monkeypatch, tmp_path):
    """--use_asr turns on the model's ASR fusion and the loader's features,
    the config the repo's cli/eval.py builds from the same checkpoint."""
    root, manifest = clips
    jc = jcfg.Config(model=tiny_config(),
                     data=jcfg.DataConfig(dataset_root=str(root / "datasets")))
    jparams = jax.tree.map(np.asarray, jax.jit(jm.init_model, static_argnums=1)(
        jax.random.key(0), jc.model))
    jckpt.save_checkpoint(tmp_path / "jax", params=jparams, config_json=jcfg.to_json(jc))
    tckpt.save_checkpoint(tmp_path / "port", params=weights.params_from_jax(
        jparams, tcfg.config_from_json(jcfg.to_json(jc)).model, device="cpu"),
        config_json=jcfg.to_json(jc))
    captured = {}

    def capture(name):
        def fake(params, cfg, manifest_path, **kw):
            captured[name] = cfg
            return {"logits": np.zeros((1, 4)), "temperature": 1.0}
        return fake

    args = ["--manifest", manifest, "--use_asr"]
    jax_cli = runpy.run_path(str(REPO / "cli" / "eval.py"), run_name="jax_cli")
    monkeypatch.setattr(jruntime, "configure", lambda **kw: None)
    monkeypatch.setattr(jev, "evaluate_manifest", capture("jax"))
    monkeypatch.setattr(sys, "argv", ["eval.py", "--checkpoint", str(tmp_path / "jax")] + args)
    jax_cli["main"]()
    monkeypatch.setattr(tev, "evaluate_manifest", capture("port"))
    eval_cli.main(["--checkpoint", str(tmp_path / "port"), "--device", "cpu"] + args)
    want = json.loads(jcfg.to_json(captured["jax"]))
    assert json.loads(tcfg.to_json(captured["port"])) == want
    assert captured["port"].model.use_asr and captured["port"].data.emit_asr_feats


def test_train_cli_use_asr_takes_a_step_with_asr_features(clips, offline_hub, monkeypatch,
                                                           tmp_path):
    """--use_asr through the train CLI on the CPU, the model cut to tiny
    widths: one optimizer step, and every training and validation forward
    gets the loader's [B, 8] ASR features."""
    root, manifest = clips
    build = train_cli.build_config
    model = tcfg.from_json(json.dumps(dataclasses.asdict(tiny_config())))

    def tiny(args):
        cfg = build(args)
        assert cfg.model.use_asr and cfg.data.emit_asr_feats
        return dataclasses.replace(
            cfg, model=dataclasses.replace(model, use_asr=True),
            data=dataclasses.replace(cfg.data, audio_buckets=(2.0,), max_text_tokens=12))

    seen = []
    forward = tm.model_forward

    def spy(params, cfg, batch, **kw):
        seen.append((kw.get("deterministic", True), tuple(batch["asr_feats"].shape)))
        return forward(params, cfg, batch, **kw)

    monkeypatch.setattr(train_cli, "build_config", tiny)
    monkeypatch.setattr(tm, "model_forward", spy)
    res = train_cli.main(["--train_manifest", manifest, "--val_manifest", manifest,
                          "--epochs", "1", "--batch_size", "6", "--dataset_root",
                          str(root / "datasets"), "--save_dir", str(tmp_path), "--use_asr",
                          "--device", "cpu"])
    assert np.isfinite(res["best_f1"])
    assert (False, (6, 8)) in seen and (True, (6, 8)) in seen
    assert all(shape == (6, 8) for _, shape in seen)

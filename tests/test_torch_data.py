"""The port's data layer (data/, config.DataConfig) against the JAX
package's on the CPU: manifests and splits, the hash tokenizer, bucketing,
and BucketedLoader batches over WAVs written here (tones whose lengths
cross two buckets, one missing file), key by key with arrays equal; then
the device prefetch on the CPU."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import config as jcfg
from multilingual_multimodal_speech_emotion_recognition_tpu.data import (
    audio_io as jaio, bucketing as jbuck, manifest as jman, native as jnative,
    pipeline as jpipe, tokenizer as jtok)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
    audio_io as taio, bucketing as tbuck, manifest as tman, native as tnative,
    pipeline as tpipe, prefetch as tprefetch, tokenizer as ttok)

SR = 16000
TEXTS = ["angry shouting words", "happy cheerful words", "sad crying words",
         "neutral plain words", "", "Bonjour le monde"]


def manifest_items(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return [{"audio": f"d/{i}.wav", "text": TEXTS[i % len(TEXTS)], "label": int(rng.integers(4)),
             "dataset": ("crema", "tess")[i % 2], "speaker": f"s{i % 7}"} for i in range(n)]


def test_manifest_round_trip_and_splits_match_jax(tmp_path):
    items = manifest_items()
    tman.write_manifest(tmp_path / "m.jsonl", items)
    assert tman.read_manifest(tmp_path / "m.jsonl") == items
    assert jman.read_manifest(tmp_path / "m.jsonl") == items
    for seed in (0, 42):
        assert tman.stratified_split(items, seed=seed) == jman.stratified_split(items, seed=seed)
        assert (tman.speaker_disjoint_split(items, seed=seed)
                == jman.speaker_disjoint_split(items, seed=seed))
    assert tman.class_distribution(items) == jman.class_distribution(items)
    for name in ("1001_DFA_ANG_XX.wav", "1001_DFA_FEA_XX.wav", "bad.wav"):
        assert tman.crema_label(name, 4) == jman.crema_label(name, 4)
        assert tman.crema_label(name, 6) == jman.crema_label(name, 6)
    for name in ("03-01-05-01-01-01-12.wav", "03-01-08-01-01-01-02.wav"):
        assert tman.ravdess_label(name) == jman.ravdess_label(name)
        assert tman.ravdess_speaker(name) == jman.ravdess_speaker(name)
    assert tman.tess_label("OAF_back_pleasant_surprised.wav") == jman.tess_label(
        "OAF_back_pleasant_surprised.wav")


@pytest.mark.parametrize("max_len", [4, 12, 64])
def test_hash_tokenizer_matches_jax(max_len):
    texts = TEXTS + ["a much longer sentence with more words than the shortest cap holds",
                     None]
    for vocab in (100, 250002):
        got = ttok.HashTokenizer(vocab).encode_batch(texts, max_len)
        want = jtok.HashTokenizer(vocab).encode_batch(texts, max_len)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_bucketing_matches_jax():
    rng = np.random.default_rng(3)
    lengths = rng.integers(8000, 30 * SR, 200)
    for k in (1, 3, 5):
        assert tbuck.optimal_buckets(lengths, k) == jbuck.optimal_buckets(lengths, k)
        assert (tbuck.autotune_audio_buckets(lengths, k, SR)
                == jbuck.autotune_audio_buckets(lengths, k, SR))
    caps = [tbuck.seconds_to_samples(s, SR) for s in (2.0, 4.0, 8.04, 16.0, 30.0)]
    assert caps == [jbuck.seconds_to_samples(s, SR) for s in (2.0, 4.0, 8.04, 16.0, 30.0)]
    assert tbuck.padded_fraction(lengths, caps) == jbuck.padded_fraction(lengths, caps)


def test_data_config_and_config_json_match_jax():
    assert dataclasses.asdict(tcfg.DataConfig()) == dataclasses.asdict(jcfg.DataConfig())
    data = jcfg.DataConfig(audio_buckets=(1.0, 3.5), max_text_tokens=12, gates_see_text=False)
    want = jcfg.Config(model=jcfg.ModelConfig(num_labels=6, compute_dtype="bfloat16"),
                       data=data, train=jcfg.TrainConfig(epochs=2))
    d = json.loads(jcfg.to_json(want))
    d["model"]["a_later_field"] = 1
    got = tcfg.config_from_json(json.dumps(d))
    assert dataclasses.asdict(got.data) == dataclasses.asdict(want.data)
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)
    assert got.data.audio_buckets == (1.0, 3.5)
    assert tcfg.from_json(jcfg.to_json(want)) == got.model
    assert tcfg.config_from_json(tcfg.to_json(got)) == got


@pytest.fixture(scope="module")
def wav_manifest(tmp_path_factory):
    """Tones of 0.3-2.9 s (the 0.5 s floor pads the shortest) across the
    1 s and 2 s buckets, clipped by a 2.5 s max, texts of every kind, and
    one missing file."""
    root = tmp_path_factory.mktemp("loader")
    wavdir = root / "datasets" / "synth"
    wavdir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    items = []
    for i in range(13):
        L = int(SR * (0.3 + 0.2 * i))
        t = np.arange(L) / SR
        x = 0.5 * np.sin(2 * np.pi * (250.0 * (1 + i % 4)) * t) + 0.01 * rng.standard_normal(L)
        jaio.write_wav(wavdir / f"s{i:03d}.wav", x.astype(np.float32), SR)
        items.append({"audio": f"synth/s{i:03d}.wav", "text": TEXTS[i % len(TEXTS)],
                      "label": i % 4, "dataset": "synth"})
    items.insert(5, {"audio": "synth/missing.wav", "text": "lost", "label": 2,
                     "dataset": "synth"})
    jman.write_manifest(root / "m.jsonl", items)
    return root


def loader_pair(root, *, shuffle, batch_size=4, **data_kw):
    data = dict(audio_buckets=(1.0, 2.0), max_audio_seconds=2.5, max_text_tokens=8,
                dataset_root=str(root / "datasets"), **data_kw)
    tok_args = dict(batch_size=batch_size, shuffle=shuffle, seed=3, num_workers=2)
    t = tpipe.BucketedLoader(tpipe.SERDataset(str(root / "m.jsonl"), tcfg.DataConfig(**data)),
                             tokenizer=ttok.HashTokenizer(100), **tok_args)
    j = jpipe.BucketedLoader(jpipe.SERDataset(str(root / "m.jsonl"), jcfg.DataConfig(**data)),
                             tokenizer=jtok.HashTokenizer(100), **tok_args)
    return t, j


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("decoder", ["native", "python"])
@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
def test_bucketed_loader_matches_jax(wav_manifest, monkeypatch, decoder, shuffle):
    if decoder == "python":
        monkeypatch.setattr(tnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    else:
        assert tnative.available(), "g++ could not build native/wav_decoder.cc"
    t, j = loader_pair(wav_manifest, shuffle=shuffle)
    assert t._lengths == j._lengths
    assert t.batches_per_epoch() == j.batches_per_epoch()
    got, want = list(t.epoch(1)), list(j.epoch(1))
    assert t.decoder == decoder
    assert_same_batches(got, want)
    shapes = {b["audio"].shape for b in got}
    assert shapes == {(4, SR), (4, 2 * SR)}          # two buckets
    rows = np.concatenate([b["indices"][b["example_mask"] > 0] for b in got])
    assert sorted(rows.tolist()) == list(range(14))  # every clip once, the missing one too
    for b in got:
        pad = b["example_mask"] == 0
        assert (b["indices"][pad] == -1).all()
        assert (b["audio_mask"][pad].sum(-1) == 1).all()  # padded rows keep one sample
    missing = [b for b in got if 5 in b["indices"].tolist()][0]
    r = missing["indices"].tolist().index(5)
    assert missing["audio_mask"][r].sum() == SR and not missing["audio"][r].any()


def test_loader_options_match_jax(wav_manifest):
    for kw in ({"gates_see_text": False}, {"pad_to_batch_max": True}):
        t, j = loader_pair(wav_manifest, shuffle=False, batch_size=3, **kw)
        assert_same_batches(list(t.epoch(0)), list(j.epoch(0)))


def test_loader_raises_for_asr_features(wav_manifest, tmp_path):
    """emit_asr_feats: each row's 8-dim ASR features from its manifest text
    (no transcription backend is asked where every row has text), equal to
    JAX's loader; padded rows stay zero."""
    items = [it for it in jman.read_manifest(wav_manifest / "m.jsonl") if it["text"]]
    jman.write_manifest(tmp_path / "m.jsonl", items)
    (tmp_path / "datasets").symlink_to(wav_manifest / "datasets")
    t, j = loader_pair(tmp_path, shuffle=False, batch_size=3, emit_asr_feats=True)
    got = list(t.epoch(0))
    assert_same_batches(got, list(j.epoch(0)))
    for b in got:
        assert b["asr_feats"].shape == (3, 8) and b["asr_feats"].dtype == np.float32
        assert (b["asr_feats"][b["example_mask"] > 0, 7] == 1.0).all()
        assert not b["asr_feats"][b["example_mask"] == 0].any()
    backend = t._asr_integration.backend
    assert backend._model is None and not backend._failed   # never asked


def test_native_library_builds_under_build_dir():
    path = tnative._library_path()
    assert path.parent == tnative._ROOT / "build" / "native"
    assert tnative.available() and path.exists()


def test_load_audio_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    jaio.write_wav(tmp_path / "a.wav", 0.3 * rng.standard_normal(3000).astype(np.float32), SR)
    jaio.write_wav(tmp_path / "b.wav", 0.3 * rng.standard_normal(50000).astype(np.float32), 22050)
    for name in ("a.wav", "b.wav", "missing.wav"):
        kw = dict(sr=SR, max_length=2.0, min_length=0.5, dataset_root=str(tmp_path))
        np.testing.assert_array_equal(taio.load_audio(name, **kw), jaio.load_audio(name, **kw))


def test_device_prefetch_on_the_cpu(wav_manifest):
    t, _ = loader_pair(wav_manifest, shuffle=False)
    host = list(t.epoch(0))
    pairs = list(tprefetch.device_prefetch(iter(host), torch.device("cpu"),
                                           skip=tpipe.EVAL_HOST_KEYS))
    assert len(pairs) == len(host)
    for (dev, hb), want in zip(pairs, host):
        assert hb is want
        assert set(dev) == set(want) - set(tpipe.EVAL_HOST_KEYS)
        for k, v in dev.items():
            assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(), want[k])

    def failing():
        yield host[0]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(tprefetch.device_prefetch(failing(), torch.device("cpu")))

"""The port's academic battery (eval/academic.py) against the JAX package's
on the CPU, on tests/test_academic.py's 24-clip synthetic manifest with a
tiny config and JAX's parameters bridged to the port.

The JAX battery is not run whole here (it alone takes about a minute):
its parts are. The baseline pass's logits are held at 1e-4; the
open-set protocol's AUROC, AUPR, FPR@95 and OSCR at 1e-6, once the
smallest top-2 margin of the known-class logits is shown to exceed ten
times the logits' tolerance (so no argmax can differ). The port's battery
runs once with every part on and writes the JAX battery's sections."""

import json

import numpy as np
import pytest
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.config import (
    Config as JConfig, DataConfig as JData)
from multilingual_multimodal_speech_emotion_recognition_tpu.data import (
    pipeline as jpipe, tokenizer as jtok)
from multilingual_multimodal_speech_emotion_recognition_tpu.eval import (
    academic as jacad, evaluate as jev)
from multilingual_multimodal_speech_emotion_recognition_tpu.parallel import mesh as jmesh
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
    audio_io, manifest, pipeline as tpipe, tokenizer as ttok)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
    academic as tacad, evaluate as tev)

from test_model import tiny_config
from test_torch_train_step import params_for, port_config
from torch_port_helpers import one_torch_thread

SR = 16000
TEXTS = ["the angry one", "el gato feliz", "the sad words", "plain neutral"]
LOGIT_TOL = 1e-4
METRIC_TOL = 1e-6
UNKNOWN = 3
# the sections the JAX battery writes with every part on
SECTIONS = ["baseline", "cross_lingual", "calibration", "asr_tracking", "risk_coverage",
            "open_set", "inference_benchmark", "per_snr", "few_shot", "robustness",
            "zero_shot", "per_class_accuracy", "confusion_matrix", "part_seconds"]
PARTS = ["baseline", "cross_lingual", "calibration", "asr_risk_coverage",
         "benchmark_per_snr", "few_shot", "robustness", "per_class_report"]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """tests/test_academic.py's manifest: 24 clips of 0.6 s, a tone per
    class, one Spanish text."""
    root = tmp_path_factory.mktemp("torch_acad")
    wavdir = root / "datasets" / "synth"
    wavdir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    items = []
    for i in range(24):
        label = i % 4
        t = np.arange(int(SR * 0.6)) / SR
        x = 0.4 * np.sin(2 * np.pi * [300, 600, 1200, 2400][label] * t)
        x = (x + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
        audio_io.write_wav(wavdir / f"a{i:02d}.wav", x, SR)
        items.append({"audio": f"synth/a{i:02d}.wav", "text": TEXTS[label],
                      "label": label, "dataset": "synth"})
    manifest.write_manifest(root / "val.jsonl", items)
    jmodel = tiny_config()
    jcfg = JConfig(model=jmodel, data=JData(audio_buckets=(1.0,), max_text_tokens=12,
                                            dataset_root=str(root / "datasets")))
    cfg = tcfg.Config(model=port_config(jmodel),
                      data=tcfg.DataConfig(audio_buckets=(1.0,), max_text_tokens=12,
                                           dataset_root=str(root / "datasets")))
    jp, tp = params_for(jmodel, seed=0)
    return root, jcfg, cfg, jp, tp


def loaders(root, jcfg, cfg):
    manifest_path = str(root / "val.jsonl")
    jl = jpipe.BucketedLoader(jpipe.SERDataset(manifest_path, jcfg.data), batch_size=8,
                              tokenizer=jtok.HashTokenizer(vocab_size=100), shuffle=False)
    tl = tpipe.BucketedLoader(tpipe.SERDataset(manifest_path, cfg.data), batch_size=8,
                              tokenizer=ttok.HashTokenizer(vocab_size=100), shuffle=False)
    return jl, tl


def test_collect_logits_matches_jax(setup):
    root, jcfg, cfg, jp, tp = setup
    jl, tl = loaders(root, jcfg, cfg)
    want = jev.collect_logits(jp, jcfg, jl, jmesh.mesh_from_config(jcfg.mesh),
                              use_openmax=True)
    got = tev.collect_logits(tp, cfg, tl, use_openmax=True, device="cpu")
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["indices"], want["indices"])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_open_set_protocol_matches_jax(setup):
    root, jcfg, cfg, jp, tp = setup
    jl, tl = loaders(root, jcfg, cfg)
    logits = tev.collect_logits(tp, cfg, tl, use_openmax=False, device="cpu")["logits"]
    known = np.sort(np.delete(logits, UNKNOWN, axis=1), axis=1)
    margin = float((known[:, -1] - known[:, -2]).min())
    assert margin > 10 * LOGIT_TOL, f"top-2 logit margin {margin}: an argmax could differ"
    want = jacad._open_set_protocol(jp, jcfg, jacad._BatchCache(jl),
                                    jmesh.mesh_from_config(jcfg.mesh), UNKNOWN)
    cache = tacad._BatchCache(tl)
    try:
        got = tacad._open_set_protocol(tp, cfg, cache, torch.device("cpu"), UNKNOWN)
    finally:
        cache.close()
    assert list(got) == list(want)
    for k in ("protocol", "unknown_class", "num_known", "num_unknown"):
        assert got[k] == want[k]
    assert (got["num_known"], got["num_unknown"]) == (18, 6)
    for k in ("oscr_score", "oscr_optimal_threshold", "auroc", "aupr", "fpr_at_95tpr",
              "known_weighted_f1"):
        assert got[k] == pytest.approx(want[k], abs=METRIC_TOL), k
    assert list(got["scores"]) == ["msp", "energy", "openmax"]
    for name, s in want["scores"].items():
        for k, v in s.items():
            assert got["scores"][name][k] == pytest.approx(v, abs=METRIC_TOL), (name, k)


def test_academic_battery(setup, tmp_path):
    root, _, cfg, _, tp = setup
    res = tacad.run_academic_evaluation(
        tp, cfg, str(root / "val.jsonl"), batch_size=8,
        tokenizer=ttok.HashTokenizer(vocab_size=100), device="cpu",
        output_dir=str(tmp_path / "out"), run_benchmark=True, run_few_shot=True,
        few_shot_shots=[4, 8], few_shot_epochs=1, full_ft_f1=0.9, run_robustness=True,
        robustness_snr_levels=[20.0, 0.0], zero_shot_languages=("hi", "bn", "te"),
        open_set_unknown_class=UNKNOWN, verbose=False)
    data = json.loads((tmp_path / "out" / "academic_evaluation.json").read_text())
    assert list(data) == SECTIONS
    assert list(res) == SECTIONS + ["report"]
    assert list(data["part_seconds"]) == PARTS
    assert all(v >= 0 for v in data["part_seconds"].values())

    b = data["baseline"]
    assert b["num_samples"] == 24 and 0.0 <= b["weighted_f1"] <= 1.0
    assert {"en", "es"} <= set(data["cross_lingual"]["per_language"])
    assert data["calibration"]["quality"] in ("excellent", "good", "moderate", "poor")
    assert data["asr_tracking"]["overall_wer"] == 0.0 and data["asr_tracking"]["total_words"] > 0
    assert set(data["risk_coverage"]) == {"risk_coverage_auc", "optimal_threshold",
                                          "optimal_coverage", "optimal_risk"}
    assert data["open_set"]["num_unknown"] == 6
    ib = data["inference_benchmark"]
    assert list(ib["per_batch_size"]) == ["1", "4", "8"]
    assert ib["params"]["total_params"] > 0
    assert "device_peak_bytes" not in ib["per_batch_size"]["8"]   # no device memory on the CPU
    assert sum(s["sample_count"] for s in data["per_snr"].values()) == 24
    assert [r["num_shots"] for r in data["few_shot"]] == [4, 8]
    assert all(0.0 <= r["recovery_rate"] <= 100.0 for r in data["few_shot"])
    noise = data["robustness"]["noise"]
    assert list(noise) == ["gaussian", "babble", "music"]
    assert all(list(per) == ["20dB", "0dB"] and "f1_degradation" in per["0dB"]
               for per in noise.values())
    assert list(data["robustness"]["code_mixing"]) == ["hi", "bn"]
    assert all(list(per) == ["ratio_0", "ratio_0.25", "ratio_0.5", "ratio_0.75", "ratio_1"]
               for per in data["robustness"]["code_mixing"].values())
    zs = data["zero_shot"]
    assert list(zs["per_language"]) == ["en", "hi", "bn", "te"]
    assert all(zs["per_language"][lang]["sample_count"] == 24 for lang in ("hi", "bn", "te"))
    assert len(data["confusion_matrix"]) == 4

    report = (tmp_path / "out" / "academic_report.txt").read_text()
    assert report == res["report"]
    for heading in ("ACADEMIC EVALUATION REPORT", "Few-shot adaptation", "Robustness (noise)",
                    "Per-SNR-band performance", "Zero-shot cross-lingual", "Open-set recognition",
                    "Throughput:"):
        assert heading in report
    # the report is the JAX battery's own text for the same results
    assert jacad.generate_report(res, tacad.EMOTIONS_6[:4]) == report


def test_batch_cache_streams_from_disk(setup):
    """After the first pass the cache holds file paths, not arrays; later
    passes replay the same batches from disk, and close() removes them."""
    import gc

    root, jcfg, cfg, _, _ = setup
    _, tl = loaders(root, jcfg, cfg)
    cache = tacad._BatchCache(tl)
    try:
        first = [{k: np.array(v) for k, v in b.items()} for b in cache.epoch(0)]
        assert len(first) >= 3
        for view in (cache.epoch(0), iter(cache.batches)):
            second = list(view)
            assert len(second) == len(first)
            for a, b in zip(first, second):
                assert set(a) == set(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        held = [o for o in gc.get_referents(vars(cache)) if isinstance(o, np.ndarray)]
        assert cache._files and all(f.exists() for f in cache._files)
        assert not held, "cache retains decoded arrays in RAM"
    finally:
        cache.close()
    assert not any(f.exists() for f in cache._files)

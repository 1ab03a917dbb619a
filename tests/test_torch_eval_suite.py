"""The port's pure evaluation modules (eval/calibration, openset, slicing,
wer, cascade, enhanced_pipeline, zero_shot, benchmark) against the JAX
package's on the same seeded inputs, on the CPU. They are the same numpy
arithmetic, so floats are held to 1e-12; `worst_case_dsp_audio` is held
bitwise, and so is `chip_smoke.worst_case_dsp_audio` against the copy the
script carried before it called the port's function. The port's
fit_cascade CLI writes the JSON the repo's cli/fit_cascade.py writes."""

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import jax

from multilingual_multimodal_speech_emotion_recognition_tpu import config as jcfg
from multilingual_multimodal_speech_emotion_recognition_tpu.eval import (
    benchmark as jbench, calibration as jcal, cascade as jcas, enhanced_pipeline as jep,
    openset as josr, slicing as jsl, wer as jwer, zero_shot as jzs)
from multilingual_multimodal_speech_emotion_recognition_tpu.models import model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu.train import distill as jdst
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli import (
    fit_cascade as fit_cli)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
    benchmark as tbench, calibration as tcal, cascade as tcas, enhanced_pipeline as tep,
    openset as tosr, slicing as tsl, wer as twer, zero_shot as tzs)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import model as tm

from test_model import tiny_config
from torch_port_helpers import one_torch_thread, bridge

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-12

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def assert_same(got, want, path="result"):
    """Equal structure; floats within TOL, everything else exactly equal."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        got, want = vars(got), vars(want)
    if hasattr(want, "_asdict"):
        assert type(got).__name__ == type(want).__name__, path
        got, want = got._asdict(), want._asdict()
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), f"{path}: keys"
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), f"{path}: length"
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.shape == want.shape, f"{path}: shape"
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, (float, np.floating)) and not isinstance(want, bool):
        assert isinstance(got, (float, np.floating)), path
        if math.isnan(want):
            assert math.isnan(got), path
        else:
            assert got == pytest.approx(want, rel=TOL, abs=TOL), path
    else:
        assert got == want and type(got) is type(want), f"{path}: {got!r} != {want!r}"


def predictions(n=300, num_classes=4, seed=0):
    """labels, preds, probs with correctness-correlated confidences."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    preds = np.where(rng.uniform(size=n) < 0.7, labels, rng.integers(0, num_classes, n))
    conf = np.clip(rng.uniform(0.3, 0.7, n) + 0.25 * (preds == labels), 0, 0.999)
    probs = np.tile(((1 - conf) / (num_classes - 1))[:, None], (1, num_classes))
    probs[np.arange(n), preds] = conf
    return labels, preds, probs


def _calibration():
    labels, preds, probs = predictions(seed=1)
    out = []
    for mod in (tcal, jcal):
        m = mod.compute_calibration_metrics(preds, labels, probs, n_bins=15)
        out.append({"metrics": m, "quality": [mod.calibration_quality(e)
                                              for e in (0.01, 0.07, 0.12, 0.3, m.ece)],
                    "report": mod.calibration_report(m)})
    return out


def _openset():
    rng = np.random.default_rng(2)
    known = rng.normal(0.7, 0.15, 200)
    unknown = rng.normal(0.4, 0.2, 90)
    labels, preds, probs = predictions(seed=2)
    y_os = np.where(rng.uniform(size=len(labels)) < 0.2, -1, labels)
    # ties in the scores exercise the step grid
    tied = np.round(probs.max(axis=1), 2)
    out = []
    for mod in (tosr, josr):
        out.append({
            "roc": mod.roc_curve_np(np.r_[np.ones(200), np.zeros(90)], np.r_[known, unknown]),
            "auroc": mod.auroc(known, unknown), "aupr": mod.aupr(known, unknown),
            "fpr95": mod.fpr_at_95_tpr(known, unknown),
            "empty": (mod.auroc(known, []), mod.aupr([], unknown), mod.fpr_at_95_tpr([], [])),
            "oscr": mod.compute_oscr(tied, y_os, preds),
            "oscr_closed": mod.compute_oscr(tied, labels, preds),
            "risk": mod.risk_coverage_curve(tied, labels, preds)})
    return out


def _slicing():
    labels, preds, probs = predictions(seed=3)
    rng = np.random.default_rng(3)
    langs = rng.choice(["en", "hi", "bn", "es"], len(labels)).tolist()
    snrs = rng.uniform(-5, 30, len(labels))
    conf = probs.max(axis=1)
    out = []
    for mod in (tsl, jsl):
        by_lang = mod.slice_by_language(labels, preds, conf, langs)
        by_snr = mod.slice_by_snr(labels, preds, conf, snrs)
        out.append({"lang": by_lang, "snr": by_snr,
                    "transfer": mod.transfer_ratios(by_lang, "en"),
                    "report": mod.slicing_report({**by_lang, **by_snr})})
    return out


WORDS = ["the", "angry", "cat", "is", "sad", "and", "happy", "words", "a", "dog"]


def _wer():
    rng = np.random.default_rng(4)
    refs = [" ".join(rng.choice(WORDS, rng.integers(1, 9))) for _ in range(40)]
    hyps = []
    for r in refs:
        w = r.split()
        for _ in range(rng.integers(0, 3)):
            op = rng.integers(0, 3)
            if op == 0 and w:
                w[rng.integers(0, len(w))] = str(rng.choice(WORDS))
            elif op == 1 and w:
                del w[rng.integers(0, len(w))]
            else:
                w.insert(int(rng.integers(0, len(w) + 1)), str(rng.choice(WORDS)))
        hyps.append(" ".join(w).upper())
    langs = rng.choice(["en", "hi", "bn"], len(refs))
    out = []
    for mod in (twer, jwer):
        tracker = mod.ASRPerformanceTracker()
        for i, (r, h) in enumerate(zip(refs, hyps)):
            tracker.add_result(r, h, language=str(langs[i]), confidence=float(i % 7) / 7,
                               latency=0.01 * i)
        out.append({
            "lev": [mod.levenshtein(r.split(), h.lower().split()) for r, h in zip(refs, hyps)],
            "align": [mod.align_counts(r.split(), h.lower().split())
                      for r, h in zip(refs, hyps)],
            "wer": mod.wer(refs, hyps), "summary": tracker.summary(),
            "report": tracker.report(),
            "paired": [mod.paired_wer_uar_test({"wer": 30.0, "uar": 0.5},
                                               {"wer": w, "uar": u}, n)
                       for w, u, n in ((20.0, 0.6, 40), (29.0, 0.51, 40), (10.0, 0.7, 12))]})
    return out


def _prediction_rows(seed, n=120):
    rng = np.random.default_rng(seed)
    conf = np.round(rng.uniform(0.25, 1.0, n), 3)   # rounded: tied confidences
    correct = rng.uniform(size=n) < conf
    return [{"index": int(i), "confidence": float(c), "energy": float(-3 * c - rng.uniform()),
             "correct": bool(k)} for i, c, k in zip(rng.permutation(n), conf, correct)]


def _cascade():
    student, teacher = _prediction_rows(5), _prediction_rows(6)
    conf = [r["confidence"] for r in student]
    stu = [r["correct"] for r in student]
    out = []
    for mod in (tcas, jcas):
        out.append({
            "budget": mod.fit_confidence_threshold(conf, stu, escalation_budget=0.2),
            "min_acc": mod.fit_confidence_threshold(conf, stu, min_accuracy=0.8),
            "both_infeasible": mod.fit_confidence_threshold(
                conf, stu, escalation_budget=0.05, min_accuracy=0.99),
            "energy": mod.fit_energy_threshold([r["energy"] for r in student], stu,
                                               quantile=0.95),
            "joined": mod.fit_from_predictions(student, teacher, escalation_budget=0.15,
                                               energy_quantile=0.99),
            "joined_min_acc": mod.fit_from_predictions(student, teacher, min_accuracy=0.9)})
    return out


def _enhanced_pipeline(tmp_path):
    labels, preds, probs = predictions(seed=7)
    rng = np.random.default_rng(7)
    kw = dict(y_true=labels, y_pred=preds, confidence_scores=probs.max(axis=1),
              unknown_mask=rng.uniform(size=len(labels)) < 0.15,
              languages=rng.choice(["en", "hi"], len(labels)).tolist(),
              snr_values=rng.uniform(0, 25, len(labels)),
              raw_audio_metrics={"wer": 25.0, "uar": 0.55},
              processed_audio_metrics={"wer": 18.0, "uar": 0.61})
    out = []
    for name, mod in (("port", tep), ("jax", jep)):
        res = mod.run_enhanced_evaluation(**kw, output_dir=str(tmp_path / name))
        out.append({"results": res,
                    "json": json.loads((tmp_path / name / "evaluation_results.json").read_text()),
                    "report": (tmp_path / name / "evaluation_report.txt").read_text(),
                    "no_conf": mod.run_enhanced_evaluation(y_true=labels, y_pred=preds)})
    return out


def _zero_shot():
    labels, preds, probs = predictions(n=60, seed=8)
    texts = ["the audio sample is good", "angry words and the fear", "plain neutral text",
             "happy dataset of words"] * 15

    def predict(translated):
        # a stand-in model: its answer depends on the rendered text
        h = np.array([sum(map(ord, t)) % 4 for t in translated])
        p = np.full((len(h), 4), 0.1)
        p[np.arange(len(h)), h] = 0.7
        return {"preds": h, "probs": p}

    out = []
    for mod in (tzs, jzs):
        out.append({"translated": [mod.translate_text(t, lang) for t in texts[:4]
                                   for lang in ("hi", "bn", "te")],
                    "tables": mod.TABLES,
                    "sweep": mod.evaluate_zero_shot(predict, texts, labels, probs.max(axis=1),
                                                    preds)})
    return out


def _flagship_and_students():
    jteacher = jcfg.ModelConfig()
    configs = [("flagship", jteacher)] + [
        (p, jdst.student_model_config(jteacher, p)) for p in jdst.STUDENT_PRESETS]
    return [(name, c, tcfg.from_json(json.dumps(dataclasses.asdict(c)))) for name, c in configs]


def _benchmark():
    per_batch = {b: {"samples_per_sec": s} for b, s in ((1, 20.0), (4, 70.0), (8, 120.0),
                                                        (16, 150.0))}
    result = {"per_batch_size": {b: {"latency_mean_ms": 10.0 * b, "latency_p50_ms": 9.0 * b,
                                     "latency_p95_ms": 12.0 * b, "latency_p99_ms": 13.0 * b,
                                     "samples_per_sec": v["samples_per_sec"]}
                                 for b, v in per_batch.items()}}
    out = []
    for mod in (tbench, jbench):
        flops = {(name, s): mod.model_gflops_per_utt(pc if mod is tbench else jc,
                                                     audio_seconds=s, text_tokens=32)
                 for name, jc, pc in _flagship_and_students() for s in (4.0, 7.5)}
        result["scaling"] = mod.scaling_efficiency(per_batch)
        out.append({"flops": flops, "scaling": mod.scaling_efficiency(per_batch),
                    "empty": mod.scaling_efficiency({}),
                    "report": mod.benchmark_report(
                        result, {"total_params": 123456, "model_size_mb": 0.49})})
    return out


CASES = {"calibration": _calibration, "openset": _openset, "slicing": _slicing,
         "wer": _wer, "cascade": _cascade, "zero_shot": _zero_shot,
         "benchmark": _benchmark}


@pytest.mark.parametrize("module", sorted(CASES))
def test_pure_module_matches_jax(module):
    got, want = CASES[module]()
    assert_same(got, want)


def test_enhanced_pipeline_matches_jax(tmp_path):
    got, want = _enhanced_pipeline(tmp_path)
    assert_same(got, want)


@pytest.mark.parametrize("B,T,seed", [(2, 16000, 5), (4, 64000, 4), (3, 12345, 0)])
def test_worst_case_dsp_audio_bitwise(B, T, seed):
    got = tbench.worst_case_dsp_audio(np.random.default_rng(seed), B, T)
    want = jbench.worst_case_dsp_audio(np.random.default_rng(seed), B, T)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _old_chip_smoke_worst_case(B, T, seed):
    """The copy chip_smoke.py carried before it called the port's
    function, kept here to hold the script's inputs unchanged."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000
    edge = max(1, int(0.12 * T))
    env = np.minimum(1.0, np.minimum(np.arange(T), np.arange(T)[::-1]) / edge)
    am = 1.0 + 0.6 * np.sin(2 * np.pi * 3.0 * t)
    hum_clip = (0.3 * np.sin(2 * np.pi * 50.0 * t) + 0.3 * np.sin(2 * np.pi * 130.0 * t)
                + 0.12 * np.sin(2 * np.pi * 220.0 * t) * am)
    noisy_clip = 0.35 * am * np.sign(np.sin(2 * np.pi * 370.0 * t))
    x = np.where((np.arange(B) % 2 == 0)[:, None], hum_clip[None, :], noisy_clip[None, :]) \
        + 0.02 * rng.standard_normal((B, T))
    return np.clip(x * env[None, :], -1.0, 1.0).astype(np.float32)


# (B, T, seed) of every chip_smoke.py call: 4b's rows, 5a'/8b/9b's forwards,
# 7b's exported-program batch at the first serving bucket
@pytest.mark.parametrize("B,T,seed", [(2, 16000, 5), (4, 64000, 4), (32, 64000, 7),
                                      (32, 64000, 32), (128, 64000, 128)])
def test_chip_smoke_worst_case_audio_unchanged(B, T, seed):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    np.testing.assert_array_equal(chip_smoke.worst_case_dsp_audio(B, T, seed),
                                  _old_chip_smoke_worst_case(B, T, seed))


def test_count_params_matches_jax():
    jc = tiny_config()
    jp = jm.init_model(jax.random.key(0), jc)
    tp = bridge(jp, tm.init_model(tcfg.from_json(json.dumps(dataclasses.asdict(jc))),
                                  device="meta"))
    got = tbench.count_params(tp)
    assert got == jbench.count_params(jp)
    assert got["total_params"] > 0


def _repo_fit_cascade():
    spec = importlib.util.spec_from_file_location("repo_fit_cascade",
                                                  REPO / "cli" / "fit_cascade.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("flags", [
    ["--escalation_budget", "0.15"],
    ["--min_accuracy", "0.9", "--energy_quantile", "0.99"],
    ["--escalation_budget", "0.1", "--min_accuracy", "0.99", "--no_teacher"]])
def test_fit_cascade_cli_matches_repo_cli(tmp_path, monkeypatch, capsys, flags):
    files = {}
    for name, seed in (("student", 5), ("teacher", 6)):
        files[name] = tmp_path / f"{name}.jsonl"
        files[name].write_text("".join(json.dumps(r) + "\n" for r in _prediction_rows(seed)))
    args = ["--student_predictions", str(files["student"])]
    if "--no_teacher" not in flags:
        args += ["--teacher_predictions", str(files["teacher"])]
    args += [f for f in flags if f != "--no_teacher"]
    fit = fit_cli.main(args + ["--out", str(tmp_path / "port.json")])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["fit_cascade.py", *args, "--out",
                                      str(tmp_path / "repo.json")])
    _repo_fit_cascade().main()
    repo_out = capsys.readouterr().out
    port_json = json.loads((tmp_path / "port.json").read_text())
    assert port_json == json.loads((tmp_path / "repo.json").read_text()) == fit
    # the printed fit is the same; only the serve command names the port's CLI
    assert port_out.split("\nserve with:")[0] == repo_out.split("\nserve with:")[0]
    assert "cli.serve --artifact" in port_out and "--confidence_threshold" in port_out


def test_fit_cascade_cli_needs_a_target(tmp_path):
    with pytest.raises(SystemExit):
        fit_cli.main(["--student_predictions", str(tmp_path / "s.jsonl")])

"""The port's manifest evaluation (eval/evaluate.py, train/checkpoint.py,
cli/eval.py, scripts/torch_import_jax_checkpoint.py) against the JAX
package's on the CPU, on one tiny model with the front-end DSP on and one
synthetic manifest of tones written here.

Tolerances: logits f32 within 1e-4 (summation order only) and bf16 within
3e-2 (the JAX package's bf16 bound; the frameworks round bf16 at other
places). The TTA step's noise views take JAX's own draws. Where every
clip's JAX top-2 margin exceeds 10x the tolerance, predictions and metrics
must be equal. The JAX TTA step runs with its speed views' lengths as its
eager code computes them (`exact_speed_perturb_length`): jitted, it keeps
one sample more at some lengths (ROADMAP Queue C)."""

import dataclasses
import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import config as jcfg
from multilingual_multimodal_speech_emotion_recognition_tpu.data import (
    audio_io as jaio, manifest as jman, tokenizer as jtok)
from multilingual_multimodal_speech_emotion_recognition_tpu.eval import evaluate as jev
from multilingual_multimodal_speech_emotion_recognition_tpu.models import model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu.ops import audio_dsp as jdsp
from multilingual_multimodal_speech_emotion_recognition_tpu.parallel import mesh as jmesh
from multilingual_multimodal_speech_emotion_recognition_tpu.train import (
    checkpoint as jckpt, train_step as jts)
from multilingual_multimodal_speech_emotion_recognition_tpu.utils import metrics as jmetrics
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
    config as tcfg, weights)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli import eval as tcli
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
    pipeline as tpipe, tokenizer as ttok)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import evaluate as tev
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import quant as tquant
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
    checkpoint as tckpt)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import (
    metrics as tmetrics)

from test_model import tiny_config
from test_torch_audio_dsp import exact_speed_perturb_length
from torch_port_helpers import assert_close, perturb
from torch_port_helpers import offline_hub  # noqa: F401  (a fixture)
from torch_port_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parents[1]
SR = 16000
N_CLIPS = 16
BATCH = 8
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
FREQS = [250.0, 500.0, 1000.0, 2000.0]
TEXTS = ["angry shouting words", "happy cheerful words", "sad crying words",
         "neutral plain words"]
MODES = {"plain": {}, "tta3": {"use_tta": True, "num_tta": 3},
         "calibrated": {"calibrate": True}}


@pytest.fixture(scope="module", autouse=True)
def jax_speed_lengths_as_eager():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdsp, "speed_perturb_length", exact_speed_perturb_length)
        yield


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """16 tones of 0.6-1.0 s (one 1 s bucket, two batches of 8), the
    speech-band tone of each class over a little noise."""
    root = tmp_path_factory.mktemp("eval")
    wavdir = root / "datasets" / "synth"
    wavdir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    items = []
    for i in range(N_CLIPS):
        label = i % 4
        L = int(SR * (0.6 + 0.025 * i))
        x = 0.5 * np.sin(2 * np.pi * FREQS[label] * np.arange(L) / SR)
        x += 0.05 * rng.standard_normal(L)
        jaio.write_wav(wavdir / f"s{i:03d}.wav", x.astype(np.float32), SR)
        items.append({"audio": f"synth/s{i:03d}.wav", "text": TEXTS[label],
                      "label": label, "dataset": "synth"})
    jman.write_manifest(root / "m.jsonl", items)
    return root


def jax_config(root, dtype="float32"):
    return jcfg.Config(model=tiny_config(compute_dtype=dtype, frontend_dsp=True),
                       data=jcfg.DataConfig(audio_buckets=(1.0,), max_text_tokens=12,
                                            dataset_root=str(root / "datasets")))


def port_config(jc):
    return tcfg.config_from_json(jcfg.to_json(jc))


@pytest.fixture(scope="module")
def jax_params():
    """The JAX init with its classifier perturbed, so that the logits of
    the random model spread out."""
    params = jax.tree.map(np.asarray, jm.init_model(jax.random.key(0), tiny_config(
        frontend_dsp=True)))
    params["classifier"] = perturb(params["classifier"], np.random.default_rng(1), 0.5)
    return params


@pytest.fixture(scope="module")
def jax_results(synth, jax_params):
    jc = jax_config(synth)
    manifest = str(synth / "m.jsonl")
    out = {}
    for name, kw in MODES.items():
        if kw.get("calibrate"):
            kw = {**kw, "val_manifest": manifest}
        out[name] = jev.evaluate_manifest(
            jax_params, jc, manifest, batch_size=BATCH, tokenizer=jtok.HashTokenizer(100),
            mesh=jmesh.make_mesh(), verbose=False, **kw)
    return out


def port_params(jax_params, jc):
    return weights.params_from_jax(jax_params, port_config(jc).model, device="cpu")


def assert_results_match(got, want, tol):
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["indices"], want["indices"])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=tol, atol=tol)
    np.testing.assert_allclose(got["energies"], want["energies"], rtol=1e-5, atol=tol)
    assert got["temperature"] == want["temperature"]
    top2 = np.sort(want["logits"], axis=1)[:, -2:]
    decisive = top2[:, 1] - top2[:, 0] > 10 * tol
    np.testing.assert_array_equal(got["preds"][decisive], want["preds"][decisive])
    assert decisive.all(), "the synthetic data leaves a clip's top-2 logits too close"
    for key in ("weighted_f1", "accuracy", "uar", "confusion_matrix", "per_class_accuracy"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", list(MODES))
def test_evaluate_manifest_matches_jax(synth, jax_params, jax_results, mode):
    jc = jax_config(synth)
    manifest = str(synth / "m.jsonl")
    kw = dict(MODES[mode])
    if kw.get("calibrate"):
        kw["val_manifest"] = manifest
    got = tev.evaluate_manifest(port_params(jax_params, jc), port_config(jc), manifest,
                                batch_size=BATCH, tokenizer=ttok.HashTokenizer(100),
                                verbose=False, device="cpu", **kw)
    assert_results_match(got, jax_results[mode], TOL["float32"])
    assert len(got["step_seconds"]) == N_CLIPS // BATCH
    assert len(got["calibration_step_seconds"]) == (N_CLIPS // BATCH if mode == "calibrated"
                                                    else 0)
    assert got["decoder"] in ("native", "python")
    if mode == "calibrated":
        assert got["temperature"] != 1.0
        # the temperature scales the softmax only: logits and energies stay raw
        np.testing.assert_allclose(got["logits"], jax_results["plain"]["logits"],
                                   rtol=TOL["float32"], atol=TOL["float32"])


def loader_batch(root):
    """The first batch of the manifest as the port's loader makes it, less
    the host keys: audio, masks, token ids and the LID scalars."""
    loader = tpipe.BucketedLoader(tpipe.SERDataset(str(root / "m.jsonl"),
                                                   port_config(jax_config(root)).data),
                                  batch_size=BATCH, tokenizer=ttok.HashTokenizer(100),
                                  shuffle=False)
    batch = next(iter(loader.epoch(0)))
    return {k: v for k, v in batch.items() if k not in tpipe.EVAL_HOST_KEYS}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tta_step_matches_jax_on_its_draws(synth, jax_params, dtype):
    jc = jax_config(synth, dtype)
    batch = loader_batch(synth)
    key = jax.random.key(11)
    want = jev.make_tta_eval_step(jc, 5, use_openmax=True)(
        jax_params, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    k1, k2 = jax.random.split(key)
    draws = [np.asarray(jax.random.normal(k, batch["audio"].shape, jnp.float32))
             for k in (k1, k2)]
    step = tev.make_tta_eval_step(port_config(jc), 5, use_openmax=True, device="cpu")
    got = step(port_params(jax_params, jc), batch, noise=draws)
    assert tuple(got.shape) == (BATCH, 4)
    assert_close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_step_matches_jax(synth, jax_params, dtype):
    jc = jax_config(synth, dtype)
    batch = loader_batch(synth)
    want = jts.make_eval_step(jc.model, use_openmax=True)(
        jax_params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tev.make_eval_step(port_config(jc).model, use_openmax=True, device="cpu")(
        port_params(jax_params, jc), batch)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert_close(g, w, TOL[dtype])


def test_steps_run_on_the_card_unless_told(synth, jax_params):
    jc = jax_config(synth)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tev.make_tta_eval_step(port_config(jc))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tev.make_eval_step(port_config(jc).model)
    params = port_params(jax_params, jc)
    step = tev.make_eval_step(port_config(jc).model, device="meta")
    with pytest.raises(ValueError, match="the step runs on meta"):
        step(params, loader_batch(synth))
    with pytest.raises(ValueError, match="num_tta"):
        tev.make_tta_eval_step(port_config(jc), 6, device="cpu")


def test_temperature_search_and_metrics_match_jax():
    rng = np.random.default_rng(2)
    logits = 3 * rng.standard_normal((200, 4))
    labels = rng.integers(0, 4, 200)
    assert tev.find_optimal_temperature(logits, labels) == jev.find_optimal_temperature(
        logits, labels)
    preds = np.where(rng.random(200) < 0.6, labels, rng.integers(0, 4, 200))
    for fn in ("weighted_f1", "macro_f1", "unweighted_average_recall"):
        assert getattr(tmetrics, fn)(preds, labels, 4) == getattr(jmetrics, fn)(preds, labels, 4)
    assert tmetrics.accuracy(preds, labels) == jmetrics.accuracy(preds, labels)
    np.testing.assert_array_equal(tmetrics.confusion_matrix(labels, preds, 4),
                                  jmetrics.confusion_matrix(labels, preds, 4))
    names = tev.SIX_NAMES[:4]
    assert (tmetrics.classification_report(labels, preds, names)
            == jmetrics.classification_report(labels, preds, names))


def test_write_predictions_jsonl_joins_back_by_index(synth, jax_params, tmp_path):
    jc = jax_config(synth)
    manifest = str(synth / "m.jsonl")
    res = tev.evaluate_manifest(port_params(jax_params, jc), port_config(jc), manifest,
                                batch_size=5, tokenizer=ttok.HashTokenizer(100),
                                verbose=False, device="cpu")
    out = tmp_path / "preds.jsonl"
    assert tev.write_predictions_jsonl(res, manifest, str(out)) == N_CLIPS
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    items = jman.read_manifest(manifest)
    assert sorted(r["index"] for r in rows) == list(range(N_CLIPS))
    for r, pred, probs in zip(rows, res["preds"], res["probs"]):
        assert r["audio"] == items[r["index"]]["audio"]
        assert r["label"] == items[r["index"]]["label"]
        assert r["prediction"] == pred and r["correct"] == (pred == r["label"])
        assert abs(sum(r["probabilities"].values()) - 1.0) < 1e-4
        assert r["confidence"] == round(float(probs.max()), 6)
    assert np.mean([r["correct"] for r in rows]) == pytest.approx(res["accuracy"])


def test_checkpoint_round_trip_is_bitwise(synth, jax_params, tmp_path):
    jc = jax_config(synth)
    params = port_params(jax_params, jc)
    params["extra_bf16"] = {"w": torch.randn(3, 5).to(torch.bfloat16)}
    path = tckpt.save_checkpoint(tmp_path / "ck", params=params, epoch=4, f1=0.25,
                                 config_json=jcfg.to_json(jc), extra={"note": "x"})
    got, meta = tckpt.restore_checkpoint(path, device="cpu")
    assert meta == {"step": 0, "epoch": 4, "f1": 0.25, "note": "x"}
    assert tcfg.config_from_json(tckpt.load_config_json(path)) == port_config(jc)

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, prefix + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, prefix + (i,))
        else:
            yield prefix, tree

    want = dict(leaves(params))
    have = dict(leaves(got))
    assert want.keys() == have.keys()
    for k, v in want.items():
        assert have[k].dtype == v.dtype and torch.equal(have[k], v), k
    tckpt.save_checkpoint(tmp_path / "better", params={"x": torch.zeros(1)}, f1=0.5)
    assert tckpt.best_checkpoint(tmp_path) == tmp_path / "better"


def save_port_checkpoint(jax_params, jc, path):
    return tckpt.save_checkpoint(path, params=port_params(jax_params, jc),
                                 config_json=jcfg.to_json(jc))


def test_cli_scores_a_manifest_on_the_cpu(synth, jax_params, jax_results, tmp_path):
    jc = jax_config(synth)
    ck = save_port_checkpoint(jax_params, jc, tmp_path / "ck")
    manifest = str(synth / "m.jsonl")
    preds = tmp_path / "preds.jsonl"
    res = tcli.main(["--manifest", manifest, "--checkpoint", str(ck), "--device", "cpu",
                     "--calibrate", "--val_manifest", manifest, "--save_temperature",
                     "--predictions_out", str(preds)])
    assert_results_match(res, jax_results["calibrated"], TOL["float32"])
    assert len(preds.read_text().splitlines()) == N_CLIPS
    cal = json.loads((ck / "calibration.json").read_text())
    assert cal == {"temperature": jax_results["calibrated"]["temperature"],
                   "fitted_on": manifest}


@pytest.mark.parametrize("flags,message", [
    (["--save_temperature", "--calibrate", "--device", "cpu"], "requires --calibrate"),
    (["--use_tta", "--num_tta", "7", "--device", "cpu"], "num_tta"),
])
def test_cli_refuses_before_the_run(synth, flags, message):
    with pytest.raises(SystemExit, match=message):
        tcli.main(["--manifest", str(synth / "m.jsonl"), "--checkpoint", "nowhere", *flags])


@pytest.mark.parametrize("flag", ["--use_asr", "--int8"])
def test_cli_use_asr_and_int8_score_on_the_cpu(synth, jax_params, jax_results, tmp_path,
                                               monkeypatch, offline_hub, flag):
    """--use_asr scores through the text encoder's ASR fusion on the
    loader's features (from the manifest text: no backend is asked);
    --int8 with the backbones quantised (here at min_size 16, so that these
    widths have int8 kernels). Each equals evaluate_manifest on the config
    or the parameters the flag stands for; the ASR fusion moves the
    logits, and the int8 linears run."""
    jc = jax_config(synth)
    ck = save_port_checkpoint(jax_params, jc, tmp_path / "ck")
    manifest = str(synth / "m.jsonl")
    cfg, params = port_config(jc), port_params(jax_params, jc)
    if flag == "--use_asr":
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, use_asr=True),
            data=dataclasses.replace(cfg.data, emit_asr_feats=True))
    else:
        quantize = tquant.quantize_backbones
        monkeypatch.setattr(tquant, "quantize_backbones",
                            lambda p, **kw: quantize(p, min_size=16))
        params = tquant.quantize_backbones(params)
    products, plain = [], tquant.int8_matmul_plain
    monkeypatch.setattr(tquant, "int8_matmul_plain",
                        lambda xq, kq: products.append(xq.shape) or plain(xq, kq))
    got = tcli.main(["--manifest", manifest, "--checkpoint", str(ck), "--device", "cpu", flag])
    assert bool(products) == (flag == "--int8")
    want = tev.evaluate_manifest(params, cfg, manifest, batch_size=BATCH, device="cpu")
    np.testing.assert_array_equal(got["logits"], want["logits"])
    if flag == "--use_asr":
        assert np.abs(got["logits"] - jax_results["plain"]["logits"]).max() > 10 * TOL["float32"]


def test_cli_without_a_card_exits_non_zero(synth, jax_params, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")  # decided at run time
    ck = save_port_checkpoint(jax_params, jax_config(synth), tmp_path / "ck")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    proc = subprocess.run(
        [sys.executable, "-m", "multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.eval",
         "--manifest", str(synth / "m.jsonl"), "--checkpoint", str(ck)],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env, check=False)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--device cpu" in proc.stderr
    assert "EVALUATION RESULTS" not in proc.stdout


def test_converted_jax_checkpoint_scores_like_jax(synth, jax_params, jax_results, tmp_path):
    jc = jax_config(synth)
    jckpt.save_checkpoint(tmp_path / "jax", params=jax_params, epoch=7, f1=0.5,
                          config_json=jcfg.to_json(jc))
    script = runpy.run_path(str(REPO / "scripts" / "torch_import_jax_checkpoint.py"))
    assert script["main"]([str(tmp_path / "jax"), str(tmp_path / "port")]) == 0
    params, meta = tckpt.restore_checkpoint(tmp_path / "port", device="cpu")
    assert meta["epoch"] == 7 and meta["f1"] == 0.5
    cfg = tcfg.config_from_json(tckpt.load_config_json(tmp_path / "port"))
    assert cfg == port_config(jc)
    got = tev.evaluate_manifest(params, cfg, str(synth / "m.jsonl"), batch_size=BATCH,
                                tokenizer=ttok.HashTokenizer(100), verbose=False,
                                device="cpu")
    np.testing.assert_allclose(got["logits"], jax_results["plain"]["logits"],
                               rtol=1e-4, atol=1e-4)

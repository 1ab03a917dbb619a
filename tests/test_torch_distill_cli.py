"""The port's `distill` end to end and the CLIs of the evaluation slice
(distill, academic_eval) on the CPU, on tests/test_distill.py's clips: the
history, a best checkpoint with the student's whole Config and no
distill_proj, which the port's eval CLI scores; each CLI on `--device
cpu`, and without it, where there is no card, a non-zero exit."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli import (
    academic_eval as acad_cli, distill as distill_cli, eval as eval_cli)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
    audio_io, manifest)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import model as tm
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
    checkpoint as ckpt, distill as tdst)

from test_model import tiny_config
from test_torch_train_step import port_config
from torch_port_helpers import one_torch_thread

SR = 16000
TEXTS = ["angry shouting words", "happy cheerful words", "sad crying words",
         "neutral plain words"]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """tests/test_distill.py's clips: 32 train and 8 validation rows of 0.6-0.75 s."""
    root = tmp_path_factory.mktemp("torch_distill")
    wavdir = root / "datasets" / "synth"
    wavdir.mkdir(parents=True)
    rng = np.random.default_rng(3)
    items = []
    for i in range(40):
        label = i % 4
        L = int(SR * (0.6 + 0.05 * (i % 4)))
        t = np.arange(L) / SR
        x = 0.5 * np.sin(2 * np.pi * [250.0, 500.0, 1000.0, 2000.0][label] * t)
        x += 0.01 * rng.standard_normal(L)
        audio_io.write_wav(wavdir / f"d{i:03d}.wav", x.astype(np.float32), SR)
        items.append({"audio": f"synth/d{i:03d}.wav", "text": TEXTS[label], "label": label,
                      "dataset": "synth"})
    manifest.write_manifest(root / "train.jsonl", items[:32])
    manifest.write_manifest(root / "val.jsonl", items[32:])
    cfg = tcfg.Config(model=port_config(tiny_config()),
                      data=tcfg.DataConfig(audio_buckets=(1.0,), max_text_tokens=12,
                                           dataset_root=str(root / "datasets")),
                      train=tcfg.TrainConfig(batch_size=8, seed=0))
    teacher = tm.init_model(cfg.model, torch.Generator().manual_seed(0), device="cpu")
    ckpt.save_checkpoint(root / "teacher", params=teacher, config_json=tcfg.to_json(cfg))
    return root, cfg, teacher


def test_distill_end_to_end(synth, tmp_path):
    """Two epochs at the tiny preset with feature matching: the history, a
    best checkpoint with the student's whole Config and no distill_proj,
    which the port's eval CLI scores."""
    root, cfg, teacher = synth
    train = dataclasses.replace(cfg.train, epochs=2, lr=1e-2, save_dir=str(tmp_path / "s"))
    out = tdst.distill(teacher, cfg, train_manifest=str(root / "train.jsonl"),
                       val_manifest=str(root / "val.jsonl"),
                       dcfg=tdst.DistillConfig(temperature=2.0, alpha=0.8,
                                               feature_match_weight=0.1, student_preset="tiny"),
                       train_cfg=train, progress=False, device="cpu")
    hist = out["history"]
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(set(h) == {"epoch", "val_f1", "epoch_seconds", "loss", "kd", "ce",
                          "feature_match", "teacher_agreement", "accuracy"} for h in hist)
    assert all(np.isfinite(h["loss"]) and h["feature_match"] > 0 for h in hist)
    assert set(out) == {"params", "config", "history", "best_f1", "best_path"}   # JAX's keys
    assert "distill_proj" in out["params"]
    lines = (tmp_path / "s" / "distill_metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["epoch"] for line in lines] == [0, 1]
    params, meta = ckpt.restore_checkpoint(out["best_path"], device="cpu")
    assert "distill_proj" not in params
    assert meta["f1"] == pytest.approx(out["best_f1"])
    saved = json.loads(ckpt.load_config_json(out["best_path"]))
    assert saved == json.loads(tcfg.to_json(out["config"]))
    assert saved["model"]["audio"]["hidden_size"] == 64
    assert saved["model"]["classifier_layers"] == 3 and saved["train"]["epochs"] == 2
    res = eval_cli.main(["--manifest", str(root / "val.jsonl"), "--checkpoint",
                         out["best_path"], "--device", "cpu", "--batch_size", "8"])
    assert res["logits"].shape == (8, 4) and np.isfinite(res["logits"]).all()


def test_distill_cli_on_the_cpu(synth, tmp_path):
    root, _, _ = synth
    out = distill_cli.main(["--teacher_checkpoint", str(root / "teacher"),
                            "--train_manifest", str(root / "train.jsonl"),
                            "--val_manifest", str(root / "val.jsonl"),
                            "--student_preset", "tiny", "--epochs", "1", "--batch_size", "8",
                            "--save_dir", str(tmp_path / "s"), "--device", "cpu"])
    assert len(out["history"]) == 1
    assert (tmp_path / "s" / "student_epoch_0" / ckpt.PARAMS_FILE).exists()
    with pytest.raises(SystemExit):
        distill_cli.parse_args(["--teacher_checkpoint", "t", "--train_manifest", "a",
                                "--val_manifest", "b", "--prng_impl", "rbg"])


def test_academic_eval_cli_on_the_cpu(synth, tmp_path):
    root, _, _ = synth
    res = acad_cli.main(["--checkpoint", str(root / "teacher"), "--manifest",
                         str(root / "val.jsonl"), "--output_dir", str(tmp_path / "out"),
                         "--no_benchmark", "--no_robustness", "--few_shot_shots", "4",
                         "--few_shot_epochs", "1", "--open_set_unknown_class", "sad",
                         "--device", "cpu"])
    assert res["open_set"]["unknown_class"] == 2
    data = json.loads((tmp_path / "out" / "academic_evaluation.json").read_text())
    assert "inference_benchmark" not in data and "robustness" not in data
    assert [r["num_shots"] for r in data["few_shot"]] == [4]
    for bad in ("7", "surprise"):
        with pytest.raises(SystemExit):
            acad_cli.unknown_class_index(bad, 4)


@pytest.mark.parametrize("cli", ["academic_eval", "distill"])
def test_clis_exit_without_a_card(synth, tmp_path, cli):
    """Without --device cpu the CLIs ask for the card and exit non-zero."""
    if torch.cuda.is_available():
        pytest.skip("checks the run without a card")
    root, _, _ = synth
    argv = {"academic_eval": (acad_cli, ["--checkpoint", str(root / "teacher"),
                                         "--manifest", str(root / "val.jsonl")]),
            "distill": (distill_cli, ["--teacher_checkpoint", str(root / "teacher"),
                                      "--train_manifest", str(root / "train.jsonl"),
                                      "--val_manifest", str(root / "val.jsonl")])}
    module, args = argv[cli]
    with pytest.raises(SystemExit) as exc:
        module.main(args)
    assert exc.value.code not in (0, None)
    assert "--device cpu" in str(exc.value.code)

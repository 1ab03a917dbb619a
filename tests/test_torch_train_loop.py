"""The port's train loop, checkpoints and train CLI (train/loop.py,
train/checkpoint.py, cli/train.py) on the CPU, on a tiny model and WAV
clips written here: checkpoint names and the frozen store, the Weibull fit,
resume, preemption, two phases, and the CLI's Config against the repo's
JAX CLI for each preset. phase2_grad_accum is held against the JAX
package's over a grid."""

import dataclasses
import json
import os
import runpy
import signal
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import config as jcfg
from multilingual_multimodal_speech_emotion_recognition_tpu.train import loop as jloop
from multilingual_multimodal_speech_emotion_recognition_tpu.utils import runtime as jruntime
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli import (
    eval as teval_cli, train as tcli)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
    audio_io, manifest as tman)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data.pipeline import (
    BucketedLoader, SERDataset)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data.tokenizer import (
    get_tokenizer)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import model as tm
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import openmax as tom
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
    checkpoint as tckpt, loop as tloop, optimizer as topt)

from test_model import tiny_config
from torch_port_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parents[1]
SR = 16000
N_CLIPS = 12
TEXTS = ["angry shouting words", "happy cheerful words", "sad crying words",
         "neutral plain words"]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """12 tones of 0.6-1.0 s (one 1 s bucket), the class's tone over a
    little noise; the manifest's path."""
    root = tmp_path_factory.mktemp("train")
    wavdir = root / "datasets" / "synth"
    wavdir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    items = []
    for i in range(N_CLIPS):
        label = i % 4
        n = int(SR * (0.6 + 0.4 * i / (N_CLIPS - 1)))
        t = np.arange(n) / SR
        x = 0.4 * np.sin(2 * np.pi * 250.0 * (label + 1) * t) + 0.01 * rng.standard_normal(n)
        audio_io.write_wav(wavdir / f"c{i:02d}.wav", x.astype(np.float32), SR)
        items.append({"audio": f"synth/c{i:02d}.wav", "text": TEXTS[label], "label": label})
    path = root / "manifest.jsonl"
    tman.write_manifest(path, items)
    return root, str(path)


def port_model():
    cfg = tiny_config(frontend_dsp=True)
    return tcfg.from_json(json.dumps(dataclasses.asdict(cfg)))


def config(clips, save_dir, **train):
    root, _ = clips
    return tcfg.Config(
        model=port_model(),
        data=tcfg.DataConfig(audio_buckets=(1.0,), max_text_tokens=12,
                             dataset_root=str(root / "datasets")),
        train=tcfg.TrainConfig(**{"epochs": 2, "batch_size": 4, "augment": True,
                                  "save_dir": str(save_dir), **train}))


def run(cfg, clips, **kw):
    _, manifest = clips
    return tloop.train(cfg, train_manifest=manifest, val_manifest=manifest,
                       tokenizer=get_tokenizer(vocab_size=cfg.model.text.vocab_size),
                       progress=False, device="cpu", **kw)


def leaves(tree):
    return dict(topt.leaves_with_paths(tree))


@pytest.fixture(scope="module")
def straight(clips, tmp_path_factory):
    """Two epochs, frozen backbones, augmentation and dropout on; the
    number of times the frozen store's weights were written."""
    save_dir = tmp_path_factory.mktemp("straight")
    writes = []
    real_save = torch.save

    def counting_save(obj, f, *a, **k):
        if "frozen_store" in str(f):
            writes.append(str(f))
        return real_save(obj, f, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tckpt.torch, "save", counting_save)
        result = run(config(clips, save_dir), clips)
    return save_dir, result, writes


def test_train_writes_epoch_checkpoints_with_one_frozen_store(straight):
    save_dir, result, writes = straight
    names = sorted(p.name for p in save_dir.iterdir())
    history = result["history"]
    assert [h["epoch"] for h in history] == [0, 1] and not result["preempted"]
    want = [f"epoch_{h['epoch']}_f1_{h['val_f1']:.4f}" for h in history]
    assert names == sorted(want + ["frozen_store", "metrics.jsonl"])
    assert writes == [str(save_dir / "frozen_store" / tckpt.PARAMS_FILE)]
    done = json.loads((save_dir / "frozen_store" / "DONE").read_text())
    params0, meta0 = tckpt.restore_checkpoint(save_dir / want[0], device="cpu")
    assert meta0["epoch"] == 0 and meta0["step"] == 3
    assert done["fingerprint"] == tckpt.frozen_fingerprint(
        {k: params0[k] for k in tckpt.FROZEN_SUBTREES})
    for name in want:
        ref = json.loads((save_dir / name / tckpt.FROZEN_REF).read_text())
        assert ref == {"store": os.path.join("..", "frozen_store"),
                       "keys": sorted(tckpt.FROZEN_SUBTREES)}
        stored = torch.load(save_dir / name / tckpt.PARAMS_FILE, weights_only=True)
        assert not set(stored) & set(tckpt.FROZEN_SUBTREES)
        opt_state = tckpt.restore_opt_state(save_dir / name, device="cpu")
        assert not any(p.startswith(tckpt.FROZEN_SUBTREES) for p in opt_state["mu"])
    # the backbones stayed where the seed put them
    init = tm.init_model(port_model(), torch.Generator().manual_seed(0), "cpu")
    final = leaves(result["params"])
    for path, t in leaves({k: init[k] for k in tckpt.FROZEN_SUBTREES}).items():
        assert torch.equal(final[path], t), path
    records = [json.loads(x) for x in (save_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in records] == ["epoch", "epoch"]


def test_weibull_fit_is_fit_weibull_on_evaluate_features(straight, clips):
    save_dir, result, _ = straight
    cfg = config(clips, save_dir)
    loader = BucketedLoader(SERDataset(clips[1], cfg.data), batch_size=4,
                            tokenizer=get_tokenizer(vocab_size=cfg.model.text.vocab_size),
                            shuffle=False)
    ev = tloop.evaluate(result["params"], cfg, loader, collect_features=True, device="cpu")
    assert ev["features"].shape == (N_CLIPS, cfg.model.classifier_base_dim // 2)
    want = tom.fit_weibull(torch.from_numpy(ev["features"]), torch.from_numpy(ev["labels"]),
                           cfg.model.num_labels)
    for k, v in want.items():
        torch.testing.assert_close(result["params"]["classifier"]["weibull"][k], v,
                                   rtol=0, atol=0)
    assert (want["alpha"] == 2.5).all()
    last = save_dir / f"epoch_1_f1_{result['history'][1]['val_f1']:.4f}"
    saved, _ = tckpt.restore_checkpoint(last, device="cpu")
    for k, v in want.items():
        assert torch.equal(saved["classifier"]["weibull"][k], v), k
    # the port's eval CLI scores the deduplicated checkpoint as written
    res = teval_cli.main(["--manifest", clips[1], "--checkpoint", str(last), "--device", "cpu",
                          "--batch_size", "4"])
    assert res["logits"].shape == (N_CLIPS, cfg.model.num_labels)
    assert np.isfinite(res["logits"]).all()


def test_resume_after_epoch_zero_equals_two_straight_epochs(straight, clips, tmp_path):
    save_dir, result, _ = straight
    epoch0 = next(save_dir.glob("epoch_0_*"))
    resumed = run(config(clips, tmp_path, resume_from=str(epoch0)), clips)
    assert [h["epoch"] for h in resumed["history"]] == [1]
    assert resumed["history"][0]["train_loss"] == result["history"][1]["train_loss"]
    got, want = leaves(resumed["params"]), leaves(result["params"])
    assert set(got) == set(want)
    for path, t in want.items():
        assert torch.equal(got[path], t), path
    assert int(resumed["opt_state"]["count"]) == int(result["opt_state"]["count"]) == 6


def test_frozen_store_refuses_other_weights_and_migrates_a_legacy_marker(tmp_path):
    cfg = port_model()
    a = tm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    b = tm.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    store = tmp_path / "frozen_store"
    kw = dict(dedup_frozen=True, frozen_store=store)
    tckpt.save_checkpoint(tmp_path / "one", params=a, **kw)
    tckpt.save_checkpoint(tmp_path / "two", params=a, **kw)          # same weights: reused
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        tckpt.save_checkpoint(tmp_path / "three", params=b, **kw)
    fp = json.loads((store / "DONE").read_text())["fingerprint"]
    (store / "DONE").write_text("ok")                                # a legacy marker
    tckpt.save_checkpoint(tmp_path / "four", params=a, **kw)
    assert json.loads((store / "DONE").read_text()) == {"fingerprint": fp}
    (store / "DONE").write_text("ok")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        tckpt.save_checkpoint(tmp_path / "five", params=b, **kw)
    merged, _ = tckpt.restore_checkpoint(tmp_path / "two", device="cpu")
    for path, t in leaves(a).items():
        assert torch.equal(leaves(merged)[path], t), path


def test_preemption_writes_a_resumable_checkpoint(clips, tmp_path):
    with tloop.PreemptionGuard() as guard:          # SIGTERM only sets the flag
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.triggered
    guard = tloop.PreemptionGuard()
    guard.triggered = True                           # as if SIGTERM came during step 1
    cfg = config(clips, tmp_path / "run", augment=False)
    res = run(cfg, clips, guard=guard)
    assert res["preempted"] and res["checkpoint"].endswith("preempt_step_1")
    meta = json.loads((Path(res["checkpoint"]) / "meta.json").read_text())
    assert meta["epoch"] == -1 and meta["step"] == 1
    assert not list((tmp_path / "run").glob("epoch_*"))
    records = [json.loads(x) for x in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert records[-1]["kind"] == "preempt"
    again = run(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=1, resume_from=res["checkpoint"], save_dir=str(tmp_path / "again"))),
        clips)
    assert [h["epoch"] for h in again["history"]] == [0]
    assert int(again["opt_state"]["count"]) == 1 + 3


def test_train_two_phase_unfreezes_in_phase_two(clips, tmp_path):
    cfg = config(clips, tmp_path, augment=False, batch_size=4)
    _, manifest = clips
    res = tloop.train_two_phase(cfg, train_manifest=manifest, val_manifest=manifest,
                                phase1_epochs=1, phase2_epochs=1, progress=False, device="cpu",
                                tokenizer=get_tokenizer(vocab_size=cfg.model.text.vocab_size))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["phase1", "phase2"]
    assert (tmp_path / "phase1" / "frozen_store").exists()
    assert not (tmp_path / "phase2" / "frozen_store").exists()
    p1, p2 = leaves(res["phase1"]["params"]), leaves(res["phase2"]["params"])
    q = "audio_backbone/layers/q/kernel"
    init = leaves(tm.init_model(port_model(), torch.Generator().manual_seed(0), "cpu"))
    assert torch.equal(p1[q], init[q]) and not torch.equal(p2[q], p1[q])
    assert res["best_f1"] == max(res["phase1"]["best_f1"], res["phase2"]["best_f1"])
    assert any(p.startswith("audio_backbone") for p in res["phase2"]["opt_state"]["mu"])


def test_phase2_grad_accum_matches_jax():
    """Where grad_accum <= batch_size; above it the JAX package's loop never
    ends (no accumulation count above the batch divides it), and the port
    raises (ROADMAP Queue C)."""
    for batch in range(1, 301):
        for accum in (1, 2, 3, 5):
            for micro in (16, 64):
                if accum > batch:
                    with pytest.raises(ValueError, match="exceeds"):
                        tloop.phase2_grad_accum(batch, accum, micro)
                    continue
                assert (tloop.phase2_grad_accum(batch, accum, micro)
                        == jloop.phase2_grad_accum(batch, accum, micro)), (batch, accum, micro)


PRESET_ARGS = {
    "default": [],
    "crema_m3": ["--preset", "crema_m3"],
    "crema_final": ["--preset", "crema_final", "--grad_clip", "2.0"],
    "flags": ["--use_amp", "--augment", "--epochs", "3", "--batch_size", "16", "--lr", "3e-5",
              "--grad_accum", "2", "--backbone_moment_dtype", "bfloat16", "--seed", "7",
              "--supcon_weight", "0.1", "--no_quality_gates", "--early_stop_patience", "2",
              "--scheduler", "cosine_restarts", "--autotune_buckets", "2", "--two_phase",
              "--fsdp", "--fsdp_min_size", "4"],
    "use_asr": ["--use_asr"],
}


@pytest.mark.parametrize("preset", list(PRESET_ARGS))
def test_cli_builds_the_jax_cli_config(preset, clips, monkeypatch, tmp_path):
    root, manifest = clips
    args = ["--train_manifest", manifest, "--val_manifest", manifest, "--save_dir",
            str(tmp_path), "--dataset_root", str(root / "datasets")] + PRESET_ARGS[preset]
    captured = {}

    def capture(name):
        def fake(cfg, **kw):
            captured[name] = cfg
            return {"best_f1": 0.0}
        return fake

    jax_cli = runpy.run_path(str(REPO / "cli" / "train.py"), run_name="jax_cli")
    monkeypatch.setattr(jruntime, "configure", lambda **kw: None)
    monkeypatch.setattr(jloop, "train", capture("jax"))
    monkeypatch.setattr(jloop, "train_two_phase", capture("jax"))
    monkeypatch.setattr(sys, "argv", ["train.py"] + args)
    jax_cli["main"]()
    monkeypatch.setattr(tloop, "train", capture("port"))
    monkeypatch.setattr(tloop, "train_two_phase", capture("port"))
    tcli.main(args + ["--device", "cpu"])
    want = json.loads(jcfg.to_json(captured["jax"]))
    assert json.loads(tcfg.to_json(captured["port"])) == want


@pytest.mark.parametrize("flag,item", [
    (["--fsdp", "--mesh_model", "2"], "model 2 x dcn 1 needs that many ranks"),
    (["--mesh_model", "2"], "model 2 x dcn 1 needs that many ranks"),
    (["--num_processes", "2"], "--process_id / RANK, --coordinator_address"),
    (["--mesh_dcn", "2"], "model 1 x dcn 2 needs that many ranks"),
    (["--coordinator_address", "localhost:1"],
     "--process_id / RANK, --num_processes / WORLD_SIZE not given"),
    (["--fsdp_min_size", "4", "--process_id", "1"],
     "--num_processes / WORLD_SIZE, --coordinator_address")])
def test_cli_flags_of_unported_modules_exit_with_their_roadmap_item(flag, item):
    """The parallelism flags on one process with no torchrun environment: a
    mesh that needs more ranks (a 'model' or a dcn axis over 1), or a
    multi-process rendezvous missing a part, exits naming what it lacks;
    nothing falls back to one process.
    (--fsdp and --fsdp_min_size reach the Config as JAX's do:
    test_cli_builds_the_jax_cli_config.)"""
    with pytest.raises(SystemExit, match=item):
        tcli.main(flag + ["--device", "cpu"])


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.train(tcfg.Config(), train_manifest="x", val_manifest="x")

"""The port's serving CLIs on the CPU: cli/export.py writes artifacts from
a port checkpoint (buckets, autotuned buckets, the wire and DSP / OpenMax
flags, the calibration shipped), cli/serve.py serves them over HTTP in its
own process (the cascade flags, SIGTERM drains it), cli/infer.py scores a
clip and exports JSON; --int8 and a missing card exit non-zero."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import jax
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import config as jcfg
from multilingual_multimodal_speech_emotion_recognition_tpu.models import model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg, weights
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli import (
    export as export_cli, infer as infer_cli, serve as serve_cli)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
    audio_io, manifest)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.export import ServingModel
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import quant as tquant
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
    checkpoint as tckpt)

from test_model import tiny_config
from torch_port_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the server is on the loopback: no proxy
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))
REPO = Path(__file__).resolve().parents[1]
PKG = "multilingual_multimodal_speech_emotion_recognition_tpu_torch"
SR = 16000


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A port checkpoint of a tiny model (hash tokenizer's 100 words, 8
    tokens) with a calibration, and WAVs of 0.3-1.2 s in a manifest."""
    root = tmp_path_factory.mktemp("cli")
    jc = jcfg.Config(model=tiny_config(),
                     data=jcfg.DataConfig(max_text_tokens=8, dataset_root=str(root)))
    params = jax.tree.map(np.asarray, jm.init_model(jax.random.key(0), jc.model))
    cfg_json = jcfg.to_json(jc)
    ck = tckpt.save_checkpoint(root / "ck", params=weights.params_from_jax(
        params, tcfg.from_json(cfg_json), device="cpu"), config_json=cfg_json)
    (ck / "calibration.json").write_text(json.dumps({"temperature": 1.5}))
    rng = np.random.default_rng(0)
    items = []
    for i, seconds in enumerate((0.3, 0.35, 0.4, 0.9, 1.0, 1.2)):
        audio_io.write_wav(root / f"c{i}.wav",
                           (0.1 * rng.standard_normal(int(seconds * SR))).astype(np.float32),
                           SR)
        items.append({"audio": f"c{i}.wav", "text": "hello", "label": i % 4})
    manifest.write_manifest(root / "m.jsonl", items)
    return root, ck


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def get(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    with OPENER.open(urllib.request.Request(url, data=data), timeout=120) as r:
        return json.loads(r.read())


def test_export_serve_and_drain(checkpoint, tmp_path):
    root, ck = checkpoint
    art = export_cli.main(["--checkpoint", str(ck), "--out_dir", str(tmp_path / "art"),
                           "--buckets", "0.2:2,0.4:2", "--text_tokens", "8", "--device", "cpu"])
    index = json.loads((art / "index.json").read_text())
    assert [b["dir"] for b in index["buckets"]] == ["b0.2s_bs2", "b0.4s_bs2"]
    assert json.loads((art / "calibration.json").read_text())["temperature"] == 1.5
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.cli.serve", "--artifact", str(art), "--port", str(port),
         "--device", "cpu", "--vocab_size", "100", "--cascade_teacher", str(art),
         "--confidence_threshold", "1.01", "--energy_threshold", "100"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 120
        while True:
            try:
                health = get(url + "/healthz")
                break
            except OSError:
                assert proc.poll() is None, proc.communicate()
                assert time.monotonic() < deadline, "the server never came up"
                time.sleep(0.5)
        assert health["status"] == "ok" and len(health["buckets"]) == 2
        wave = (0.1 * np.random.default_rng(1).standard_normal(5000)).astype(np.float32)
        res = get(url + "/predict", {"audio": wave.tolist(), "text": "so happy"})
        assert res["escalated"] is True and res["bucket_seconds"] == 0.4
        assert abs(sum(res["probabilities"].values()) - 1.0) < 1e-4
        stats = get(url + "/stats")
        assert stats["escalations"] == stats["requests"] == 1
        assert stats["confidence_threshold"] == 1.01 and stats["energy_threshold"] == 100.0
        assert stats["student"]["temperature"] == 1.5
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "drained, exiting" in out


def test_export_flags_reach_the_spec(checkpoint, tmp_path):
    _, ck = checkpoint
    art = export_cli.main(["--checkpoint", str(ck), "--out_dir", str(tmp_path / "one"),
                           "--batch_size", "2", "--audio_seconds", "0.2", "--text_tokens", "8",
                           "--no_dsp", "--no_openmax", "--wire", "int16", "--device", "cpu"])
    spec = json.loads((art / "spec.json").read_text())
    assert (spec["with_dsp"], spec["use_openmax"], spec["wire"]) == (False, False, "int16")
    assert spec["batch_spec"]["audio"] == [[2, 3200], "int16"]
    assert "quality_feats" in spec["batch_spec"] and spec["devices"] == ["cpu"]


def test_export_autotunes_buckets_from_a_manifest(checkpoint, tmp_path, capsys):
    root, ck = checkpoint
    art = export_cli.main(["--checkpoint", str(ck), "--out_dir", str(tmp_path / "auto"),
                           "--autotune_buckets", "2", "--manifest", str(root / "m.jsonl"),
                           "--batch_size", "2", "--text_tokens", "8", "--device", "cpu"])
    index = json.loads((art / "index.json").read_text())
    caps = [b["audio_seconds"] for b in index["buckets"]]
    assert len(caps) == 2 and caps[0] >= 0.4 and caps[1] >= 1.2
    assert "caps=" in capsys.readouterr().out


def test_infer_scores_a_clip_and_exports_json(checkpoint, tmp_path):
    root, ck = checkpoint
    out = tmp_path / "r.json"
    res = infer_cli.main(["--checkpoint", str(ck), "--audio", str(root / "c4.wav"),
                          "--text", "so happy today", "--use_tta", "--num_tta", "3",
                          "--export", str(out), "--device", "cpu"])
    saved = json.loads(out.read_text())
    assert saved["emotion_labels"] == res["emotion_labels"]
    np.testing.assert_allclose(saved["probabilities"], res["probabilities"], rtol=1e-15)
    assert res["modalities"] == {"audio": True, "text": True}


@pytest.mark.parametrize("cli", ["export", "infer"])
def test_int8_exits_naming_its_item(checkpoint, tmp_path, cli, monkeypatch):
    """--int8 quantises the backbones before the CLI's work (here at
    min_size 16, so that these widths have int8 kernels): the export's
    params.npz holds int8 kernel_q and f32 w_scale, and its program
    predicts; infer predicts through the int8 products."""
    _, ck = checkpoint
    quantize, plain = tquant.quantize_backbones, tquant.int8_matmul_plain
    products = []
    monkeypatch.setattr(tquant, "quantize_backbones", lambda p, **kw: quantize(p, min_size=16))
    monkeypatch.setattr(tquant, "int8_matmul_plain",
                        lambda xq, kq: products.append(xq.shape) or plain(xq, kq))
    if cli == "export":
        art = export_cli.main(["--checkpoint", str(ck), "--out_dir", str(tmp_path / "art"),
                               "--int8", "--device", "cpu", "--batch_size", "2",
                               "--audio_seconds", "0.5", "--text_tokens", "8", "--no_dsp"])
        npz = np.load(art / "params.npz")
        key = "['audio_backbone']['layers']['q']"
        assert npz[key + "['kernel_q']"].dtype == np.int8
        assert npz[key + "['w_scale']"].dtype == np.float32
        model = ServingModel(art, device="cpu")
        batch = {k: np.ones(s, d) for k, (s, d) in model.spec["batch_spec"].items()}
        batch["audio"] = 0.1 * np.random.default_rng(0).standard_normal(batch["audio"].shape)
        batch["text_ids"][:, 1:] = 7
        out = model.predict(batch)
        assert np.isfinite(out["logits"]).all() and out["logits"].shape == (2, 4)
    else:
        res = infer_cli.main(["--checkpoint", str(ck), "--int8", "--device", "cpu",
                              "--text", "so happy today"])
        assert np.isfinite(res["probabilities"]).all()
    assert products   # the int8 linears ran


@pytest.mark.parametrize("cli", ["export", "serve", "infer"])
def test_cli_without_a_card_exits_non_zero(checkpoint, tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")  # decided at run time
    _, ck = checkpoint
    argv = {"export": ["--checkpoint", str(ck), "--out_dir", str(tmp_path / "x")],
            "serve": ["--artifact", str(tmp_path)],
            "infer": ["--checkpoint", str(ck)]}[cli]
    main = {"export": export_cli.main, "serve": serve_cli.main, "infer": infer_cli.main}[cli]
    with pytest.raises(SystemExit, match="no CUDA device.*--device cpu") as exc:
        main(argv)
    assert exc.value.code != 0
    assert not (tmp_path / "x").exists()


def test_export_cli_process_without_a_card_exits_non_zero(checkpoint, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")  # decided at run time
    _, ck = checkpoint
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.cli.export", "--checkpoint", str(ck),
                           "--out_dir", str(tmp_path / "x")], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=env, check=False)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--device cpu" in proc.stderr
    assert not (tmp_path / "x").exists()

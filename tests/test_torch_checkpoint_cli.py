"""The port's checkpoint CLIs on the CPU, on files the tests write:
import_checkpoint (a reference .pt the JAX package writes for a tiny
WavLM-like model) into a checkpoint that the port's eval, infer and
export CLIs run; export_torch back to the reference's layout, loadable
strictly by the HF backbones; make_manifest against the repo's CLI; and
the train CLI's large presets and Hugging Face checkpoint flags (a tiny
HF model saved with save_pretrained; no network: a connection attempt
fails the test)."""

import dataclasses
import json
import runpy
import socket
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import config as jcfg
import multilingual_multimodal_speech_emotion_recognition_tpu.models.model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu.models import (
    ref_convert as jref)
from multilingual_multimodal_speech_emotion_recognition_tpu.train import loop as jloop
from multilingual_multimodal_speech_emotion_recognition_tpu.utils import runtime as jruntime
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
    config as tcfg, export as tex, weights)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli import (
    eval as eval_cli, export as export_cli, export_torch, import_checkpoint,
    make_manifest, train as train_cli)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
    audio_io, manifest as tman)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data.tokenizer import (
    get_tokenizer)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.interface import (
    main as infer_main)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    hf_convert, model as tm, ref_convert as ref)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
    checkpoint as tckpt, loop as tloop)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
    leaves_with_paths)

from test_model import tiny_config
from test_torch_ref_convert import _perturbed, base_config

REPO = Path(__file__).resolve().parents[1]
SR = 16000
TEXTS = ["angry shouting words", "happy cheerful words", "sad crying words",
         "neutral plain words"]


@pytest.fixture
def no_network(monkeypatch):
    """Any attempt to open a connection fails the test instead of leaving."""
    def refuse(self, address, *args):
        raise AssertionError(f"network access attempted: {address}")
    monkeypatch.setattr(socket.socket, "connect", refuse)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """8 tones of 0.6-1.0 s and their manifest."""
    root = tmp_path_factory.mktemp("clips")
    (root / "datasets" / "synth").mkdir(parents=True)
    items = []
    for i in range(8):
        n = int(SR * (0.6 + 0.05 * i))
        x = 0.4 * np.sin(2 * np.pi * 250.0 * (i % 4 + 1) * np.arange(n) / SR)
        audio_io.write_wav(root / "datasets" / "synth" / f"c{i}.wav", x.astype(np.float32), SR)
        items.append({"audio": f"synth/c{i}.wav", "text": TEXTS[i % 4], "label": i % 4})
    tman.write_manifest(root / "manifest.jsonl", items)
    return root


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """A WavLM-like reference .pt written by the JAX package, the JAX
    params, and the port's import CLI's checkpoint of it (f32)."""
    root = tmp_path_factory.mktemp("import")
    cfg = base_config("wavlm")
    params = _perturbed(jax.tree.map(np.asarray, jm.init_model(jax.random.key(8), cfg)), 5)
    sds = jref.reference_state_dicts_from_params(params, cfg)
    sds.update(epoch=4, f1=0.4884, optimizer={"state": {}, "param_groups": []}, scheduler={})
    torch.save(sds, root / "reference.pt")
    # hidden 32 is off the family's widths: its head count is given
    report = import_checkpoint.main(["--reference_checkpoint", str(root / "reference.pt"),
                                     "--out", str(root / "ckpt"), "--compute_dtype", "float32",
                                     "--audio_heads", "4", "--text_heads", "4"])
    return root, params, report


def test_import_cli_writes_what_the_jax_import_gives(imported):
    root, _, report = imported
    jckpt = jref.load_reference_checkpoint(str(root / "reference.pt"))
    jc = jref.infer_model_config(jckpt)
    jc = dataclasses.replace(
        jc, audio=dataclasses.replace(jc.audio, num_attention_heads=4),
        text=dataclasses.replace(jc.text, num_attention_heads=4))
    jp, jreport = jref.params_from_reference_checkpoint(jckpt, jc, jm.init_model(
        jax.random.key(0), jc))
    assert json.loads((root / "ckpt" / "import_report.json").read_text()) == report
    assert {k: v for k, v in report.items() if k != "assumed"} == jreport
    assert report["assumed"]["audio_heads"] == 4 and report["epoch"] == 4
    cfg = tcfg.config_from_json(tckpt.load_config_json(root / "ckpt"))
    want = json.loads(jcfg.to_json(jc))
    want["compute_dtype"] = "float32"
    assert json.loads(tcfg.to_json(cfg.model)) == want
    assert cfg.model.audio.gated_relpos_bias and cfg.model.audio.do_stable_layer_norm is False
    params, meta = tckpt.restore_checkpoint(root / "ckpt", device="cpu")
    assert meta["epoch"] == 4 and meta["imported_from"] == str(root / "reference.pt")
    bridged = dict(leaves_with_paths(weights.params_from_jax(
        jax.tree.map(np.asarray, jp), cfg.model, device="cpu")))
    for path, leaf in leaves_with_paths(params):
        if not path.startswith("asr_proj"):
            assert torch.equal(leaf, bridged[path]), path


def test_import_cli_exits_on_use_asr(imported, monkeypatch):
    """--use_asr writes the ASR feature path into the imported config, the
    config the repo's cli/import_checkpoint.py writes from the same .pt;
    the parameters are the ones imported without it."""
    root, _, _ = imported
    args = ["--reference_checkpoint", str(root / "reference.pt"), "--compute_dtype",
            "float32", "--audio_heads", "4", "--text_heads", "4", "--use_asr"]
    import_checkpoint.main(args + ["--out", str(root / "asr")])
    jax_cli = runpy.run_path(str(REPO / "cli" / "import_checkpoint.py"), run_name="jax_cli")
    monkeypatch.setattr(sys, "argv", ["import_checkpoint.py", *args, "--out",
                                      str(root / "asr_jax")])
    jax_cli["main"]()
    got = json.loads(tckpt.load_config_json(root / "asr"))
    want = json.loads((root / "asr_jax" / "config.json").read_text())
    assert got == want
    assert got["model"]["use_asr"] is True
    params, _ = tckpt.restore_checkpoint(root / "asr", device="cpu")
    plain, _ = tckpt.restore_checkpoint(root / "ckpt", device="cpu")
    for (path, leaf), (_, want) in zip(leaves_with_paths(params), leaves_with_paths(plain)):
        assert torch.equal(leaf, want), path


def test_eval_infer_and_export_clis_run_the_imported_checkpoint(imported, clips, tmp_path):
    root, _, _ = imported
    ckpt_dir = str(root / "ckpt")
    manifest = str(clips / "manifest.jsonl")
    res = eval_cli.main(["--manifest", manifest, "--checkpoint", ckpt_dir, "--device", "cpu",
                         "--dataset_root", str(clips / "datasets"), "--batch_size", "4"])
    assert res["logits"].shape == (8, 4) and np.isfinite(res["logits"]).all()
    out = infer_main(["--checkpoint", ckpt_dir, "--audio",
                      str(clips / "datasets" / "synth" / "c0.wav"), "--text", TEXTS[0],
                      "--device", "cpu"])
    assert np.isfinite(out["probabilities"]).all()
    art = export_cli.main(["--checkpoint", ckpt_dir, "--out_dir", str(tmp_path / "art"),
                           "--batch_size", "2", "--audio_seconds", "0.5", "--text_tokens", "8",
                           "--no_dsp", "--device", "cpu"])
    served = tex.ServingModel(art, device="cpu")
    cfg = tcfg.config_from_json(tckpt.load_config_json(ckpt_dir)).model
    params, _ = tckpt.restore_checkpoint(ckpt_dir, device="cpu")
    rng = np.random.default_rng(0)
    tok = get_tokenizer(vocab_size=cfg.text.vocab_size)
    ids, mask = tok.encode_batch(TEXTS[:2], 8)
    batch = {"audio": rng.standard_normal((2, 8000)).astype(np.float32),
             "audio_mask": np.ones((2, 8000), np.float32),
             "text_ids": np.asarray(ids, np.int32), "text_mask": np.asarray(mask, np.float32),
             "quality_feats": rng.standard_normal((2, 8)).astype(np.float32),
             "cond_feats": rng.standard_normal((2, 12)).astype(np.float32)}
    got = served.predict(batch)
    want = tm.model_forward(params, cfg, batch, use_openmax=True)
    np.testing.assert_allclose(got["logits"], want.logits.numpy(), rtol=1e-5, atol=1e-5)


def test_export_torch_cli_loads_strictly_into_the_hf_backbones(imported, tmp_path):
    from transformers import (WavLMConfig, WavLMModel, XLMRobertaConfig,
                              XLMRobertaModel)
    root, _, _ = imported
    ckpt = export_torch.main(["--checkpoint", str(root / "ckpt"),
                              "--out", str(tmp_path / "out.pt")])
    saved = torch.load(tmp_path / "out.pt", weights_only=True)
    assert saved["epoch"] == 4 and abs(saved["f1"] - 0.4884) < 1e-9
    cfg = tcfg.config_from_json(tckpt.load_config_json(root / "ckpt")).model
    params, _ = tckpt.restore_checkpoint(root / "ckpt", device="cpu")
    want = ref.reference_state_dicts_from_params(params, cfg)
    for module in ref.REFERENCE_MODULES:
        assert list(saved[module]) == list(want[module]) == list(ckpt[module])
        for key, w in want[module].items():
            assert torch.equal(saved[module][key], w), f"{module}.{key}"
    a = cfg.audio
    wavlm = WavLMModel(WavLMConfig(
        hidden_size=a.hidden_size, num_hidden_layers=a.num_hidden_layers,
        num_attention_heads=4, intermediate_size=a.intermediate_size,
        conv_dim=a.conv_dim, conv_stride=a.conv_stride, conv_kernel=a.conv_kernel,
        conv_bias=a.conv_bias, num_conv_pos_embeddings=a.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=a.num_conv_pos_embedding_groups,
        do_stable_layer_norm=True, feat_extract_norm="layer", num_buckets=a.num_buckets,
        max_bucket_distance=a.max_bucket_distance))
    encoder = {k[len("encoder."):]: v for k, v in saved["audio_encoder"].items()
               if k.startswith("encoder.")}
    wavlm.load_state_dict(encoder, strict=True)
    t = cfg.text
    xlmr = XLMRobertaModel(XLMRobertaConfig(
        vocab_size=t.vocab_size, hidden_size=t.hidden_size,
        num_hidden_layers=t.num_hidden_layers, num_attention_heads=4,
        intermediate_size=t.intermediate_size,
        max_position_embeddings=t.max_position_embeddings, type_vocab_size=1))
    xlmr.load_state_dict({k[len("encoder."):]: v for k, v in saved["text_encoder"].items()
                          if k.startswith("encoder.")}, strict=True)
    # and back: the tree comes back, the positional conv through its weight norm
    back, _ = ref.params_from_reference_checkpoint(saved, cfg, params)
    for path, leaf in leaves_with_paths(params):
        torch.testing.assert_close(dict(leaves_with_paths(back))[path], leaf,
                                   rtol=1e-6, atol=1e-7)


def _dataset(root: Path) -> None:
    crema, ravdess = root / "crema", root / "ravdess"
    crema.mkdir(parents=True)
    ravdess.mkdir(parents=True)
    for actor in range(1001, 1011):
        for emotion in ("ANG", "HAP", "SAD", "NEU", "DIS", "FEA"):
            (crema / f"{actor}_IEO_{emotion}_HI.wav").write_bytes(b"\0" * (2000 + actor % 3))
    for actor in range(1, 9):
        for code in ("01", "03", "04", "05"):
            (ravdess / f"03-01-{code}-01-01-01-{actor:02d}.wav").write_bytes(b"\0" * 1500)
    (crema / "1011_IEO_ANG_HI.wav").write_bytes(b"\0" * 10)   # dropped by --min_bytes


@pytest.mark.parametrize("split", ["none", "stratified", "speaker"])
def test_make_manifest_cli_matches_the_repo_cli(split, tmp_path, monkeypatch):
    _dataset(tmp_path / "datasets")
    args = ["--root", str(tmp_path / "datasets"), "--datasets", "crema", "ravdess",
            "--split", split, "--num_classes", "6" if split == "none" else "4"]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["make_manifest.py"] + args + ["--out_prefix", "jax"])
    runpy.run_path(str(REPO / "cli" / "make_manifest.py"), run_name="__main__")
    outputs = make_manifest.main(args + ["--out_prefix", "port"])
    for path in outputs:
        assert (tmp_path / path).read_text() == (
            tmp_path / path.replace("port", "jax", 1)).read_text(), path
    # each dataset's scan reads every WAV under the root, as the repo's CLI does
    assert sum(len(v) for v in outputs.values()) == 2 * (60 + 32 + 1)
    # the size filter drops the one short file from both scans, and no other
    filtered = make_manifest.main(args + ["--out_prefix", "filtered", "--min_bytes", "1000"])
    kept = [it for v in filtered.values() for it in v]
    assert len(kept) == 2 * (60 + 32) and not any("1011_" in it["audio"] for it in kept)


@pytest.mark.parametrize("preset", ["wav2vec2-large", "hubert-large", "wavlm-large"])
def test_train_cli_builds_the_large_presets(preset, monkeypatch, tmp_path):
    args = ["--audio_backbone", preset, "--use_amp", "--save_dir", str(tmp_path)]
    captured = {}

    def capture(name):
        def fake(cfg, **kw):
            captured[name] = (cfg, kw.get("pretrained"))
            return {"best_f1": 0.0}
        return fake

    jax_cli = runpy.run_path(str(REPO / "cli" / "train.py"), run_name="jax_cli")
    monkeypatch.setattr(jruntime, "configure", lambda **kw: None)
    monkeypatch.setattr(jloop, "train", capture("jax"))
    monkeypatch.setattr(sys, "argv", ["train.py"] + args)
    jax_cli["main"]()
    monkeypatch.setattr(tloop, "train", capture("port"))
    train_cli.main(args + ["--device", "cpu"])
    want = json.loads(jcfg.to_json(captured["jax"][0]))
    assert json.loads(tcfg.to_json(captured["port"][0])) == want
    assert captured["port"][0].model.audio == tcfg.AUDIO_BACKBONE_PRESETS[preset]()
    assert captured["port"][1] is None


def _tiny_hf(tmp_path: Path):
    """Tiny HF models with tiny_config's encoder shapes, saved with
    save_pretrained: (audio model, its dir, text model, its dir)."""
    from transformers import (Wav2Vec2Config, Wav2Vec2Model, XLMRobertaConfig,
                              XLMRobertaModel)
    a, t = tiny_config().audio, tiny_config().text
    torch.manual_seed(5)
    audio = Wav2Vec2Model(Wav2Vec2Config(
        hidden_size=a.hidden_size, num_hidden_layers=a.num_hidden_layers,
        num_attention_heads=a.num_attention_heads, intermediate_size=a.intermediate_size,
        conv_dim=a.conv_dim, conv_stride=a.conv_stride, conv_kernel=a.conv_kernel,
        num_conv_pos_embeddings=a.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=a.num_conv_pos_embedding_groups,
        feat_extract_norm="group", do_stable_layer_norm=False)).eval()
    text = XLMRobertaModel(XLMRobertaConfig(
        vocab_size=t.vocab_size, hidden_size=t.hidden_size,
        num_hidden_layers=t.num_hidden_layers, num_attention_heads=t.num_attention_heads,
        intermediate_size=t.intermediate_size,
        max_position_embeddings=t.max_position_embeddings, type_vocab_size=1)).eval()
    audio.save_pretrained(tmp_path / "w2v")
    text.save_pretrained(tmp_path / "xlmr")
    return audio, tmp_path / "w2v", text, tmp_path / "xlmr"


def test_train_cli_loads_hf_checkpoints(no_network, monkeypatch, tmp_path):
    audio, audio_dir, text, text_dir = _tiny_hf(tmp_path)
    captured = {}
    monkeypatch.setattr(tloop, "train", lambda cfg, **kw: captured.update(kw) or {"best_f1": 0})
    train_cli.main(["--wav2vec2_checkpoint", str(audio_dir), "--xlmr_checkpoint",
                    str(text_dir), "--device", "cpu", "--save_dir", str(tmp_path / "s")])
    for key, model in (("wav2vec2_state", audio), ("xlmr_state", text)):
        got = captured["pretrained"][key]
        for name, tensor in model.state_dict().items():
            assert torch.equal(got[name], tensor), name
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(SystemExit, match="transformers package"):
        train_cli.main(["--xlmr_checkpoint", str(text_dir), "--device", "cpu"])


def test_train_starts_from_the_pretrained_backbones(clips, tmp_path):
    """One epoch with frozen backbones: they stay the converted HF weights."""
    audio, _, text, _ = _tiny_hf(tmp_path)
    cfg = tcfg.Config(
        model=tcfg.from_json(jcfg.to_json(tiny_config())),
        data=tcfg.DataConfig(audio_buckets=(1.0,), max_text_tokens=12,
                             dataset_root=str(clips / "datasets")),
        train=tcfg.TrainConfig(epochs=1, batch_size=4, save_dir=str(tmp_path / "run")))
    manifest = str(clips / "manifest.jsonl")
    result = tloop.train(cfg, train_manifest=manifest, val_manifest=manifest,
                         tokenizer=get_tokenizer(vocab_size=cfg.model.text.vocab_size),
                         pretrained={"wav2vec2_state": audio.state_dict(),
                                     "xlmr_state": text.state_dict()},
                         progress=False, device="cpu")
    for name, want in (("audio_backbone", hf_convert.wav2vec2_from_hf(audio.state_dict())),
                       ("text_backbone", hf_convert.xlmr_from_hf(text.state_dict()))):
        got = dict(leaves_with_paths(result["params"][name]))
        for path, leaf in leaves_with_paths(want):
            assert torch.equal(got[path], leaf), f"{name}/{path}"

"""The port's serving artifacts (export.py: torch.export programs) against
the JAX package's (jax.export) on the CPU, on the same bridged parameters
of one tiny model with the front-end DSP on.

Tolerance: f32 within 1e-4 (summation order only). The DSP artifacts run
1 s rows that fire the notch, HPF and denoise gates and speech-like rows
that fire none, so both branches of those `torch.cond`s run (the dereverb
gate never fires on real audio: its T60 estimate stays at or below 0.1 s).
"""

import json

import numpy as np
import pytest
import jax
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import (
    config as jcfg, export as jex)
from multilingual_multimodal_speech_emotion_recognition_tpu.models import model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
    config as tcfg, export as tex, weights)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.frontend import (
    conditioning as tc, spectral as ts)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    model as tm)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
    audio_dsp as tdsp)

from test_model import tiny_config
from test_torch_frontend import dsp_batch, speech_like

TOL = 1e-4
SR = 16000
S = 10
DSP = dict(batch_size=4, audio_seconds=1.0, text_tokens=S, with_dsp=True)
CACHES = (ts.hann_window, ts.rfftfreq, ts._reflect_index, ts._welch_scale,
          tc._notch_mag_sq, tc._overlap_add_norm, tdsp._resample_kernel, tdsp._kernel_on)


def clear_caches():
    for cache in CACHES:
        cache.cache_clear()


def text_inputs(B, S, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 100, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    ids[1, S // 2:] = 1
    mask[1, S // 2:] = 0
    return {"text_ids": ids, "text_mask": mask}


def lid(B):
    rng = np.random.default_rng(9)
    return {"lid_entropy": (1.0 + rng.random(B)).astype(np.float32),
            "lid_conf": (0.5 * rng.random(B)).astype(np.float32)}


def dsp_batches():
    """Worst-case rows (the gates fire) and speech-like rows (none does)."""
    wave, mask = dsp_batch()
    speech = np.stack([speech_like(SR, seed=s) for s in range(4)]).astype(np.float32)
    return {name: {"audio": w, "audio_mask": m, **text_inputs(4, S, 1), **lid(4)}
            for name, w, m in (("worst_case", wave, mask),
                               ("speech_like", speech, np.ones_like(speech)))}


@pytest.fixture(scope="module")
def model():
    cfg = tiny_config(frontend_dsp=True)
    params = jax.tree.map(np.asarray, jm.init_model(jax.random.key(0), cfg))
    port_cfg = tcfg.from_json(jcfg.to_json(cfg))
    return cfg, params, port_cfg, weights.params_from_jax(params, port_cfg, device="cpu")


def eager(port_cfg, params, batch):
    out = tm.model_forward(params, port_cfg, batch, use_openmax=True)
    return [t.float() for t in (out.logits, out.uncertainty, out.features)]


@pytest.fixture(scope="module")
def artifacts(model, tmp_path_factory):
    """JAX's and the port's DSP artifacts, and the port's eager forward on
    the worst-case rows before any export, after an export from warm
    tensor caches (the f32 wire) and after one from cold caches (int16)."""
    cfg, params, port_cfg, port_params = model
    root = tmp_path_factory.mktemp("export")
    worst = dsp_batches()["worst_case"]
    eager_runs = {"before": eager(port_cfg, port_params, worst)}
    tex.export_forward(port_params, port_cfg, root / "port_dsp", device="cpu", **DSP)
    eager_runs["after a warm-cache export"] = eager(port_cfg, port_params, worst)
    clear_caches()
    tex.export_forward(port_params, port_cfg, root / "port_i16", device="cpu", wire="int16",
                       **DSP)
    eager_runs["after a cold-cache export"] = eager(port_cfg, port_params, worst)
    jex.export_forward(params, cfg, root / "jax_dsp", **DSP)
    return root, eager_runs


@pytest.fixture(scope="module")
def served(artifacts):
    """Each artifact loaded once: the port's on the CPU, and JAX's."""
    root, _ = artifacts
    return {"port_dsp": tex.ServingModel(root / "port_dsp", device="cpu"),
            "port_i16": tex.ServingModel(root / "port_i16", device="cpu"),
            "jax_dsp": jex.ServingModel(root / "jax_dsp")}


def assert_outputs_close(got, want):
    assert set(got) == set(want) == set(tex.OUTPUTS)
    for name in tex.OUTPUTS:
        assert got[name].shape == want[name].shape and got[name].dtype == np.float32, name
        np.testing.assert_allclose(got[name], want[name], rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("audio", ["worst_case", "speech_like"])
def test_dsp_artifact_matches_jax_on_both_branches(served, audio):
    batch = dsp_batches()[audio]
    _, stats = tc.condition_audio(torch.from_numpy(batch["audio"]),
                                  torch.from_numpy(batch["audio_mask"]))
    fired = bool(stats.hum_filtered.any() | stats.hpf_applied.any())
    assert fired == bool(stats.denoise_applied.any()) == (audio == "worst_case")
    got = served["port_dsp"].predict(batch)
    assert_outputs_close(got, served["jax_dsp"].predict(batch))
    # a second predict runs the same program on the parameters placed once
    again = served["port_dsp"].predict(batch)
    for name in tex.OUTPUTS:
        np.testing.assert_array_equal(again[name], got[name])


def test_int16_wire_matches_f32_wire_on_pcm(served):
    base = dsp_batches()["worst_case"]
    T = base["audio"].shape[1]
    pcm = np.clip(np.rint(base["audio"] * 32768.0), -32768, 32767).astype(np.int16)
    lens = np.array([T, T - 700, T, 11200], np.int32)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    pcm[mask == 0] = 0
    assert served["port_i16"].spec["wire"] == "int16"
    out_i16 = served["port_i16"].predict(dict(base, audio=pcm, audio_len=lens))
    out_f32 = served["port_dsp"].predict(
        dict(base, audio=pcm.astype(np.float32) / 32768.0 * mask, audio_mask=mask))
    for name in tex.OUTPUTS:
        np.testing.assert_allclose(out_i16[name], out_f32[name], rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_spec_json_has_the_jax_schema_with_devices(artifacts):
    root, _ = artifacts
    got = json.loads((root / "port_dsp" / "spec.json").read_text())
    want = json.loads((root / "jax_dsp" / "spec.json").read_text())
    assert set(got) == set(want) - {"platforms"} | {"devices"}
    assert got["devices"] == ["cpu"]
    for key in ("batch_spec", "outputs", "with_dsp", "use_openmax", "wire", "sample_rate",
                "text_vocab_size", "num_labels"):
        assert got[key] == want[key], key


def test_cpu_artifact_refused_on_another_device(artifacts):
    root, _ = artifacts
    for device in ("cuda", "meta"):
        with pytest.raises(ValueError, match="traced for"):
            tex.ServingModel(root / "port_dsp", device=device)


def program_targets(served_model):
    return [str(n.target) for n in served_model.program.graph.nodes
            if n.op == "call_function"]


def test_program_holds_the_registered_stack_and_three_conds(served):
    for name in ("port_dsp", "port_i16"):
        targets = program_targets(served[name])
        assert targets.count("ser_torch.residual_stack.default") == 1, name
        assert targets.count("cond") == 3, name


@pytest.mark.parametrize("when", ["after a warm-cache export", "after a cold-cache export"])
def test_eager_forward_after_an_export_is_unchanged(artifacts, when):
    """Exports from warm and from cold tensor caches leave nothing of the
    trace in them: the eager forward stays bitwise what it was."""
    _, eager_runs = artifacts
    for a, b in zip(eager_runs[when], eager_runs["before"]):
        assert torch.equal(a, b)


def test_eager_dsp_never_reaches_torch_cond(model, monkeypatch):
    _, _, port_cfg, port_params = model

    def refuse(*args, **kwargs):
        raise AssertionError("torch.cond reached outside torch.export")

    monkeypatch.setattr(torch, "cond", refuse)
    logits, _, _ = eager(port_cfg, port_params, dsp_batches()["worst_case"])
    assert torch.isfinite(logits).all()

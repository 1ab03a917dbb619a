"""The port's inference interface (interface.py) against the JAX
package's on the CPU: one tiny model with the front-end DSP on, saved as a
JAX checkpoint and as the port's checkpoint of the bridged parameters.

Tolerance: f32 within 1e-4 (summation order only). The TTA takes JAX's
noise draws, and the JAX side runs its speed views' lengths as its eager
code computes them (`exact_speed_perturb_length`): jitted, it keeps one
sample more at some lengths (ROADMAP Queue C)."""

import json
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import (
    config as jcfg, interface as jiface)
from multilingual_multimodal_speech_emotion_recognition_tpu.data import (
    audio_io as jaio, tokenizer as jtok)
from multilingual_multimodal_speech_emotion_recognition_tpu.models import model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu.ops import audio_dsp as jdsp
from multilingual_multimodal_speech_emotion_recognition_tpu.train import checkpoint as jckpt
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
    config as tcfg, interface as tiface, weights)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
    tokenizer as ttok)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
    checkpoint as tckpt)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
    leaves_with_paths)

from test_model import tiny_config
from test_torch_audio_dsp import exact_speed_perturb_length
from torch_port_helpers import perturb
from torch_port_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SR = 16000
TOL = 1e-4
TEXTS = ["I am so happy today", None]


@pytest.fixture(scope="module", autouse=True)
def jax_speed_lengths_as_eager():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdsp, "speed_perturb_length", exact_speed_perturb_length)
        yield


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(JAX checkpoint, port checkpoint, the same again with a calibration,
    two WAVs: a tone of 0.8 s and a hum-and-noise clip of 1.3 s)."""
    root = tmp_path_factory.mktemp("iface")
    jc = jcfg.Config(model=tiny_config(frontend_dsp=True),
                     data=jcfg.DataConfig(max_text_tokens=12, dataset_root=None))
    params = jax.tree.map(np.asarray, jm.init_model(jax.random.key(0), jc.model))
    params["classifier"] = perturb(params["classifier"], np.random.default_rng(1), 0.5)
    cfg_json = jcfg.to_json(jc)
    jpath = jckpt.save_checkpoint(root / "jax", params=params, epoch=2, f1=0.5,
                                  config_json=cfg_json)
    port_params = weights.params_from_jax(params, tcfg.from_json(cfg_json), device="cpu")
    tpath = tckpt.save_checkpoint(root / "port", params=port_params, epoch=2, f1=0.5,
                                  config_json=cfg_json)
    for src in (jpath, tpath):
        dst = root / f"{src.name}_cal"
        shutil.copytree(src, dst)
        (dst / "calibration.json").write_text(json.dumps({"temperature": 2.5}))
    rng = np.random.default_rng(2)
    t = np.arange(int(1.3 * SR)) / SR
    waves = [0.4 * np.sin(2 * np.pi * 500 * t[:int(0.8 * SR)]),
             0.5 * np.sin(2 * np.pi * 50 * t) + 0.3 * np.sin(2 * np.pi * 130 * t)
             + 0.05 * rng.standard_normal(t.size)]
    wavs = []
    for i, w in enumerate(waves):
        jaio.write_wav(root / f"c{i}.wav", w.astype(np.float32), SR)
        wavs.append(str(root / f"c{i}.wav"))
    return root, wavs


def interfaces(root, calibrated=False):
    suffix = "_cal" if calibrated else ""
    return (tiface.EmotionRecognitionInterface(str(root / f"port{suffix}"), device="cpu",
                                               tokenizer=ttok.HashTokenizer(100)),
            jiface.EmotionRecognitionInterface(str(root / f"jax{suffix}"),
                                               tokenizer=jtok.HashTokenizer(100)))


def assert_results_match(got, want):
    assert set(got) == set(want)
    for key in ("logits", "probabilities", "confidence", "uncertainty", "entropy", "margin"):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL, err_msg=key)
    assert got["anchor_loss"] == pytest.approx(want["anchor_loss"], abs=TOL)
    assert got["calibration_error"] == pytest.approx(want["calibration_error"], abs=TOL)
    top2 = np.sort(want["probabilities"], axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 10 * TOL).all(), "rows' top-2 too close to compare"
    np.testing.assert_array_equal(got["predictions"], want["predictions"])
    assert got["emotion_labels"] == want["emotion_labels"]
    assert got["modalities"] == want["modalities"]
    np.testing.assert_array_equal(got["top_k_predictions"]["indices"],
                                  want["top_k_predictions"]["indices"])
    assert got["top_k_predictions"]["labels"] == want["top_k_predictions"]["labels"]
    for flag, v in want["analysis"].items():
        np.testing.assert_array_equal(got["analysis"][flag], v, err_msg=flag)


@pytest.mark.parametrize("calibrated", [False, True], ids=["raw", "calibrated"])
def test_predict_batch_matches_jax(checkpoints, calibrated):
    root, wavs = checkpoints
    port, jax_iface = interfaces(root, calibrated)
    assert port.temperature == jax_iface.temperature == (2.5 if calibrated else 1.0)
    assert port.meta["epoch"] == 2 and port.emotion_labels == jax_iface.emotion_labels
    got = port.predict_batch(wavs, TEXTS)
    assert_results_match(got, jax_iface.predict_batch(wavs, TEXTS))
    assert got["probabilities"].shape == (2, 4)


def test_calibration_scales_only_the_softmax(checkpoints):
    root, wavs = checkpoints
    raw = interfaces(root)[0].predict_batch(wavs, TEXTS)
    cal = interfaces(root, calibrated=True)[0].predict_batch(wavs, TEXTS)
    np.testing.assert_array_equal(cal["logits"], raw["logits"])
    z = raw["logits"] / 2.5
    e = np.exp(z - z.max(axis=1, keepdims=True))
    np.testing.assert_allclose(cal["probabilities"], e / e.sum(axis=1, keepdims=True),
                               rtol=1e-12)


@pytest.mark.parametrize("num_tta", [3, 5])
def test_feature_averaging_tta_matches_jax_on_its_draws(checkpoints, num_tta):
    root, wavs = checkpoints
    port, jax_iface = interfaces(root)
    want = jax_iface.predict_batch(wavs, TEXTS, use_tta=True, num_tta=num_tta, seed=7)
    # JAX's noise views: the two halves of its split key, over the batch
    T = int(1.3 * SR)
    k1, k2 = jax.random.split(jax.random.key(7))
    noise = [np.asarray(jax.random.normal(k, (2, T), jnp.float32)) for k in (k1, k2)]
    got = port.predict_batch(wavs, TEXTS, use_tta=True, num_tta=num_tta, noise=noise)
    assert_results_match(got, want)
    plain = port.predict_batch(wavs, TEXTS)
    assert not np.allclose(got["logits"], plain["logits"])


def test_tta_draws_from_its_seed(checkpoints):
    port, _ = interfaces(checkpoints[0])
    wavs = checkpoints[1]
    a, b, c = (port.predict_batch(wavs, TEXTS, use_tta=True, seed=s)["logits"]
               for s in (3, 3, 4))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("audio,text", [(True, False), (False, True), (False, False)],
                         ids=["audio_only", "text_only", "neither"])
def test_missing_modalities_match_jax(checkpoints, audio, text):
    root, wavs = checkpoints
    port, jax_iface = interfaces(root)
    args = (wavs[0] if audio else None, "just some text" if text else None)
    got = port.predict_emotion(*args)
    assert got["modalities"] == {"audio": audio, "text": text}
    assert_results_match(got, jax_iface.predict_emotion(*args))


def test_export_and_visualize(checkpoints, tmp_path):
    root, wavs = checkpoints
    port, _ = interfaces(root)
    res = port.predict_emotion(wavs[1], "hello world")
    out = tmp_path / "results.json"
    port.export_results(res, str(out))
    loaded = json.loads(out.read_text())
    assert loaded["emotion_labels"] == res["emotion_labels"]
    np.testing.assert_allclose(loaded["probabilities"], res["probabilities"], rtol=1e-15)
    assert loaded["analysis"]["low_margin"] == res["analysis"]["low_margin"].tolist()
    fig_path = tmp_path / "analysis.png"
    port.visualize_results(res, str(fig_path))
    assert fig_path.exists() and fig_path.stat().st_size > 1000


def test_int8_and_a_missing_card_raise(checkpoints):
    """quantize_int8 quantises the backbones after the restore, as JAX's
    interface does: at these widths, under quantize_backbones' min_size of
    512, every kernel stays float, so the int8 interfaces of both packages
    predict what the float ones do (tests/test_torch_quant.py holds a
    512-wide model). Without a card the default device raises."""
    root, wavs = checkpoints
    port = tiface.EmotionRecognitionInterface(str(root / "port"), quantize_int8=True,
                                              device="cpu", tokenizer=ttok.HashTokenizer(100))
    want = jiface.EmotionRecognitionInterface(str(root / "jax"), quantize_int8=True,
                                              tokenizer=jtok.HashTokenizer(100))
    plain, _ = tckpt.restore_checkpoint(str(root / "port"), device="cpu")
    got, float_leaves = dict(leaves_with_paths(port.params)), dict(leaves_with_paths(plain))
    assert got.keys() == float_leaves.keys()
    assert all(torch.equal(leaf, float_leaves[path]) for path, leaf in got.items())
    assert_results_match(port.predict_batch(wavs, TEXTS), want.predict_batch(wavs, TEXTS))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tiface.EmotionRecognitionInterface(str(root / "port"))

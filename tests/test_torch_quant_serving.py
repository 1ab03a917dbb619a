"""The port's int8 serving path against the JAX package's on the CPU: the
forward on quantised backbones, its export and the interface with
`quantize_int8=True` (tests/test_torch_quant.py holds the quantisation).

Tolerances:
  * the quantised `model_forward` in f32: 1e-3 of the mean |logit|
    (INT8_TOL). Both frameworks quantise the same weights bitwise, but an
    activation one f32 rounding away from a .5 boundary of its int8 grid
    moves a whole level in one of them; at these widths no level moved, and
    the logits agree to 9e-7 of the mean. In bf16 the frameworks round the
    activations at other places, so levels do move: the repo's bf16 bound
    (3e-2, rtol = atol) holds, at 0.018 of a mean |logit| of 0.63. The JAX
    package's own criterion (mean |int8 - float| / mean |float| < 0.25,
    tests/test_quant.py) is held on the port too;
  * the exported int8 program equals the eager int8 forward (f32, 1e-5).
"""

import dataclasses

import numpy as np
import pytest
import jax

from multilingual_multimodal_speech_emotion_recognition_tpu import (
    config as jcfg, export as jex, interface as jiface)
from multilingual_multimodal_speech_emotion_recognition_tpu.data import (
    audio_io as jaio, tokenizer as jtok)
from multilingual_multimodal_speech_emotion_recognition_tpu.models import model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu.train import checkpoint as jckpt
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
    config as tcfg, export as tex, interface as tiface, weights)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
    tokenizer as ttok)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import model as tm
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import quant as tq
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
    checkpoint as tckpt)

from test_model import tiny_batch, tiny_config
from test_torch_quant import _assert_same_quantised_leaves, _jax_params, _jax_quantised, _numpy
from torch_port_helpers import assert_close, perturb
from torch_port_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

INT8_TOL = 1e-3       # of the mean |logit|
EXPORT_TOL = 1e-5


def _quantised_model(dtype="float32"):
    cfg = tiny_config(compute_dtype=dtype)
    params = _jax_params(tiny_config(), 0)
    port_cfg = tcfg.from_json(jcfg.to_json(cfg))
    port = weights.params_from_jax(params, port_cfg, device="cpu")
    return cfg, params, port_cfg, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_forward_quantised_backbones_matches_jax(dtype):
    cfg, params, port_cfg, port = _quantised_model(dtype)
    batch = _numpy(tiny_batch())
    want = jax.jit(lambda p, b: jm.model_forward(p, cfg, b))(
        _jax_quantised(tiny_config(), 0), batch)
    got = tm.model_forward(tq.quantize_backbones(port, min_size=16), port_cfg, batch)
    want_l = np.asarray(want.logits, np.float64)
    got_l = got.logits.double().numpy()
    if dtype == "float32":
        assert np.abs(got_l - want_l).max() <= INT8_TOL * np.abs(want_l).mean(), (got_l, want_l)
    else:
        assert_close(got.logits, want.logits, 3e-2)
    for field, g, w in zip(want._fields, got, want):
        assert g.shape == w.shape, field
    # the JAX package's own criterion: int8 noise does not swamp the logits
    ref = tm.model_forward(port, port_cfg, batch).logits.double().numpy()
    assert np.isfinite(got_l).all()
    assert np.abs(got_l - ref).mean() / (np.abs(ref).mean() + 1e-6) < 0.25


def test_int8_export_matches_eager_and_jax_keys(tmp_path):
    """An artifact of the quantised tree: params.npz holds the JAX export's
    keys (int8 kernel_q, f32 w_scale) and the loaded program equals the
    eager int8 forward."""
    cfg, params, port_cfg, port = _quantised_model()
    qport = tq.quantize_backbones(port, min_size=16)
    shape = dict(batch_size=4, audio_seconds=0.05, text_tokens=10, with_dsp=False)
    tex.export_forward(qport, port_cfg, tmp_path / "port", device="cpu", **shape)
    jex.export_forward(_jax_quantised(tiny_config(), 0), cfg, tmp_path / "jax",
                       **shape)
    got_npz, want_npz = np.load(tmp_path / "port/params.npz"), np.load(tmp_path / "jax/params.npz")
    assert set(got_npz.files) == set(want_npz.files)
    for key in want_npz.files:
        assert got_npz[key].dtype == want_npz[key].dtype, key
        if "kernel_q" in key or "w_scale" in key:
            np.testing.assert_array_equal(got_npz[key], want_npz[key], err_msg=key)
    batch = {k: v for k, v in _numpy(tiny_batch(T=800)).items()}
    served = tex.ServingModel(tmp_path / "port", device="cpu")
    out = served.predict(batch)
    eager = tm.model_forward(qport, port_cfg, batch, use_openmax=True)
    for name, want in zip(tex.OUTPUTS, (eager.logits, eager.uncertainty, eager.features)):
        np.testing.assert_allclose(out[name], want.float().numpy(), rtol=EXPORT_TOL,
                                   atol=EXPORT_TOL, err_msg=name)
    assert served._params()["audio_backbone"]["layers"]["q"]["kernel_q"].stride()[-2] == 1


def wide_config():
    """Both encoders 512 wide (one layer), so that quantize_backbones'
    default min_size of 512 quantises them."""
    cfg = tiny_config()
    return dataclasses.replace(
        cfg,
        audio=dataclasses.replace(cfg.audio, hidden_size=512, intermediate_size=512,
                                  num_hidden_layers=1),
        text=dataclasses.replace(cfg.text, hidden_size=512, intermediate_size=512,
                                 num_hidden_layers=1))


def test_interface_quantize_int8_matches_jax(tmp_path):
    """EmotionRecognitionInterface(quantize_int8=True), port against JAX, on
    checkpoints of the same 512-wide weights: the backbones' layers carry
    kernel_q, and the predictions agree within INT8_TOL."""
    jc = jcfg.Config(model=wide_config(),
                     data=jcfg.DataConfig(max_text_tokens=12, dataset_root=None))
    params = dict(_jax_params(jc.model, 3))
    params["classifier"] = perturb(params["classifier"], np.random.default_rng(1), 0.5)
    cfg_json = jcfg.to_json(jc)
    jckpt.save_checkpoint(tmp_path / "jax", params=params, epoch=1, f1=0.5,
                          config_json=cfg_json)
    tckpt.save_checkpoint(tmp_path / "port", params=weights.params_from_jax(
        params, tcfg.from_json(cfg_json), device="cpu"), epoch=1, f1=0.5,
        config_json=cfg_json)
    t = np.arange(int(0.6 * 16000)) / 16000
    jaio.write_wav(tmp_path / "c.wav", (0.4 * np.sin(2 * np.pi * 300 * t)).astype(np.float32),
                   16000)
    port = tiface.EmotionRecognitionInterface(str(tmp_path / "port"), quantize_int8=True,
                                              device="cpu", tokenizer=ttok.HashTokenizer(100))
    want_iface = jiface.EmotionRecognitionInterface(str(tmp_path / "jax"), quantize_int8=True,
                                                    tokenizer=jtok.HashTokenizer(100))
    assert "kernel_q" in port.params["audio_backbone"]["layers"]["q"]
    assert "kernel_q" in port.params["text_backbone"]["layers"]["ffn_out"]
    _assert_same_quantised_leaves(
        {k: port.params[k] for k in ("audio_backbone", "text_backbone")},
        {k: _numpy(want_iface.params[k]) for k in ("audio_backbone", "text_backbone")})
    wavs, texts = [str(tmp_path / "c.wav")] * 2, ["so happy today", None]
    got, want = port.predict_batch(wavs, texts), want_iface.predict_batch(wavs, texts)
    scale = np.abs(want["logits"]).mean()
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=INT8_TOL * scale)
    np.testing.assert_array_equal(got["predictions"], want["predictions"])

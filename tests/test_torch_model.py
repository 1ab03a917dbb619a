"""The port's whole eval forward against the JAX package's model_forward
(CPU, tiny widths), plus the port's ground rules: a strict weight bridge,
the device policy, no JAX imports, and raising on what is not ported.

Tolerances: f32 within 1e-4 (summation order only); bf16 within 3e-2, the
JAX package's own bf16 pooling bound (tests/test_pallas_kernels.py:54),
since the two frameworks round bf16 at other places."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import config as jcfg
import multilingual_multimodal_speech_emotion_recognition_tpu.models.model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
    config as tcfg, weights)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    model as tm)

from test_model import tiny_batch, tiny_config
from test_torch_frontend import dsp_batch
from torch_port_helpers import assert_close
from torch_port_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "multilingual_multimodal_speech_emotion_recognition_tpu_torch"


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("use_openmax", [False, True], ids=["plain", "openmax"])
def test_model_forward_matches_jax(dtype, tol, use_openmax):
    cfg = tiny_config(compute_dtype=dtype)
    params = jm.init_model(jax.random.key(0), cfg)
    if use_openmax:
        rng = np.random.default_rng(1)
        params["classifier"]["weibull"] = {
            "alpha": jnp.asarray(1.5 + rng.random(4), jnp.float32),
            "beta": jnp.asarray(0.5 + rng.random(4), jnp.float32),
            "tau": jnp.asarray(0.1 * rng.random(4), jnp.float32),
            "activation_vectors": jnp.asarray(rng.standard_normal((4, 16)), jnp.float32)}
    batch = tiny_batch()
    want = jax.jit(lambda p, b: jm.model_forward(p, cfg, b, use_openmax=use_openmax))(
        params, batch)
    port_cfg = tcfg.from_json(jcfg.to_json(jcfg.Config(model=cfg)))
    assert port_cfg == tcfg.from_json(jcfg.to_json(cfg))
    got = tm.model_forward(weights.params_from_jax(_numpy(params), port_cfg, device="cpu"),
                           port_cfg, _numpy(batch), use_openmax=use_openmax)
    assert got._fields == want._fields
    for field, g, w in zip(want._fields, got, want):
        assert g.shape == w.shape, field
        assert_close(g, w, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("branch", ["pad_frames_valid", "use_asr"])
def test_model_forward_branches_match_jax(dtype, tol, branch):
    """encode_audio's pad_frames_valid branch and encode_text's ASR-feature
    fusion (which runs only when the batch carries asr_feats [B, 8]) against
    the JAX package; each branch must change the port's output."""
    cfg = tiny_config(compute_dtype=dtype, **{branch: True})
    params = jm.init_model(jax.random.key(0), cfg)
    batch = tiny_batch()
    if branch == "use_asr":
        batch["asr_feats"] = jnp.asarray(
            np.random.default_rng(2).standard_normal((4, 8)).astype(np.float32))
    want = jax.jit(lambda p, b: jm.model_forward(p, cfg, b))(params, batch)
    port_cfg = tcfg.from_json(jcfg.to_json(cfg))
    assert getattr(port_cfg, branch)
    port_params = weights.params_from_jax(_numpy(params), port_cfg, device="cpu")
    got = tm.model_forward(port_params, port_cfg, _numpy(batch))
    for field, g, w in zip(want._fields, got, want):
        assert g.shape == w.shape, field
        assert_close(g, w, tol)
    without = tm.model_forward(port_params, dataclasses.replace(port_cfg, **{branch: False}),
                               _numpy(batch))
    assert not torch.allclose(without.fused.float(), got.fused.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("zero_non_accept", [False, True], ids=["reject", "non_accept"])
def test_model_forward_with_frontend_dsp_matches_jax(dtype, tol, zero_non_accept):
    """The default config's forward on a batch without quality_feats /
    cond_feats: both packages run the front-end DSP on 1 s clips that fire
    the notch, HPF and denoise gates, then the model on what it leaves."""
    cfg = tiny_config(compute_dtype=dtype, frontend_dsp=True, zero_non_accept=zero_non_accept)
    params = jm.init_model(jax.random.key(0), cfg)
    wave, mask = dsp_batch()
    batch = {k: v for k, v in tiny_batch().items() if k not in ("quality_feats", "cond_feats")}
    batch.update(audio=jnp.asarray(wave), audio_mask=jnp.asarray(mask))
    want = jax.jit(lambda p, b: jm.model_forward(p, cfg, b))(params, batch)
    port_cfg = tcfg.from_json(jcfg.to_json(cfg))
    got = tm.model_forward(weights.params_from_jax(_numpy(params), port_cfg, device="cpu"),
                           port_cfg, _numpy(batch))
    for field, g, w in zip(want._fields, got, want):
        assert g.shape == w.shape, field
        assert_close(g, w, tol)


def _tiny_tree():
    cfg = tiny_config()
    return cfg, tcfg.from_json(jcfg.to_json(cfg)), _numpy(jm.init_model(jax.random.key(0), cfg))


def test_bridge_is_strict():
    _, port_cfg, tree = _tiny_tree()
    missing = jax.tree.map(lambda a: a, tree)
    del missing["classifier"]["out_ln"]["bias"]
    with pytest.raises(KeyError, match="classifier/out_ln/bias"):
        weights.params_from_jax(missing, port_cfg, device="cpu")
    extra = jax.tree.map(lambda a: a, tree)
    extra["classifier"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="classifier/stray"):
        weights.params_from_jax(extra, port_cfg, device="cpu")
    wrong = jax.tree.map(lambda a: a, tree)
    wrong["classifier"]["layers"]["block_lin1"]["kernel"] = np.zeros((3, 32, 31), np.float32)
    with pytest.raises(ValueError, match="block_lin1/kernel"):
        weights.params_from_jax(wrong, port_cfg, device="cpu")


def test_bridge_layout():
    _, port_cfg, tree = _tiny_tree()
    p = weights.params_from_jax(tree, port_cfg, device="cpu")
    conv0 = tree["audio_backbone"]["convs"][0]["kernel"]          # JAX WIO
    assert tuple(p["audio_backbone"]["convs"][0]["kernel"].shape) == conv0.shape[::-1]
    np.testing.assert_array_equal(p["audio_backbone"]["convs"][0]["kernel"].numpy(),
                                  conv0.transpose(2, 1, 0))
    w1 = tree["classifier"]["layers"]["block_lin1"]["kernel"]     # stacked [L, in, out]
    np.testing.assert_array_equal(p["classifier"]["layers"]["block_lin1"]["kernel"].numpy(), w1)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    cfg, port_cfg, tree = _tiny_tree()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_model(port_cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weights.params_from_jax(tree, port_cfg)


def test_unported_paths_raise():
    _, port_cfg, tree = _tiny_tree()
    params = weights.params_from_jax(tree, port_cfg, device="cpu")
    batch = _numpy(tiny_batch())
    # the training forward draws its dropout from an explicit generator
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        tm.model_forward(params, port_cfg, batch, deterministic=False)
    no_feats = {k: v for k, v in batch.items() if k not in ("quality_feats", "cond_feats")}
    dsp_cfg = dataclasses.replace(port_cfg, frontend_dsp=True)
    # the front-end DSP runs where the batch has no features...
    dsp = tm.model_forward(params, dsp_cfg, no_feats)
    assert torch.isfinite(dsp.logits).all()
    # ...and without it the missing features are zeros, as in the JAX package
    out = tm.model_forward(params, port_cfg, no_feats)
    assert torch.isfinite(out.logits).all()
    assert not torch.allclose(dsp.logits, out.logits)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    jax_import = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])|import_module", re.M)
    # the JAX package may be named only as a file path ("..._tpu/ops/x.py"),
    # which documents a counterpart; any other mention could import it
    jax_package = re.compile(
        r"multilingual_multimodal_speech_emotion_recognition_tpu(?!_torch|/)")
    for f in files:
        src = f.read_text()
        assert not jax_import.search(src), f"{f} imports jax"
        assert not jax_package.search(src), f"{f} names the JAX package"

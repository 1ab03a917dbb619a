"""The port's reference-checkpoint import and export (models/ref_convert.py)
against the JAX package's, on the CPU, without the reference's sources:
the JAX package writes a reference .pt from random parameters
(`reference_state_dicts_from_params`), for a base-like and a WavLM-like
tiny model (hidden 32, 2 layers, 3 convs of 16 channels). The port must
infer the same config, import the same tree as the JAX import passed
through the weight bridge (exactly), return the same report, give the
same forward (f32, 1e-4), write the same state dicts key for key, and
round-trip its own tree unchanged."""

import dataclasses
import json

import numpy as np
import pytest
import jax
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import config as jcfg
import multilingual_multimodal_speech_emotion_recognition_tpu.models.model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu.models import (
    ref_convert as jref)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
    config as tcfg, weights)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    model as tm, ref_convert as ref)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
    leaves_with_paths)

from test_model import tiny_batch

VARIANTS = ("base", "wavlm")


def base_config(variant: str) -> jcfg.ModelConfig:
    """The JAX package's tiny config of tests/test_ref_import.py, and its
    WavLM-like sibling (layer-norm convs, stable pre-LN, gated bias). The
    bias keeps the preset's 320 buckets: neither package reads the count
    from rel_attn_embed's shape."""
    audio = dict(conv_dim=(16, 16, 16), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 3),
                 hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=64, num_conv_pos_embeddings=16,
                 num_conv_pos_embedding_groups=4, apply_spec_augment=False)
    if variant == "wavlm":
        audio.update(do_stable_layer_norm=True, feat_extract_norm="layer",
                     gated_relpos_bias=True)
    return jcfg.ModelConfig(
        num_labels=4, adapter_dim=8, shared_dim=16, num_heads=4, proj_dim=32,
        classifier_layers=3, classifier_base_dim=32, frontend_dsp=False,
        audio=jcfg.Wav2Vec2Config(**audio),
        text=jcfg.XLMRConfig(vocab_size=120, hidden_size=32, num_hidden_layers=2,
                             num_attention_heads=4, intermediate_size=64,
                             max_position_embeddings=40))


def port_config(cfg: jcfg.ModelConfig) -> tcfg.ModelConfig:
    return tcfg.from_json(jcfg.to_json(cfg))


def _perturbed(tree, seed: int):
    """Noise on every leaf, so that zero biases and unit LN scales are not
    trivial; the Weibull buffers get values a fit would give."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))
                                   ).astype(np.float32), tree)
    tree["classifier"]["weibull"]["alpha"] = 1.5 + rng.random(4).astype(np.float32)
    return tree


@pytest.fixture(scope="module", params=VARIANTS)
def written(request, tmp_path_factory):
    """(variant, JAX params, the .pt path) of a reference checkpoint the JAX
    package writes."""
    cfg = base_config(request.param)
    params = _perturbed(jax.tree.map(np.asarray, jm.init_model(jax.random.key(8), cfg)), 3)
    sds = jref.reference_state_dicts_from_params(params, cfg)
    sds.update(epoch=2, f1=0.5, optimizer={"state": {}, "param_groups": []}, scheduler={})
    path = tmp_path_factory.mktemp(request.param) / "reference.pt"
    torch.save(sds, path)
    return request.param, params, path


def _imported(variant: str, path):
    """(JAX cfg, JAX params, JAX report), (port cfg, port params, port report)."""
    base = base_config(variant)
    jckpt = jref.load_reference_checkpoint(str(path))
    jc = jref.infer_model_config(jckpt, base)
    jp, jreport = jref.params_from_reference_checkpoint(jckpt, jc, jm.init_model(
        jax.random.key(9), jc))
    tckpt = ref.load_reference_checkpoint(str(path))
    tc = ref.infer_model_config(tckpt, port_config(base))
    tp, treport = ref.params_from_reference_checkpoint(
        tckpt, tc, tm.init_model(tc, torch.Generator().manual_seed(9), device="cpu"))
    return (jc, jax.tree.map(np.asarray, jp), jreport), (tc, tp, treport)


def test_infers_the_same_config_and_report(written):
    variant, _, path = written
    (jc, _, jreport), (tc, _, treport) = _imported(variant, path)
    assert json.loads(tcfg.to_json(tc)) == json.loads(jcfg.to_json(jc))
    assert tc.audio.gated_relpos_bias == (variant == "wavlm")
    assert tc.audio.feat_extract_norm == ("layer" if variant == "wavlm" else "group")
    assert treport == jreport
    assert treport["left_at_init"] == ["asr_proj"]
    assert treport["epoch"] == 2 and treport["f1"] == 0.5
    assert "optimizer" in treport["skipped"]
    assert any(k.startswith("audio_encoder.pool.") for k in treport["skipped"])


def test_imports_the_bridged_tree_exactly(written):
    variant, source, path = written
    (jc, jp, jreport), (tc, tp, _) = _imported(variant, path)
    bridged = weights.params_from_jax(jp, tc, device="cpu")
    from_source = weights.params_from_jax(source, tc, device="cpu")
    for name in jreport["imported"]:
        want = dict(leaves_with_paths(bridged[name]))
        got = dict(leaves_with_paths(tp[name]))
        assert list(got) == list(want), name
        source_leaves = dict(leaves_with_paths(from_source[name]))
        for leaf, w in want.items():
            assert torch.equal(got[leaf], w), f"{name}/{leaf}"
            if leaf == "pos_conv/kernel":   # through its weight norm: g * w / ||w||
                torch.testing.assert_close(got[leaf], source_leaves[leaf],
                                           rtol=1e-6, atol=1e-7)
            else:
                assert torch.equal(got[leaf], source_leaves[leaf]), f"{name}/{leaf}"


def test_forward_of_the_import_equals_jax(written):
    variant, _, path = written
    (jc, jp, _), (tc, tp, _) = _imported(variant, path)
    batch = tiny_batch(T=1600)
    want = jax.jit(lambda p, b: jm.model_forward(p, jc, b))(jp, batch)
    # asr_proj was left at each framework's own init; the forward never reads it
    tp = dict(tp, asr_proj=weights.params_from_jax(jp, tc, device="cpu")["asr_proj"])
    got = tm.model_forward(tp, tc, jax.tree.map(np.asarray, batch))
    for field, g, w in zip(want._fields, got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=1e-4, atol=1e-4, err_msg=field)


@pytest.mark.parametrize("style", ["parametrizations", "weight_norm", "plain"])
def test_inverse_equals_jax_key_for_key(written, style):
    variant, source, _ = written
    cfg = base_config(variant)
    want = jref.reference_state_dicts_from_params(source, cfg, pos_conv_style=style,
                                                  include_pooler=style != "plain")
    port = weights.params_from_jax(source, port_config(cfg), device="cpu")
    got = ref.reference_state_dicts_from_params(port, port_config(cfg), pos_conv_style=style,
                                                include_pooler=style != "plain")
    assert list(got) == list(want)
    for module in want:
        assert list(got[module]) == list(want[module]), module
        for key, w in want[module].items():
            assert got[module][key].dtype == torch.float32
            assert torch.equal(got[module][key], w), f"{module}.{key}"


def test_round_trip_is_the_identity(written, tmp_path):
    variant, source, _ = written
    cfg = port_config(base_config(variant))
    params = weights.params_from_jax(source, cfg, device="cpu")
    sds = ref.reference_state_dicts_from_params(params, cfg, pos_conv_style="plain")
    torch.save(sds, tmp_path / "round.pt")
    ckpt = ref.load_reference_checkpoint(str(tmp_path / "round.pt"))
    cfg2 = ref.infer_model_config(ckpt, cfg)
    # SpecAugment leaves no trace in the weights: its default comes back
    assert dataclasses.replace(cfg2, audio=dataclasses.replace(
        cfg2.audio, apply_spec_augment=False)) == cfg
    back, report = ref.params_from_reference_checkpoint(
        ckpt, cfg2, tm.init_model(cfg2, device="cpu"))
    assert report["left_at_init"] == ["asr_proj"]
    for name in report["imported"]:
        want = dict(leaves_with_paths(params[name]))
        got = dict(leaves_with_paths(back[name]))
        assert list(got) == list(want)
        for leaf, w in want.items():
            assert torch.equal(got[leaf], w), f"{name}/{leaf}"


def test_a_shape_mismatch_raises(written):
    variant, _, path = written
    ckpt = ref.load_reference_checkpoint(str(path))
    cfg = ref.infer_model_config(ckpt, port_config(base_config(variant)))
    wider = dataclasses.replace(cfg, adapter_dim=cfg.adapter_dim * 2)
    with pytest.raises(ValueError, match="audio_adapter/down/kernel: shape"):
        ref.params_from_reference_checkpoint(ckpt, wider, tm.init_model(wider, device="cpu"))
    jckpt = jref.load_reference_checkpoint(str(path))
    jwider = dataclasses.replace(jref.infer_model_config(jckpt, base_config(variant)),
                                 adapter_dim=cfg.adapter_dim * 2)
    with pytest.raises(ValueError, match="shape"):
        jref.params_from_reference_checkpoint(jckpt, jwider,
                                              jm.init_model(jax.random.key(0), jwider))

"""The port's Hugging Face converter (models/hf_convert.py) against the JAX
package's and against the HF models themselves, on the CPU.

The HF models are built from their config classes with random weights
(nothing is fetched), once per module, at the sizes of
tests/test_encoders.py: hidden 32, 2 layers, 3 convs of 16 channels. Every
parameter is moved off its init by noise, so that LN scales, biases and
the WavLM gate constants are not trivial. The converted trees must equal
the JAX package's conversion passed through the weight bridge exactly;
the port's forward on them must equal the HF model's per-sample forward
at tests/test_encoders.py's tolerances (rtol 5e-4, atol 5e-5)."""

import numpy as np
import pytest
import jax
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.models import (
    hf_convert as jconv)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    hf_convert as conv, model as tm, ref_convert, wav2vec2 as tw, xlmr as tx)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
    leaves_with_paths)

from torch_port_helpers import META, bridge

RNG = np.random.default_rng(31)
RTOL, ATOL = 5e-4, 5e-5
AUDIO = ("wav2vec2", "hubert", "wavlm")
LENGTHS = (1600, 1333, 1040)   # 79, 66 and 51 frames: past WavLM's max distance 40
POS = "encoder.pos_conv_embed.conv"


def _perturbed(model, seed: int):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model.eval()


@pytest.fixture(scope="module")
def hf_models():
    """{name: (model, port config)} built once for the module."""
    from transformers import (HubertConfig, HubertModel, Wav2Vec2Config, Wav2Vec2Model,
                              WavLMConfig, WavLMModel, XLMRobertaConfig, XLMRobertaModel)
    common = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=64, conv_dim=(16, 16, 16), conv_stride=(5, 2, 2),
                  conv_kernel=(10, 3, 3), num_conv_pos_embeddings=16,
                  num_conv_pos_embedding_groups=4, do_stable_layer_norm=True,
                  feat_extract_norm="layer", apply_spec_augment=False, layerdrop=0.0)
    port_common = {k: v for k, v in common.items() if k != "layerdrop"}
    torch.manual_seed(0)
    models = {
        "wav2vec2": (Wav2Vec2Model(Wav2Vec2Config(conv_bias=True, **common)),
                     tcfg.Wav2Vec2Config(conv_bias=True, **port_common)),
        "hubert": (HubertModel(HubertConfig(conv_bias=True, **common)),
                   tcfg.Wav2Vec2Config(conv_bias=True, **port_common)),
        "wavlm": (WavLMModel(WavLMConfig(conv_bias=False, num_buckets=16,
                                         max_bucket_distance=40, **common)),
                  tcfg.Wav2Vec2Config(conv_bias=False, gated_relpos_bias=True,
                                      num_buckets=16, max_bucket_distance=40,
                                      **port_common)),
        "xlmr": (XLMRobertaModel(XLMRobertaConfig(
                    vocab_size=120, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=40, type_vocab_size=1, pad_token_id=1,
                    layer_norm_eps=1e-5)),
                 tcfg.XLMRConfig(vocab_size=120, hidden_size=32, num_hidden_layers=2,
                                 num_attention_heads=4, intermediate_size=64,
                                 max_position_embeddings=40)),
    }
    return {name: (_perturbed(m, i), cfg) for i, (name, (m, cfg)) in enumerate(models.items())}


def _assert_trees_equal(got, want):
    got, want = dict(leaves_with_paths(got)), dict(leaves_with_paths(want))
    assert list(got) == list(want)
    for path, w in want.items():
        assert got[path].dtype == torch.float32, path
        assert torch.equal(got[path], w), path


@pytest.mark.parametrize("name", AUDIO + ("xlmr",))
def test_conversion_equals_jax_through_the_bridge(hf_models, name):
    model, cfg = hf_models[name]
    sd = model.state_dict()
    if name == "xlmr":
        got = conv.xlmr_from_hf(sd)
        want = bridge(jconv.xlmr_from_hf(sd), tx.init_xlmr(META, cfg))
    else:
        got = conv.wav2vec2_from_hf(sd)
        want = bridge(jconv.wav2vec2_from_hf(sd), tw.init_wav2vec2(META, cfg))
        assert ("rel_attn_embed" in got) == (name == "wavlm")
        assert "ln" in got["convs"][1] and "group_norm" not in got
    _assert_trees_equal(got, want)


def _spelled(sd: dict, style: str) -> dict:
    """The state dict with its positional conv's weight norm written as
    torch's parametrizations, the legacy weight_g / weight_v, or a plain
    weight."""
    sd = dict(sd)
    g = sd.pop(f"{POS}.parametrizations.weight.original0")
    v = sd.pop(f"{POS}.parametrizations.weight.original1")
    if style == "parametrizations":
        sd[f"{POS}.parametrizations.weight.original0"] = g
        sd[f"{POS}.parametrizations.weight.original1"] = v
    elif style == "weight_norm":
        sd[f"{POS}.weight_g"], sd[f"{POS}.weight_v"] = g, v
    else:
        sd[f"{POS}.weight"] = torch._weight_norm(v, g, 2)
    return sd


@pytest.mark.parametrize("style", ["parametrizations", "weight_norm", "plain"])
def test_pos_conv_weight_norm_spellings(hf_models, style):
    model, _ = hf_models["wav2vec2"]
    sd = _spelled(model.state_dict(), style)
    got = conv.pos_conv_weight(sd, POS)
    np.testing.assert_array_equal(got, jconv._pos_conv_weight(sd, POS))
    np.testing.assert_allclose(got, model.encoder.pos_conv_embed.conv.weight.detach().numpy(),
                               rtol=1e-6, atol=1e-7)
    full = conv.wav2vec2_from_hf({k: v.numpy() for k, v in sd.items()})
    np.testing.assert_array_equal(full["pos_conv"]["kernel"].numpy(), got)


def _waves():
    wave = np.zeros((len(LENGTHS), max(LENGTHS)), np.float32)
    mask = np.zeros_like(wave)
    rows = []
    for i, L in enumerate(LENGTHS):
        x = RNG.standard_normal(L).astype(np.float32)
        x = (x - x.mean()) / np.sqrt(x.var() + 1e-7)
        rows.append(x)
        wave[i, :L], mask[i, :L] = x, 1
    return wave, mask, rows


@pytest.mark.parametrize("name", AUDIO)
def test_audio_forward_matches_hf_per_sample(hf_models, name):
    model, cfg = hf_models[name]
    params = conv.wav2vec2_from_hf(model.state_dict())
    wave, mask, rows = _waves()
    got, frame_mask = tw.wav2vec2_encode(params, cfg, torch.from_numpy(wave),
                                         torch.from_numpy(mask), normalize=False)
    for i, x in enumerate(rows):
        with torch.no_grad():
            want = model(torch.from_numpy(x[None])).last_hidden_state[0].numpy()
        n_valid = int(frame_mask[i].sum())
        assert n_valid == want.shape[0]
        np.testing.assert_allclose(got[i, :n_valid].numpy(), want, rtol=RTOL, atol=ATOL)


def test_text_forward_matches_hf(hf_models):
    model, cfg = hf_models["xlmr"]
    params = conv.xlmr_from_hf(model.state_dict())
    ids = RNG.integers(2, 120, (3, 12)).astype(np.int64)
    am = np.ones((3, 12), np.int64)
    ids[1, 8:], am[1, 8:] = 1, 0
    ids[2, 5:], am[2, 5:] = 1, 0
    got = tx.xlmr_encode(params, cfg, torch.from_numpy(ids), torch.from_numpy(am).float())
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(am)).last_hidden_state
    valid = torch.from_numpy(am).bool()
    np.testing.assert_allclose(got[valid].numpy(), want[valid].numpy(), rtol=RTOL, atol=ATOL)


def test_load_pretrained_backbones_checks_the_config(hf_models):
    """The converted backbones replace the configured ones, on the
    parameters' device; a backbone of another shape raises."""
    audio_model, audio_cfg = hf_models["wavlm"]
    text_model, text_cfg = hf_models["xlmr"]
    cfg = tcfg.ModelConfig(adapter_dim=8, shared_dim=16, num_heads=4, proj_dim=32,
                           classifier_layers=2, classifier_base_dim=32,
                           audio=audio_cfg, text=text_cfg)
    params = tm.init_model(cfg, device="cpu")
    loaded = tm.load_pretrained_backbones(params, wav2vec2_state=audio_model.state_dict(),
                                          xlmr_state=text_model.state_dict())
    _assert_trees_equal(loaded["audio_backbone"],
                        conv.wav2vec2_from_hf(audio_model.state_dict()))
    _assert_trees_equal(loaded["text_backbone"], conv.xlmr_from_hf(text_model.state_dict()))
    assert loaded["classifier"] is params["classifier"]
    with pytest.raises(ValueError, match="audio_backbone"):
        tm.load_pretrained_backbones(params, wav2vec2_state=hf_models["wav2vec2"][0].state_dict())
    assert ref_convert.check_shapes("same", params, params) is None

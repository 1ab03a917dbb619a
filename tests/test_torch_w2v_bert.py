"""w2v-BERT 2.0 in the port (models/w2v_bert.py) on the CPU, at a tiny
conformer (2 layers, hidden 32, 4 heads, clamps 4 / 2, K = 5):

- the port's eval step against the benchmark's plain reference
  (perfbench/reference/w2v_bert.py) on weights drawn by
  perfbench/harness/weights.make_weights, in float32 and in bfloat16;
- the port against the published model's code: transformers'
  `Wav2Vec2BertModel` built from its config class with random weights
  (nothing is fetched) and converted by `hf_convert.w2v_bert_from_hf`,
  and the port's fbank against `SeamlessM4TFeatureExtractor`;
- the gathered relative-key term against Hugging Face's einsum, a padded
  clip against the clip alone, the int8 path's choice of products, the
  paths that do not take the conformer, and what the benchmark's check
  reads when the reference drops a mechanism."""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
    benchmark as tbench, evaluate as ev)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    hf_convert, model as tm, w2v_bert as wb, wav2vec2 as tw)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import quant
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.parallel import (
    tensor as ttensor)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
    leaves_with_paths)
from perfbench import reference as ref
from perfbench.harness import runner
from perfbench.reference import w2v_bert as ref_w2v_bert
from perfbench.tests.tiny import tiny_workload
from perfbench.tests.tiny_w2v_bert import tiny_w2v_bert_config

from torch_port_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CELL = "w2v_bert.bulk"
# float32, port against the reference: the same operations, which differ
# only where the two take other kernels for one sum (the gathered q @ E^T
# against the [S, S, D] einsum, einsum against matmul for q.k); a sum of
# at most a few hundred float32 terms moves in its last bits
F32_TOL = 1e-5
# float32, port against transformers: its pointwise convs are Conv1d and
# its q.k a matmul of another layout; tests/test_torch_hf_convert.py's
HF_RTOL, HF_ATOL = 5e-4, 5e-5
# the fbank against SeamlessM4TFeatureExtractor: the port's FFT and mel
# product are float32, the extractor's float64 (stored as complex64); a
# mel bin whose energy is ~1e-4 of its frame's carries ~1e-4 of relative
# error into its log, and the normalised features are O(1)
FBANK_ATOL = 5e-4


def tiny_audio(**kw) -> tcfg.Wav2Vec2Config:
    return tcfg.Wav2Vec2Config(**{**tiny_w2v_bert_config()["audio"], **kw})


def _setup(compute_dtype: str):
    return runner.set_up(CELL, 11, device="cpu", cfg=tiny_w2v_bert_config(compute_dtype),
                         workload=tiny_workload(CELL, batches=(4, 3, 2)))


def _outputs(c, program=None, cfg=None):
    """{batch: [B, C + 1]} of the port's step (or `program`) and of the
    reference at `cfg` (the cell's by default)."""
    program = program or runner.program_of(c)
    got, want = {}, {}
    with torch.inference_mode(), ref.plain_fp32():
        for i in range(len(c.host)):
            batch = runner._on_device(c.host[i], "cpu")
            got[i] = program(batch, c.extras[i])
            want[i] = c.entry.reference(ref, cfg or c.cfg, c.weights, batch, c.extras[i], c.args)
    return got, want


@pytest.fixture(scope="module")
def f32_cell():
    return _setup("float32")


def test_eval_step_equals_the_reference_in_float32(f32_cell):
    got, want = _outputs(f32_cell)
    for i in got:
        torch.testing.assert_close(got[i], want[i], rtol=F32_TOL, atol=F32_TOL)


def test_eval_step_equals_the_reference_in_bfloat16_and_the_f32_tolerance_sees_bf16():
    """In bfloat16 on the CPU the reference rounds where the port does and
    both take the same kernels: bit for bit. The float32 tolerance above is
    tight enough that the bfloat16 step, held to the float32 reference,
    fails it."""
    c = _setup("bfloat16")
    got, want = _outputs(c)
    f32 = {**c.cfg, "model": {**c.cfg["model"], "compute_dtype": "float32"}}
    _, exact = _outputs(c, cfg=f32)
    for i in got:
        assert torch.equal(got[i], want[i])
        assert all(v == 0.0 for v in c.entry.compare(got[i], want[i]).values())
        assert not torch.allclose(got[i], exact[i], rtol=F32_TOL, atol=F32_TOL)
        assert c.entry.compare(got[i], exact[i])["logit_gap"] > 1e-3


def test_gathered_relative_key_term_equals_the_einsum_form():
    g = torch.Generator().manual_seed(3)
    B, H, S, D, left, right = 2, 4, 37, 8, 4, 2
    q = torch.randn(B, S, H, D, generator=g)
    embed = torch.randn(left + right + 1, D, generator=g)
    index = wb.distance_index(S, left, right, torch.device("cpu"))
    gathered = torch.gather(torch.einsum("bqhd,rd->bhqr", q, embed), -1,
                            index.expand(B, H, S, S))
    einsum = ref_w2v_bert.relative_key_scores(q.transpose(1, 2), embed, S, left, right)
    torch.testing.assert_close(gathered, einsum, rtol=1e-6, atol=1e-6)
    assert index[0, 0] == left and index[0, -1] == left + right and index[-1, 0] == 0


def _clips(lengths, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(max(lengths)) / 16000.0
    voice = np.sin(2 * np.pi * 180 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return [(0.3 * voice[:n] + 0.05 * rng.standard_normal(n)).astype(np.float32)
            for n in lengths]


def _padded(clips):
    T = max(len(x) for x in clips)
    wave, mask = torch.zeros(len(clips), T), torch.zeros(len(clips), T)
    for i, x in enumerate(clips):
        wave[i, :len(x)] = torch.from_numpy(x)
        mask[i, :len(x)] = 1.0
    return wave, mask


def test_a_padded_clip_gets_what_it_gets_alone():
    cfg = tiny_audio()
    params = wb.init_w2v_bert(wb.layers.Init(torch.Generator().manual_seed(0), "cpu"), cfg)
    clips = _clips([16000, 37000, 23456])
    wave, mask = _padded(clips)
    with torch.inference_mode():
        h, fm = wb.w2v_bert_encode(params, cfg, wave, mask)
        for i, x in enumerate(clips):
            alone, am = wb.w2v_bert_encode(params, cfg, torch.from_numpy(x)[None],
                                           torch.ones(1, len(x)))
            S = alone.shape[1]
            assert torch.equal(fm[i, :S], am[0]) and fm[i, S:].sum() == 0
            torch.testing.assert_close(h[i, :S], alone[0], rtol=F32_TOL, atol=F32_TOL)


# ------------------------------------------------- against the published code

@pytest.fixture(scope="module")
def hf_model():
    from transformers import Wav2Vec2BertConfig, Wav2Vec2BertModel
    a = tiny_w2v_bert_config()["audio"]
    torch.manual_seed(0)
    model = Wav2Vec2BertModel(Wav2Vec2BertConfig(
        hidden_size=a["hidden_size"], num_hidden_layers=a["num_hidden_layers"],
        num_attention_heads=a["num_attention_heads"],
        intermediate_size=a["intermediate_size"],
        left_max_position_embeddings=a["left_max_position_embeddings"],
        right_max_position_embeddings=a["right_max_position_embeddings"],
        conv_depthwise_kernel_size=a["conv_depthwise_kernel_size"], layerdrop=0.0,
        apply_spec_augment=False))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():       # LN scales, biases off their init
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model.eval()


def _extracted(clips):
    from transformers import SeamlessM4TFeatureExtractor
    out = SeamlessM4TFeatureExtractor()(clips, sampling_rate=16000, return_tensors="pt",
                                        padding=True)
    return out["input_features"], out["attention_mask"].float()


def test_fbank_equals_the_feature_extractor_in_a_padded_batch():
    clips = _clips([16000, 37000, 23456, 48000], seed=9)
    want, want_mask = _extracted(clips)
    got, mask = wb.fbank(*_padded(clips))
    ref_got, ref_mask = ref_w2v_bert.fbank(*_padded(clips))
    S = got.shape[1]
    # the extractor pads the frames to an even count: one more stacked
    # position where the longest clip's frame count is odd, never valid
    assert want.shape[1] in (S, S + 1) and want_mask[:, S:].sum() == 0
    assert torch.equal(mask, want_mask[:, :S]) and torch.equal(ref_mask, mask)
    valid = mask.bool()
    torch.testing.assert_close(got[valid], want[:, :S][valid], rtol=0, atol=FBANK_ATOL)
    torch.testing.assert_close(ref_got[valid], want[:, :S][valid], rtol=0, atol=FBANK_ATOL)
    # an invalid position's second frame is padding, zero (its first may be
    # a clip's last, odd frame)
    assert (got[~valid][:, got.shape[-1] // 2:] == 0).all()


def test_encoder_on_converted_weights_equals_wav2vec2bertmodel(hf_model):
    clips = _clips([16000, 30000, 21111], seed=4)
    feats, mask = _extracted(clips)
    params = hf_convert.w2v_bert_from_hf(hf_model.state_dict())
    with torch.no_grad():
        want = hf_model(feats, attention_mask=mask.long()).last_hidden_state
        got = wb.conformer(params, tiny_audio(), feats, mask)
    valid = mask.bool()
    torch.testing.assert_close(got[valid], want[valid], rtol=HF_RTOL, atol=HF_ATOL)


def test_load_pretrained_backbones_takes_a_wav2vec2bert_state_dict(hf_model):
    cfg = tcfg.ModelConfig(audio=tiny_audio(), text=tcfg.XLMRConfig(
        vocab_size=100, hidden_size=16, num_hidden_layers=1, num_attention_heads=4,
        intermediate_size=32, max_position_embeddings=40))
    params = tm.init_model(cfg, device="cpu")
    loaded = tm.load_pretrained_backbones(params, wav2vec2_state=hf_model.state_dict())
    want = dict(leaves_with_paths(hf_convert.w2v_bert_from_hf(hf_model.state_dict())))
    got = dict(leaves_with_paths(loaded["audio_backbone"]))
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert set(hf_convert.audio_from_hf(hf_model.state_dict())) == {
        "feat_proj", "layers", "masked_spec_embed"}


def test_preset_is_wav2vec2bertconfigs_defaults():
    from transformers import Wav2Vec2BertConfig
    hf, port = Wav2Vec2BertConfig(), tcfg.AUDIO_BACKBONE_PRESETS["w2v-bert-2.0"]()
    for key in ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
                "layer_norm_eps", "left_max_position_embeddings", "right_max_position_embeddings",
                "conv_depthwise_kernel_size", "hidden_dropout", "attention_dropout",
                "activation_dropout"):
        assert getattr(port, key) == getattr(hf, key), key
    assert hf.position_embeddings_type == "relative_key" and not hf.add_adapter
    assert hf.feature_projection_input_dim == wb.FEATURE_DIM and hf.hidden_act == "swish"
    assert port.is_conformer and not tcfg.Wav2Vec2Config().is_conformer


def test_config_json_keeps_the_jax_packages_keys_for_the_wav2vec2_family():
    base = json.loads(tcfg.to_json(tcfg.ModelConfig()))
    assert "backbone" not in base["audio"] and "conv_depthwise_kernel_size" not in base["audio"]
    cfg = tcfg.ModelConfig(audio=tcfg.AUDIO_BACKBONE_PRESETS["w2v-bert-2.0"]())
    d = json.loads(tcfg.to_json(cfg))
    assert d["audio"]["backbone"] == "w2v-bert" and d["audio"]["conv_depthwise_kernel_size"] == 31
    assert tcfg.from_json(tcfg.to_json(cfg)) == cfg
    assert tcfg.from_json(json.dumps(base)) == tcfg.ModelConfig()
    with pytest.raises(NotImplementedError, match="backbone='conformer'"):
        tcfg.Wav2Vec2Config(backbone="conformer")


# --------------------------------------------------------- the port's paths

def test_int8_path_quantises_the_products_and_nothing_else():
    params = wb.init_w2v_bert(wb.layers.Init(torch.Generator().manual_seed(0), "cpu"),
                              tiny_audio())
    q = quant.quantize_backbones({"audio_backbone": params}, min_size=1)["audio_backbone"]
    stack = q["layers"]
    for name in ("q", "k", "v", "out", "ffn1_in", "ffn1_out", "ffn2_in", "ffn2_out",
                 "pointwise_in", "pointwise_out"):
        assert set(stack[name]) >= {"kernel_q", "w_scale"} and "kernel" not in stack[name]
    assert torch.equal(stack["depthwise"]["kernel"], params["layers"]["depthwise"]["kernel"])
    assert torch.equal(stack["rel_attn_embed"], params["layers"]["rel_attn_embed"])
    for name in ("ffn1_ln", "attn_ln", "conv_ln", "depthwise_ln", "ffn2_ln", "final_ln"):
        assert stack[name]["scale"].is_floating_point()
    assert q["feat_proj"]["proj"]["kernel"].is_floating_point()
    x = torch.from_numpy(np.stack(_clips([16000, 16000], seed=6)))
    with torch.inference_mode():
        a, _ = wb.w2v_bert_encode(params, tiny_audio(), x, torch.ones(2, 16000))
        b, _ = wb.w2v_bert_encode(q, tiny_audio(), x, torch.ones(2, 16000))
    assert torch.isfinite(b).all() and 0 < (a - b).abs().max() < 0.5


def test_training_forward_draws_dropout_and_runs_remat():
    cfg = dataclasses.replace(tiny_w2v_bert_model(), audio=tiny_audio(
        hidden_dropout=0.1, attention_dropout=0.1, activation_dropout=0.1))
    params = tm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    for _, leaf in leaves_with_paths(params["audio_backbone"]):
        leaf.requires_grad_(True)
    batch = _batch()
    out = tm.model_forward(params, cfg, batch, deterministic=False,
                           generator=torch.Generator().manual_seed(2), spec_augment=True)
    again = tm.model_forward(params, cfg, batch, deterministic=False,
                             generator=torch.Generator().manual_seed(2), spec_augment=True)
    plain = tm.model_forward(params, cfg, batch)
    assert torch.isfinite(out.logits).all() and torch.equal(out.logits, again.logits)
    assert not torch.equal(out.logits, plain.logits)
    out.logits.sum().backward()   # remat_encoders checkpoints each conformer layer
    layer = params["audio_backbone"]["layers"]
    for name in ("q", "depthwise", "pointwise_in"):
        assert torch.isfinite(layer[name]["kernel"].grad).all()
        assert layer[name]["kernel"].grad.abs().sum() > 0
    assert layer["rel_attn_embed"].grad.abs().sum() > 0


def tiny_w2v_bert_model() -> tcfg.ModelConfig:
    cfg = tiny_w2v_bert_config()
    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    return tcfg.ModelConfig(**tup(cfg["model"]), audio=tcfg.Wav2Vec2Config(**tup(cfg["audio"])),
                            text=tcfg.XLMRConfig(**tup(cfg["text"])))


def _batch(B=3, T=24000):
    wave, mask = _padded(_clips([T, 20000, 9000][:B], seed=5))
    g = torch.Generator().manual_seed(3)
    return {"audio": wave, "audio_mask": mask,
            "text_ids": torch.randint(2, 100, (B, 8), generator=g), "text_mask": torch.ones(B, 8)}


def test_paths_without_the_conformer_raise_naming_it():
    cfg = tiny_w2v_bert_model()
    with pytest.raises(NotImplementedError, match="w2v-bert"):
        ttensor.check_model_axis(cfg, 2)
    with pytest.raises(NotImplementedError, match="w2v-bert"):
        tbench.model_gflops_per_utt(cfg)
    with pytest.raises(NotImplementedError, match="w2v-bert"):
        tw.init_wav2vec2(wb.layers.Init(None, "meta"), cfg.audio)
    params = tm.init_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="w2v-bert"):
        tw.wav2vec2_encode(params["audio_backbone"], cfg.audio, torch.zeros(1, 8000),
                           torch.ones(1, 8000))
    with pytest.raises(NotImplementedError, match="w2v-bert"):
        tm.encode_audio(tm.encoder_params(params, cfg), cfg, torch.zeros(1, 8000),
                        torch.ones(1, 8000), tp=object())
    step = ev.make_eval_step(cfg, use_openmax=True, device="cpu")
    logits, _, _ = step(params, _batch())
    assert torch.isfinite(logits).all()


# ------------------------------------------------ what the check reads

def _centred(x, taps):
    K = taps.shape[0]
    return ref_w2v_bert._conv({"kernel": taps.t()[:, None, :]},
                              F.pad(x, ((K - 1) // 2, K // 2)), 1, groups=x.shape[1])


def _zero_relative_key(q, embed, S, left, right):
    return torch.zeros((*q.shape[:3], S), dtype=q.dtype)


@pytest.mark.parametrize("fault", ["no_relative_key", "centred_depthwise"])
def test_the_check_reads_a_reference_without_the_mechanism(f32_cell, monkeypatch, fault):
    """The reference with its relative-key term dropped, or with a centred
    depthwise conv, against the whole reference, in the check's units
    (entries/eval_step.gap), worst of the checked batches: far above the
    readings of a sound port (0 here, ~1e-5 on the card). PERF.md gives
    the readings against the cell's limits at full size on the card."""
    c = f32_cell
    _, whole = _outputs(c)
    if fault == "no_relative_key":
        monkeypatch.setattr(ref_w2v_bert, "relative_key_scores", _zero_relative_key)
    else:
        monkeypatch.setattr(ref_w2v_bert, "causal_depthwise", _centred)
    _, broken = _outputs(c)
    worst = max(c.entry.compare(broken[i], whole[i])["logit_gap"] for i in whole)
    assert worst > 1e-2

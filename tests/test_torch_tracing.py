"""The port's spans and counters (utils/profiling.py) on the CPU.

Off, a span is one shared no-op context and a count does nothing: a
forward records no `ser.*` range and moves no counter, and its outputs are
bitwise those of a traced forward. On, the spans nest as the calls do, each
DSP gate counts its read and whether its branch ran, and the prefetch
consumer counts the batches ready at each get. An exported program is the
same with tracing on and off. The card's count of host reads against the
`sync.*` spans is tests/test_torch_cuda.py's.
"""

import contextlib
import dataclasses
import time
from collections import Counter

import numpy as np
import pytest
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
    config as tcfg, export as tex)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import prefetch
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
    benchmark as tbench, evaluate as ev)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.frontend import (
    conditioning as tc)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    model as tm)
# the seven kernels' modules: each puts its key in the launch table when imported
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (  # noqa: F401
    attentive_pooling, conv_front, conv_tail, flash_attention, pos_conv, quant, residual_stack)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import profiling

from torch_port_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SR = 16000
B = 4
GATES = ("notch_hpf", "denoise", "dereverb")


def tiny_config(audio: tcfg.Wav2Vec2Config = tcfg.Wav2Vec2Config()) -> tcfg.Config:
    """A tiny model with the front-end DSP on, its audio backbone `audio`'s
    flags at tiny widths."""
    audio = dataclasses.replace(
        audio, conv_dim=(8, 8), conv_stride=(10, 8), conv_kernel=(10, 3), hidden_size=16,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=32,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, num_buckets=16,
        max_bucket_distance=40)
    return tcfg.Config(model=tcfg.ModelConfig(
        num_labels=4, adapter_dim=8, shared_dim=16, num_heads=4, proj_dim=32,
        classifier_layers=3, classifier_base_dim=32, audio=audio,
        text=tcfg.XLMRConfig(vocab_size=100, hidden_size=16, num_hidden_layers=2,
                             num_attention_heads=4, intermediate_size=32,
                             max_position_embeddings=40)))


def clean_tones(T=SR):
    """Speech-like tones with no hum, no low-frequency energy and no noise:
    no gate's branch is needed."""
    t = np.arange(T) / SR
    am = 1.0 + 0.6 * np.sin(2 * np.pi * 3.0 * t)
    row = am * (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 880 * t))
    return np.stack([row * (0.5 + 0.1 * i) for i in range(B)]).astype(np.float32)


def batch_of(audio: np.ndarray) -> dict:
    rng = np.random.default_rng(1)
    return {"audio": torch.from_numpy(audio), "audio_mask": torch.ones(audio.shape),
            "text_ids": torch.from_numpy(rng.integers(2, 100, (B, 10)).astype(np.int32)),
            "text_mask": torch.ones(B, 10), "lid_entropy": torch.ones(B),
            "lid_conf": torch.full((B,), 0.5)}


def worst_case():
    return batch_of(tbench.worst_case_dsp_audio(np.random.default_rng(5), B, SR)
                    .astype(np.float32))


@pytest.fixture(scope="module")
def model():
    cfg = tiny_config()
    return cfg, tm.init_model(cfg.model, torch.Generator().manual_seed(0), "cpu")


def draws():
    return [torch.randn(B, SR, generator=torch.Generator().manual_seed(s)) for s in (1, 2)]


def run_step(kind, cfg, params, batch) -> tuple:
    """The outputs of one eval step (plain, or 5-view TTA with its noise
    drawn here)."""
    if kind == "tta":
        return (ev.make_tta_eval_step(cfg, device="cpu")(params, batch, noise=draws()),)
    return ev.make_eval_step(cfg.model, use_openmax=True, device="cpu")(params, batch)


def recorded_spans(fn):
    """fn() under tracing and torch.profiler on the CPU: its `ser.*` ranges
    as (name without the prefix, start, end, thread), in start order."""
    with profiling.tracing(), torch.profiler.profile() as prof:
        fn()
    return sorted(((e.name[len(profiling.SPAN_PREFIX):], e.time_range.start,
                    e.time_range.end, e.thread) for e in prof.events()
                   if e.name.startswith(profiling.SPAN_PREFIX)), key=lambda s: s[1])


def inside(child, parent) -> bool:
    return child[3] == parent[3] and parent[1] <= child[1] and child[2] <= parent[2]


# ------------------------------------------------------------- tracing off

@pytest.mark.parametrize("why", ["off", "compiling"])
def test_span_is_one_shared_no_op(why, monkeypatch):
    """Off, or on while torch.compile or torch.export traces, every span is
    the same no-op context, and no span is a profiler range."""
    if why != "off":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with profiling.tracing() if why != "off" else contextlib.nullcontext():
        first, second = profiling.span("step"), profiling.span("heads")
    assert first is second
    assert not isinstance(first, torch.profiler.record_function)
    with first as entered:
        assert entered is None


def test_off_a_dsp_forward_records_no_span_and_moves_no_counter(model):
    cfg, params = model
    before = profiling.counters()
    with torch.profiler.profile() as prof:
        run_step("plain", cfg, params, worst_case())
    assert profiling.counters() == before
    assert not [e.name for e in prof.events() if e.name.startswith(profiling.SPAN_PREFIX)]


@pytest.mark.parametrize("kind", ["plain", "tta"])
def test_outputs_are_bitwise_the_same_with_tracing_on_and_off(model, kind):
    cfg, params = model
    off = run_step(kind, cfg, params, worst_case())
    with profiling.tracing():
        on = run_step(kind, cfg, params, worst_case())
    assert len(on) == len(off)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_tracing_restores_the_state_before_it_and_counts_by_name():
    assert not profiling._TRACING.on
    before = profiling.counters()
    with profiling.tracing():
        profiling.count("test.things", 3)
        with profiling.tracing():
            profiling.count("test.things")
        assert profiling._TRACING.on
    profiling.count("test.things", 100)   # off: not counted
    after = profiling.counters()
    assert not profiling._TRACING.on
    assert after["test.things"] - before.get("test.things", 0) == 4
    assert {k for k in after if k.endswith(".launches")} == {
        "residual_stack.launches", "attentive_stats_pooling.launches",
        "flash_attention.launches", "conv_front.launches", "conv_tail.launches",
        "pos_conv.launches", "int8_matmul.launches"}


# -------------------------------------------------------------- tracing on

NESTED = [("frontend", "step"), ("dsp.gates", "frontend"), ("dsp.conditioning", "frontend"),
          ("sync.dsp_notch_hpf", "dsp.conditioning"), ("sync.dsp_denoise", "frontend"),
          ("sync.dsp_dereverb", "frontend"), ("param_cast", "step"),
          ("audio_encoder", "step"), ("audio_encoder.conv", "audio_encoder"),
          ("text_encoder", "step"), ("heads", "step"), ("classifier", "heads")]


@pytest.mark.parametrize("kind", ["plain", "tta"])
def test_spans_nest_as_the_calls_do(model, kind):
    cfg, params = model
    spans = recorded_spans(lambda: run_step(kind, cfg, params, worst_case()))
    names = Counter(s[0] for s in spans)
    want = {"step": 1, "frontend": 1, "dsp.gates": 1, "dsp.conditioning": 1,
            "param_cast": 1, "audio_encoder": 1, "audio_encoder.conv": 1, "text_encoder": 1,
            "heads": 1, "classifier": 1, "tta_expand": int(kind == "tta"),
            **{f"sync.dsp_{g}": 1 for g in GATES}}
    assert names == Counter({k: v for k, v in want.items() if v}), names
    for child, parent in NESTED + ([("tta_expand", "step")] if kind == "tta" else []):
        c = next(s for s in spans if s[0] == child)
        assert any(inside(c, p) for p in spans if p[0] == parent), (child, parent)
    assert not inside(next(s for s in spans if s[0] == "text_encoder"),
                      next(s for s in spans if s[0] == "audio_encoder"))


def test_a_wavlm_forward_records_its_bucket_table_read_once():
    cfg = tiny_config(tcfg.AUDIO_BACKBONE_PRESETS["wavlm-large"]())
    params = tm.init_model(cfg.model, torch.Generator().manual_seed(1), "cpu")
    batch = {k: v[:, :SR // 4] if k in ("audio", "audio_mask") else v
             for k, v in worst_case().items()}
    spans = recorded_spans(lambda: run_step("plain", cfg, params, batch))
    reads = [s for s in spans if s[0] == "sync.wavlm_bucket_table"]
    assert len(reads) == 1
    assert any(inside(reads[0], p) for p in spans if p[0] == "audio_encoder")
    assert Counter(s[0] for s in spans if s[0].startswith("sync."))["sync.dsp_denoise"] == 1


def test_a_w2v_bert_forward_records_its_spans_and_counts_its_frames():
    cfg = tiny_config(tcfg.AUDIO_BACKBONE_PRESETS["w2v-bert-2.0"]())
    params = tm.init_model(cfg.model, torch.Generator().manual_seed(1), "cpu")
    batch = worst_case()
    S = ((SR - 400) // 160 + 1) // 2
    before = profiling.counters()
    spans = recorded_spans(lambda: run_step("plain", cfg, params, batch))
    after = profiling.counters()
    assert after["conformer.frames"] - before.get("conformer.frames", 0) == B * S
    names = Counter(s[0] for s in spans)
    layers = cfg.model.audio.num_hidden_layers
    assert (names["audio_encoder.fbank"], names["audio_encoder.conformer"],
            names["conformer.attention"], names["conformer.conv_module"]) == (1, 1, layers, layers)
    assert "audio_encoder.conv" not in names
    for child, parent in (("audio_encoder.fbank", "audio_encoder"),
                          ("audio_encoder.conformer", "audio_encoder"),
                          ("conformer.attention", "audio_encoder.conformer"),
                          ("conformer.conv_module", "audio_encoder.conformer")):
        for c in (s for s in spans if s[0] == child):
            assert any(inside(c, p) for p in spans if p[0] == parent), (child, parent)


@pytest.mark.parametrize("audio", ["worst_case", "clean"])
def test_each_gate_counts_its_read_and_whether_its_branch_ran(model, audio):
    """Three reads a forward, one a gate. On the worst case the notch/HPF
    and denoise branches run; on clean tones no branch is needed (each
    gate's own predicate, from the conditioning's flags) and none runs;
    the dereverb branch never runs on real audio (T60 stays at 0.1 s)."""
    cfg, params = model
    batch = worst_case() if audio == "worst_case" else batch_of(clean_tones())
    _, stats = tc.condition_audio(batch["audio"], batch["audio_mask"])
    needed = {"notch_hpf": bool((stats.hum_filtered | stats.hpf_applied).any()),
              "denoise": bool(stats.denoise_applied.any()),
              "dereverb": bool(stats.dereverb_applied.any())}
    assert needed == {"notch_hpf": audio == "worst_case", "denoise": audio == "worst_case",
                      "dereverb": False}
    before = profiling.counters()
    with profiling.tracing():
        run_step("plain", cfg, params, batch)
    after = profiling.counters()
    delta = {k: v - before.get(k, 0) for k, v in after.items()}
    for g in GATES:
        assert delta[f"dsp.{g}.reads"] == 1, g
        assert delta[f"dsp.{g}.taken"] == int(needed[g]), g


def _host_batches(n, slow_host):
    for i in range(n):
        if slow_host:
            time.sleep(0.03)
        yield {"audio": np.full((2, 8), i, np.float32)}


@pytest.mark.parametrize("slow", ["consumer", "host"])
def test_prefetch_counts_the_batches_ready_at_each_get(slow):
    """A slow consumer finds the queue full (`depth` ready); a slow host
    iterator leaves it empty at every get."""
    depth, n = 2, 10
    before = profiling.counters()
    with profiling.tracing():
        it = prefetch.device_prefetch(_host_batches(n, slow == "host"), "cpu", depth=depth)
        seen = []
        for batch, _ in it:
            seen.append(int(batch["audio"][0, 0]))
            if slow == "consumer":
                time.sleep(0.03)
    after = profiling.counters()
    assert seen == list(range(n))
    gets = after["prefetch.gets"] - before.get("prefetch.gets", 0)
    ready = (after["prefetch.ready"] - before.get("prefetch.ready", 0)) / gets
    assert gets == n + 1                         # the last get takes the end marker
    if slow == "consumer":
        assert ready >= depth - 0.5
    else:
        assert ready <= 0.5


def test_an_export_is_the_same_program_with_tracing_on_and_off(model):
    cfg, _ = model
    mcfg = dataclasses.replace(cfg.model, frontend_dsp=False)
    params = tm.init_model(mcfg, torch.Generator().manual_seed(2), "cpu")
    T = SR // 4
    example = {"audio": torch.zeros(2, T), "audio_mask": torch.ones(2, T),
               "text_ids": torch.ones(2, 8, dtype=torch.int32), "text_mask": torch.ones(2, 8),
               "quality_feats": torch.zeros(2, 8), "cond_feats": torch.zeros(2, 12)}

    def code():
        with torch.no_grad():
            program = torch.export.export(tex._Forward(mcfg, True, T), (params, example),
                                          strict=False)
        return program.graph_module.code

    off = code()
    with profiling.tracing():
        on = code()
    assert on == off
    assert "record_function" not in on

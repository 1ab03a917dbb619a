"""The frozen counts against the port's own arithmetic."""

import pytest

from perfbench.counts import flops
from perfbench.harness import registry, runner


@pytest.mark.parametrize("config", ["flagship", "wavlm_large"])
def test_frozen_flops_equal_the_ports_at_4s_one_clip(config):
    port = runner.import_port()
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import benchmark
    cfg = registry.config_file(registry.load_benchmark(), config)
    ours = flops.model_gflops_per_utt(cfg, audio_seconds=4.0, text_tokens=32)
    theirs = benchmark.model_gflops_per_utt(runner.model_config(port, cfg),
                                            audio_seconds=4.0, text_tokens=32)
    assert ours == theirs


def test_step_flops_of_one_clip_is_the_utterance_count():
    cfg = registry.config_file(registry.load_benchmark(), "flagship")
    one = flops.step_flops(cfg, audio_rows=1, text_rows=1, samples=64000, text_tokens=32)
    assert one == pytest.approx(flops.model_gflops_per_utt(cfg)["total_gflops"] * 1e9)


def test_tta_step_counts_text_once_a_clip():
    cfg = registry.config_file(registry.load_benchmark(), "flagship")
    parts = flops.utt_flops_parts(cfg, 64000, 32)
    text = parts["text_transformer"] + parts["text_adapter"]
    tta = flops.step_flops(cfg, audio_rows=5 * 8, text_rows=8, samples=64000, text_tokens=32)
    bulk = flops.step_flops(cfg, audio_rows=5 * 8, text_rows=5 * 8, samples=64000,
                            text_tokens=32)
    assert bulk - tta == pytest.approx(4 * 8 * text)


def test_a1_counts_as_the_kernel_table():
    # PERF.md's table of kernels: bound 0.0220 ms by bytes at B=4, 0.0701 ms
    # by operations at B=128 (35 layers at width 512)
    assert flops.a1_least_seconds(4, 35, 512) * 1e3 == pytest.approx(0.0220, abs=5e-5)
    assert flops.a1_least_seconds(128, 35, 512) * 1e3 == pytest.approx(0.0701, abs=5e-5)
    assert flops.a1_flops(128, 35, 512) == 4 * 128 * 512 * 512 * 35

"""The cell w2v_bert.bulk: its configuration against the port's preset, a
run at a tiny size on the CPU through the runner, the readers of its
per-layer metrics on a recorded trace, and its FLOP count by hand."""

import io

import pytest

from perfbench.counts import conformer_flops, flops, peaks
from perfbench.harness import registry, runner, trace
from perfbench.tests.tiny import tiny_workload
from perfbench.tests.tiny_w2v_bert import tiny_w2v_bert_config

BENCH = registry.load_benchmark()
CELL = "w2v_bert.bulk"
NEW = ("fbank_device_ms", "conformer_device_ms", "conformer_attn_device_ms",
       "conformer_conv_device_ms", "w2v_bert_step_mfu")
# the accepted metrics of the layers this cell shares with the others (the
# wav2vec2 family's conv extractor, step_mfu's count and the TTA expansion
# have nothing to read here)
SHARED = ("prefetch_wait_ms", "host_syncs_per_step", "param_cast_device_ms", "dsp_device_ms",
          "audio_enc_device_ms", "text_enc_device_ms", "heads_device_ms",
          "classifier_device_ms", "a1_roofline", "device_idle_share", "sync_idle_ms",
          "launch_idle_ms")


def test_the_config_file_is_the_ports_preset_and_the_cell_is_wavlms_stream():
    port = runner.import_port()
    cfg = registry.config_file(BENCH, "w2v_bert")
    got = runner.model_config(port, cfg)
    assert got.audio == port.config.AUDIO_BACKBONE_PRESETS[cfg["port_audio_preset"]]()
    assert got.text == port.config.XLMRConfig()
    ours, wavlm = registry.workload_file(CELL), registry.workload_file("wavlm_large.bulk")
    assert ours["params"] == wavlm["params"] and ours["args"] == wavlm["args"]
    assert ours["check_batches"] == wavlm["check_batches"]
    assert (ours["entry"], ours["generator"]) == ("conformer_eval_step", "labelling")
    assert set(registry.metrics_for(BENCH, CELL, trace=True)) == set(NEW) | set(SHARED)


def test_a_tiny_run_on_the_cpu_is_correct():
    out, err = io.StringIO(), io.StringIO()
    result = runner.run_cell(CELL, 2 ** 31 + 12345, 0.2, True, device="cpu",
                             cfg=tiny_w2v_bert_config(),
                             workload=tiny_workload(CELL, batches=(2, 2, 1)), out=out, err=err)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert all(x["value"] == 0.0 for x in result["checks"].values())
    # off the card the trace holds host events alone: the new device readers
    # find nothing, the count over the host's window reads
    assert "w2v_bert_step_mfu" in result["metrics"]
    assert not set(result["metrics"]) & {"fbank_device_ms", "conformer_device_ms",
                                         "conformer_attn_device_ms", "conformer_conv_device_ms"}


def _host(name, start, end, corr=0):
    return {"name": name, "start": start, "end": end, "thread": 1, "corr": corr}


def test_readers_on_a_recorded_trace():
    """A window [0, 10] on one thread: fbank [1, 2]; conformer [2, 8]
    holding two layers' self_attention [2.5, 3], [5, 5.5] and conv_module
    [3.5, 4], [6, 6.5]; a kernel of 0.5 s launched inside each range."""
    host = [_host("perfbench.window", 0, 10), _host("perfbench.fbank", 1, 2),
            _host("perfbench.conformer", 2, 8),
            _host("perfbench.self_attention", 2.5, 3), _host("perfbench.conv_module", 3.5, 4),
            _host("perfbench.self_attention", 5, 5.5), _host("perfbench.conv_module", 6, 6.5)]
    device = []
    for corr, at in enumerate((1.5, 2.7, 3.7, 4.5, 5.2, 6.2), start=1):
        host.append(_host("cudaLaunchKernel", at, at + 0.01, corr=corr))
        device.append({"name": f"k{corr}", "start": at + 0.1, "end": at + 0.6, "corr": corr,
                       "link": 0})
    tr = trace.reduce(host, device, main_thread=1)
    tr["batches"] = [{"audio_rows": 32}, {"audio_rows": 64}]
    cfg = registry.config_file(BENCH, "w2v_bert")
    batches = [{"audio_rows": 64, "text_rows": 64, "samples": 64000, "text_tokens": 32}] * 3
    record = {"config": cfg, "window_s": 2.0, "batches": batches, "trace": tr}
    get = lambda m: registry.load_module("metrics", m).read(record)
    assert get("fbank_device_ms") == pytest.approx(1e3 * 0.5 / 2)
    assert get("conformer_device_ms") == pytest.approx(1e3 * 2.5 / 2)
    assert get("conformer_attn_device_ms") == pytest.approx(1e3 * 1.0 / 2)
    assert get("conformer_conv_device_ms") == pytest.approx(1e3 * 1.0 / 2)
    one = conformer_flops.step_flops(cfg, audio_rows=64, text_rows=64, samples=64000,
                                     text_tokens=32)
    assert get("w2v_bert_step_mfu") == pytest.approx(100 * 3 * one / 2.0 / peaks.BF16_FLOPS)
    # another configuration, or a trace without the ranges: nothing to read
    bare = {**trace.reduce(host[:1], [], main_thread=1), "batches": tr["batches"]}
    other = {**record, "config": registry.config_file(BENCH, "wavlm_large"), "trace": bare}
    for m in NEW:
        assert registry.load_module("metrics", m).read(other) is None


def test_conformer_flops_by_hand():
    cfg = registry.config_file(BENCH, "w2v_bert")
    # a 4 s clip: 398 fbank frames, 199 positions; h 1024, f 4096, 24 layers
    S, h, f, L = 199, 1024, 4096, 24
    layer = (2 * 2 * 2 * S * h * f        # two FFNs
             + 4 * 2 * S * h * h          # q, k, v, out
             + 2 * S * h * 2 * h + 2 * S * h * h   # the pointwise convs
             + 2 * 2 * S * S * h          # q.k and p.v
             + 2 * S * 73 * h             # q @ E^T over 73 distances
             + 2 * S * h * 31)            # the depthwise conv
    hand = 2 * 398 * 257 * 80 + 2 * S * 160 * h + L * layer
    parts = conformer_flops.conformer_parts(cfg, 64000)
    assert sum(v for k, v in parts.items() if k != "frames") == hand
    assert parts["frames"] == S
    # the rest is flops.py's, at S frames: the same as wavlm_large's at its
    # own S = 199 for 4 s, whose heads and text side are the same widths
    rest = conformer_flops.other_parts(cfg, 64000, 32)
    wavlm = flops.utt_flops_parts(registry.config_file(BENCH, "wavlm_large"), 64000, 32)
    for k in ("cross", "audio_adapter", "pool", "fusion", "classifier", "text_transformer",
              "text_adapter"):
        assert rest[k] == wavlm[k], k
    step = conformer_flops.step_flops(cfg, audio_rows=64, text_rows=64, samples=64000,
                                      text_tokens=32)
    per_row = hand + sum(rest[k] for k in ("audio_adapter", "cross", "pool", "fusion",
                                           "classifier", "text_transformer", "text_adapter"))
    assert step == pytest.approx(64 * per_row)

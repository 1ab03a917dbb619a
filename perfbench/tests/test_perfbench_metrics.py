"""Each metric's arithmetic on a synthetic record and trace: range
attribution by correlation id, the idle union, the percentile over every
sample."""

import pytest

from perfbench.counts import flops, peaks
from perfbench.harness import readers, registry, trace


def _host(name, start, end, thread=1, corr=0):
    return {"name": name, "start": start, "end": end, "thread": thread, "corr": corr}


def _events():
    """A window [0, 10] on thread 1: encode_audio [1, 5] holding
    feature_encoder [1, 2]; model_heads [6, 9] holding classifier_forward
    [7, 8]. Launches (corr 1..5) and the kernels they issue; a copy issued
    by another thread (corr 6)."""
    host = [
        _host("perfbench.window", 0.0, 10.0),
        _host("perfbench.encode_audio", 1.0, 5.0),
        _host("perfbench.feature_encoder", 1.0, 2.0),
        _host("perfbench.model_heads", 6.0, 9.0),
        _host("perfbench.classifier_forward", 7.0, 8.0),
        _host("cudaLaunchKernel", 1.5, 1.6, corr=1),          # in feature_encoder
        _host("cudaLaunchKernel", 3.0, 3.1, corr=2),          # in encode_audio only
        _host("cudaLaunchKernel", 6.5, 6.6, corr=3),          # heads
        _host("cudaLaunchCooperativeKernel", 7.5, 7.6, corr=4),   # classifier
        _host("cudaLaunchKernel", 9.5, 9.6, corr=5),          # window only
        _host("cudaMemcpyAsync", 0.5, 0.6, thread=2, corr=6),
        _host("aten::mm", 3.0, 3.2, corr=2),                 # an operator sharing an id
        _host("aten::conv", 1.5, 1.7, corr=90),
        _host("aten::mm", 4.5, 4.6, corr=91),                # in encode_audio
    ]
    device = [
        {"name": "conv", "start": 2.0, "end": 3.0, "corr": 1, "link": 90},
        {"name": "gemm", "start": 3.5, "end": 5.5, "corr": 2, "link": 0},
        {"name": "attn", "start": 6.6, "end": 7.0, "corr": 3, "link": 0},
        {"name": "residual_stack_kernel", "start": 7.6, "end": 8.6, "corr": 4, "link": 0},
        {"name": "tail", "start": 9.6, "end": 10.5, "corr": 5, "link": 0},   # past the window
        {"name": "Memcpy HtoD", "start": 0.6, "end": 1.0, "corr": 6, "link": 0},
        {"name": "gemm", "start": 4.0, "end": 5.0, "corr": 77, "link": 91},  # by its operator
    ]
    return host, device


def test_reduce_attributes_each_operation_to_the_ranges_open_at_its_launch():
    host, device = _events()
    tr = trace.reduce(host, device, main_thread=1)
    assert tr["window_s"] == 10.0
    assert tr["range_s"]["feature_encoder"] == pytest.approx(1.0)
    assert tr["range_s"]["encode_audio"] == pytest.approx(1.0 + 2.0 + 1.0)
    assert tr["range_s"]["model_heads"] == pytest.approx(0.4 + 1.0)
    assert tr["range_s"]["classifier_forward"] == pytest.approx(1.0)
    assert tr["self_s"]["(no range)"] == pytest.approx(0.4)        # the other thread's copy
    assert tr["self_s"]["window"] == pytest.approx(0.4)            # clipped at the window's end
    assert tr["kernel_s"]["gemm"] == (2, pytest.approx(3.0))
    assert tr["unattributed_s"] == 0
    # busy: [0.6, 1] + [2, 3] + [3.5, 5.5] + [6.6, 7] + [7.6, 8.6] + [9.6, 10]
    assert tr["busy_s"] == pytest.approx(0.4 + 1.0 + 2.0 + 0.4 + 1.0 + 0.4)
    idle = tr["idle_by_host_range"]
    assert sum(idle.values()) == pytest.approx(10.0 - tr["busy_s"])
    assert idle["model_heads"] == pytest.approx(9.6 - 8.6)
    assert idle["classifier_forward"] == pytest.approx(7.6 - 7.0)
    assert idle["window"] == pytest.approx(0.6 + (6.6 - 5.5))
    assert idle["feature_encoder"] == pytest.approx(1.0)          # [1, 2]: the host in it
    assert idle["encode_audio"] == pytest.approx(0.5)             # [3, 3.5]


def test_union_and_gaps():
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == [(0, 1), (3, 4), (5, 6)]
    assert trace.gaps([], 0, 1) == [(0, 1)]


def _record(trace_):
    cfg = registry.config_file(registry.load_benchmark(), "flagship")
    batches = [{"clips": 4, "audio_rows": 4, "text_rows": 4, "samples": 64000,
                "text_tokens": 32, "latency_s": 0.1 * (i + 1), "wait_s": 0.001 * i}
               for i in range(20)]
    return {"setup_s": 12.5, "window_s": 4.0, "batches": batches, "config": cfg,
            "args": {}, "trace": trace_}


def test_end_to_end_readers():
    r = _record(None)
    get = lambda m: registry.load_module("metrics", m).read(r)
    assert get("utt_per_s") == pytest.approx(80 / 4.0)
    assert get("p95_ms") == pytest.approx(1900.0)                 # the 19th of 20
    assert get("setup_s") == 12.5
    assert get("prefetch_wait_ms") == pytest.approx(9.5)
    for m in ("dsp_device_ms", "device_idle_share", "a1_roofline", "host_syncs_per_step"):
        assert get(m) is None                                     # nothing to read


def test_percentile_takes_every_sample():
    assert readers.percentile(list(range(1, 101)), 95) == 95
    assert readers.percentile([3.0], 95) == 3.0
    assert readers.percentile([5, 1, 4, 2, 3], 50) == 3


def test_trace_readers():
    host, device = _events()
    tr = trace.reduce(host, device, main_thread=1)
    tr["batches"] = [{"audio_rows": 128}]
    tr["host_syncs"] = 3
    r = _record(tr)
    get = lambda m: registry.load_module("metrics", m).read(r)
    assert get("audio_enc_device_ms") == pytest.approx(4000.0)
    assert get("conv_extractor_device_ms") == pytest.approx(1000.0)
    assert get("heads_device_ms") == pytest.approx(400.0)
    assert get("classifier_device_ms") == pytest.approx(1000.0)
    assert get("dsp_device_ms") is None                            # never ran
    assert get("host_syncs_per_step") == 3
    assert get("device_idle_share") == pytest.approx(100 * (1 - 5.2 / 10))
    assert get("a1_roofline") == pytest.approx(100 * flops.a1_least_seconds(128, 35, 512) / 1.0)
    tr["batches"] = [{"audio_rows": 128}, {"audio_rows": 64}]      # the mean of the steps'
    least = (flops.a1_least_seconds(128, 35, 512) + flops.a1_least_seconds(64, 35, 512)) / 2
    assert get("a1_roofline") == pytest.approx(100 * least / 1.0)
    tr["kernel_s"] = {}
    assert get("a1_roofline") is None


def test_step_mfu():
    r = _record(None)
    per = flops.step_flops(r["config"], audio_rows=4, text_rows=4, samples=64000, text_tokens=32)
    got = registry.load_module("metrics", "step_mfu").read(r)
    assert got == pytest.approx(100 * 20 * per / 4.0 / peaks.BF16_FLOPS)


def test_breakdown_lists_the_longest():
    host, device = _events()
    b = trace.breakdown(trace.reduce(host, device, main_thread=1), n=2)
    assert b["device_ops"][0] == ["gemm", pytest.approx(3.0)]
    assert len(b["device_ops"]) == 2 and len(b["idle_gaps"]) == 2


def test_stacks_at_nests():
    ranges = [("a", 0, 10), ("b", 2, 5), ("c", 3, 4), ("d", 6, 7)]
    assert trace.stacks_at(ranges, [1, 3.5, 4.5, 6.5, 11]) == [
        ("a",), ("a", "b", "c"), ("a", "b"), ("a", "d"), ()]

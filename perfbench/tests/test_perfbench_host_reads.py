"""The split of the card's idle time inside the step (harness/host_reads.py
and its two readers): on hand-made profiler events, a gap that begins in a
host read counts as sync idle, one that begins inside the step with no read
innermost as launch idle, one in the copy to the host as neither; a port
without the read functions, or a window with no device work, gives neither
number; and a tiny step of each configuration calls the reads through the
attributes the traced window wraps."""

import importlib

import pytest

from perfbench.harness import host_reads, registry, runner, trace
from perfbench.tests.tiny import tiny_config, tiny_workload

NEW = ("sync_idle_ms", "launch_idle_ms")


def _host(name, start, end, thread=1, corr=0):
    return {"name": name, "start": start, "end": end, "thread": thread, "corr": corr}


def _record(read: str, device=None) -> dict:
    """A window [0, 20] on thread 1 of two batches. The step [1, 12] holds
    the DSP [1.5, 5], which reads the card back in [3, 4], and the heads
    [8, 11]; the copy to the host is [12, 14]. Device idle: [0, 2] (before
    the step's work), [3.6, 5.2] (begins in the read), [7, 8.5] (in the
    step, launching), [12.5, 16] (in the copy)."""
    host = [
        _host("perfbench.window", 0.0, 20.0),
        _host("perfbench.step", 1.0, 12.0),
        _host("perfbench.frontend_features", 1.5, 5.0),
        _host("perfbench." + read, 3.0, 4.0),
        _host("perfbench.model_heads", 8.0, 11.0),
        _host("perfbench.to_host", 12.0, 14.0),
        _host("cudaLaunchKernel", 1.6, 1.7, corr=1),
        _host("cudaMemcpyAsync", 3.0, 3.1, corr=2),
        _host("cudaLaunchKernel", 4.5, 4.6, corr=3),
        _host("cudaLaunchKernel", 8.2, 8.3, corr=4),
        _host("cudaLaunchKernel", 15.5, 15.6, corr=5),
    ]
    if device is None:
        device = [
            {"name": "stft", "start": 2.0, "end": 3.5, "corr": 1, "link": 0},
            {"name": "Memcpy DtoH", "start": 3.5, "end": 3.6, "corr": 2, "link": 0},
            {"name": "denoise", "start": 5.2, "end": 7.0, "corr": 3, "link": 0},
            {"name": "attn", "start": 8.5, "end": 12.5, "corr": 4, "link": 0},
            {"name": "next", "start": 16.0, "end": 20.0, "corr": 5, "link": 0},
        ]
    reduced = trace.reduce(host, device, main_thread=1)
    return {"trace": {**reduced, "batches": [{}, {}]}}


def _read(metric: str, record: dict):
    return registry.load_module("metrics", metric).read(record)


@pytest.mark.parametrize("read", [attr for _, attr in host_reads.READS])
def test_idle_gaps_split_by_what_the_host_was_doing(read):
    record = _record(read)
    sync, launch = _read("sync_idle_ms", record), _read("launch_idle_ms", record)
    assert sync == pytest.approx(1e3 * (5.2 - 3.6) / 2)           # began in the read
    assert launch == pytest.approx(1e3 * (8.5 - 7.0) / 2)         # in the step
    idle_ms = 1e3 * (2.0 + 1.6 + 1.5 + 3.5) / 2                  # the window's and to_host's: neither
    tr = record["trace"]
    assert idle_ms == pytest.approx(1e3 * (tr["window_s"] - tr["busy_s"]) / 2)
    assert sync + launch < idle_ms


def test_a_read_the_port_does_not_make_is_launch_idle():
    record = _record("some_other_function")
    assert _read("sync_idle_ms", record) == 0.0
    assert _read("launch_idle_ms", record) == pytest.approx(1e3 * (5.2 - 3.6 + 8.5 - 7.0) / 2)


def test_without_reads_device_work_or_trace_nothing_is_read(monkeypatch):
    for record in ({"trace": None}, _record("read_gate", device=[])):
        for m in NEW:
            assert _read(m, record) is None, m
    record = _record("read_gate")
    for mod_name, attr in host_reads.READS:     # a port that reads elsewhere
        monkeypatch.delattr(f"{runner.PORT}.{mod_name}.{attr}")
    assert not host_reads.port_has_reads()
    for m in NEW:
        assert _read(m, record) is None, m


def test_the_readers_wrap_the_reads_in_every_cell():
    bench = registry.load_benchmark()
    for cell in ("flagship.bulk", "wavlm_large.bulk", "flagship.tta"):
        listed = registry.metrics_for(bench, cell, True)
        for m in NEW:
            assert m in listed
            assert registry.load_module("metrics", m).RANGES == host_reads.READS


@pytest.mark.parametrize("cell,audio,reads", [
    ("flagship.bulk", "group", {"read_gate": 3}),
    ("wavlm_large.bulk", "layer", {"read_gate": 3, "device_bucket_table": 1}),
])
def test_a_step_calls_the_reads_through_the_wrapped_attributes(cell, audio, reads):
    from torch.profiler import ProfilerActivity, profile
    c = runner.set_up(cell, 2**31 + 17, device="cpu", cfg=tiny_config(audio=audio),
                      workload=tiny_workload(cell))
    program = runner.program_of(c)
    batch = runner._on_device(c.host[0], c.device)
    with trace.wrapped(runner.PORT, host_reads.READS):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            program(batch, c.extras[0])
    host, _ = trace.profiler_events(prof)
    names = [e["name"][len(trace.PREFIX):] for e in host if e["name"].startswith(trace.PREFIX)]
    assert {attr: names.count(attr) for _, attr in host_reads.READS
            if attr in names} == reads
    for mod_name, attr in host_reads.READS:                # the port's own functions again
        assert getattr(importlib.import_module(f"{runner.PORT}.{mod_name}"), attr).__name__ == attr

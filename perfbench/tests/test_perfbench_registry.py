"""Discovery by name, and BENCHMARK.json against the files it names."""

import dataclasses
import json
import re

import pytest

from perfbench.harness import registry, runner

BENCH = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_config_and_metric_resolves_by_name():
    for c in BENCH["configs"]:
        cfg = registry.config_file(BENCH, c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
    for w in BENCH["workloads"]:
        wl = registry.workload_file(w["name"])
        assert (wl["config"], wl["traffic"], wl["why"]) == (w["config"], w["traffic"], w["why"])
        registry.load_module("entries", wl["entry"])
        registry.load_module("traffic", wl["generator"])
        assert set(wl["limits"]) >= {"logit_gap"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(registry.load_module("metrics", m["name"]).read)
    assert set(registry.load_folder("metrics")) == {
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}


def test_a_new_file_is_found_by_its_name(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "new.metric.py").write_text("def read(record):\n    return 1.5\n")
    monkeypatch.setattr(registry, "BENCH_DIR", tmp_path)
    assert registry.load_module("metrics", "new.metric").read({}) == 1.5
    assert list(registry.load_folder("metrics")) == ["new.metric"]


def test_metrics_for_follows_each_metrics_cells():
    got = registry.metrics_for(BENCH, "flagship.bulk", trace=True)
    assert "tta_expand_device_ms" not in got and "a1_roofline" in got
    assert "tta_expand_device_ms" in registry.metrics_for(BENCH, "flagship.tta", trace=True)
    assert set(registry.metrics_for(BENCH, "flagship.bulk", trace=False)) == {
        "utt_per_s", "p95_ms", "setup_s"}


@pytest.mark.parametrize("config", ["flagship", "wavlm_large"])
def test_config_files_are_the_ports_presets(config):
    port = runner.import_port()
    cfg = registry.config_file(BENCH, config)
    preset = port.config.AUDIO_BACKBONE_PRESETS[cfg["port_audio_preset"]]()
    got = runner.model_config(port, cfg)
    assert got.audio == preset
    assert got.text == port.config.XLMRConfig()
    want = port.config.ModelConfig(compute_dtype="bfloat16", audio=preset)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_benchmark_json_keeps_the_contracts_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer",
                                                "moves", "workloads"}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200

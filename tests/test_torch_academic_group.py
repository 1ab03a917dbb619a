"""The port's academic battery (eval/academic.py) under a process group of
two gloo ranks on the CPU, mesh (2, 1), against the same battery on one
process, on tests/test_torch_academic.py's 24-clip manifest and tiny model.

Each rank's batch cache holds its rows of every batch; every pass gathers
its rows over 'data' in one process's order, the Gaussian noise is the
global batch's draw, the few-shot adaptation runs the whole K-shot batches
on every rank. So every section of the results equals one process's
exactly, but for the timings (the benchmark's and `part_seconds`), which
are rank 0's on both ranks; rank 0 alone writes the JSON and the report."""

import json

import pytest

from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
    tokenizer as ttok)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
    academic as tacad)

from test_torch_academic import SECTIONS, UNKNOWN, setup
from torch_port_helpers import one_torch_thread, two_ranks

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TIMED = ("part_seconds", "inference_benchmark", "report")


def rank_battery(params, cfg, manifest, output_dir):
    return tacad.run_academic_evaluation(
        params, cfg, manifest, batch_size=8, tokenizer=ttok.HashTokenizer(vocab_size=100),
        device="cpu", output_dir=output_dir, run_benchmark=True, run_few_shot=True,
        few_shot_shots=[4, 8], few_shot_epochs=1, full_ft_f1=0.9, run_robustness=True,
        robustness_snr_levels=[20.0, 0.0], zero_shot_languages=("hi", "bn", "te"),
        open_set_unknown_class=UNKNOWN, verbose=False)


def _untimed_report(report: str) -> list:
    return [line for line in report.splitlines() if not line.startswith("Throughput:")]


def test_battery_on_two_ranks_equals_one_process(two_ranks, setup, tmp_path):
    root, _, cfg, _, params = setup
    manifest = str(root / "val.jsonl")
    want = rank_battery(params, cfg, manifest, str(tmp_path / "one"))
    got = two_ranks.run(rank_battery, params, cfg, manifest, str(tmp_path / "pod"))
    assert got[0]["baseline"]["num_samples"] == 24
    for res in got:
        assert list(res) == SECTIONS + ["report"]
        for section in SECTIONS:
            if section not in TIMED:
                assert res[section] == want[section], section
        assert _untimed_report(res["report"]) == _untimed_report(want["report"])
        for section in TIMED:      # rank 0's timings on every rank
            assert res[section] == got[0][section], section
    assert res["inference_benchmark"]["params"] == want["inference_benchmark"]["params"]
    assert sorted(p.name for p in (tmp_path / "pod").iterdir()) == [
        "academic_evaluation.json", "academic_report.txt"]
    saved = json.loads((tmp_path / "pod" / "academic_evaluation.json").read_text())
    assert saved["few_shot"] == got[0]["few_shot"]
    assert (tmp_path / "pod" / "academic_report.txt").read_text() == got[0]["report"]

"""A whole run, past the look for a card, with a tiny model on the CPU:
sound, it is correct; with its timed step broken underneath, `correct`
comes out false, at tiny batches and at the cells' own clips a batch. The
faults a labelling cell can have: half of the batch left out, its rows
answered by the mean over the rest; one answer altered where it is
produced. (No cell trains, and none spans chips: a state left unchanged
and a missing exchange between chips do not arise.)"""

import io

import pytest

from perfbench.harness import registry, runner
from perfbench.tests.tiny import tiny_config, tiny_workload


def half_left_out(program):
    def step(batch, extra):
        out = program(batch, extra).clone()
        h = max(1, out.shape[0] // 2)
        out[h:] = out[:h].mean(0)
        return out
    return step


def answer_altered(program):
    def step(batch, extra):
        out = program(batch, extra).clone()
        out[0, 0] += out[:, 0].abs().mean()
        return out
    return step


def _run(cell, fault=None, batches=(4, 4, 4)):
    err = io.StringIO()
    if batches == "cell":
        batches = [b["batch"] for b in registry.workload_file(cell)["params"]["buckets"]]
    result = runner.run_cell(cell, 2**31 + 5, 0.5, False, device="cpu", cfg=tiny_config(),
                             workload=tiny_workload(cell, batches=batches), fault=fault,
                             out=io.StringIO(), err=err)
    return result, err.getvalue()


@pytest.mark.parametrize("cell", ["flagship.bulk", "flagship.tta"])
def test_a_sound_run_is_correct_and_prints_its_numbers_last(cell):
    result, err = _run(cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    tail = err.strip().splitlines()[-len(result["checks"]):]
    for line, (name, c) in zip(tail, result["checks"].items()):
        assert line == f"check {name} {c['value']!r} limit {c['limit']!r}"
    assert set(result["metrics"]) == {"utt_per_s", "p95_ms", "setup_s"}


@pytest.mark.parametrize("batches", [(4, 4, 4), "cell"])
@pytest.mark.parametrize("cell", ["flagship.bulk", "flagship.tta"])
@pytest.mark.parametrize("fault", [half_left_out, answer_altered])
def test_a_broken_step_is_not_correct(cell, fault, batches):
    result, _ = _run(cell, fault, batches)
    assert result["correct"] is False
    caught = "logit_gap" if fault is half_left_out else "worst_row_gap"
    assert result["checks"][caught]["value"] > result["checks"][caught]["limit"]


def test_a_non_finite_answer_fails_the_run():
    def nan_row(program):
        def step(batch, extra):
            out = program(batch, extra).clone()
            out[-1] = float("nan")
            return out
        return step
    result, _ = _run("flagship.bulk", nan_row)
    assert result["correct"] is False and result["failed"] > 0

"""The check's control on the card, at each cell's own size: the port's
step as the configuration states it stays within the limits, its int8
path (ops/quant.quantize_backbones, a precision below the configuration's
bfloat16) does not. Skips without a card:

    python -m pytest perfbench/tests/test_perfbench_control.py -m cuda -q
"""

import pytest
import torch

from perfbench import control
from perfbench.harness import registry

CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_int8_control_is_not_correct_and_the_step_is(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    limits = registry.workload_file(cell)["limits"]
    got = control.measure(cell, 424242)
    assert all(got["program"][k] <= limits[k] for k in limits)
    assert any(got["control"][k] > limits[k] for k in limits)


def test_the_epilogue_reading_moves_a_rounding_point_and_nothing_else():
    """On the CPU at a tiny bf16 size (no matrix large enough for the int8
    path), the program equals the reference, and the reference with its
    biases added before the rounding does not."""
    from perfbench.tests.tiny import tiny_config, tiny_workload
    got = control.measure("flagship.bulk", 7, device="cpu", cfg=tiny_config("bfloat16"),
                          workload=tiny_workload("flagship.bulk", batches=(4, 3, 2)),
                          epilogue=True)
    assert all(v == 0.0 for v in got["program"].values())
    assert all(v > 0.0 for v in got["epilogue"].values())

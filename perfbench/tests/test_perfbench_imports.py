"""What a run loads: no JAX, no flax, not the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference nothing of the port."""

import json
import subprocess
import sys

from perfbench.harness.runner import FORBIDDEN, PORT

from .conftest import ROOT

RUN = f"""
import io, json, sys
sys.path.insert(0, {str(ROOT)!r})
from perfbench.harness import registry, runner
from perfbench.tests.tiny import tiny_config, tiny_workload
for folder in ("metrics", "entries", "traffic"):
    registry.load_folder(folder)
runner.run_cell("flagship.tta", 3, 0.2, True, device="cpu", cfg=tiny_config(),
                workload=tiny_workload("flagship.tta", batches=(1, 1, 1)),
                out=io.StringIO(), err=io.StringIO())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import perfbench.reference, perfbench.counts.flops
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_not_the_jax_package():
    loaded = _loaded(RUN)
    assert PORT in loaded
    assert not loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded(REFERENCE)
    assert not loaded & (set(FORBIDDEN) | {PORT})

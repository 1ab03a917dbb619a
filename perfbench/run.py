#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on one CUDA card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells, metrics and configurations are
BENCHMARK.json's; each cell's parameters are perfbench/workloads/<cell>.json.
The last line of standard output is the result object; the numbers the
check compared, each with its limit, are the last lines of standard error.
Without a CUDA card, or with fewer than the cell asks for, it exits with 2
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda_cache"}


def process_age() -> float:
    """Seconds since this process started (Linux /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    started = time.perf_counter() - process_age()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in CACHES.items():   # every build and kernel cache inside the checkout
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))

    import torch
    from perfbench.harness import registry, runner

    bench = registry.load_benchmark(ROOT)
    chips = registry.cell_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: cell {args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             device="cuda", started=started, bench=bench)
    bad = runner.forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}; nothing it runs may",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Throughput and peak memory of one cell at scaled batch sizes, on one
CUDA card: the sweep that a cell's batch sizes are chosen from.

    python3 perfbench/sweep.py --workload <cell> --scales 0.5 1 2 4 [--seconds 8]
        [--repeats 1] [--seed 1]

Each scale multiplies every bucket's clips a batch. For each, in one
process: the cell's set-up at those sizes, one warm pass of each bucket,
then the timed loop of a run for --seconds, --repeats times. Prints one
JSON line a scale: the batch sizes, utt/s and the nearest-rank p95 of a
batch's latency of each repeat, the batches completed, and the peak of
allocated memory. A scale that runs out of memory prints its error and
ends the sweep. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(cell: str, scale: float, seed: int, seconds: float, repeats: int = 1) -> dict:
    import torch
    from perfbench.harness import registry, runner, window as window_lib
    workload = copy.deepcopy(registry.workload_file(cell))
    for b in workload["params"]["buckets"]:
        b["batch"] = max(1, int(round(b["batch"] * scale)))
    torch.cuda.reset_peak_memory_stats()
    c = runner.set_up(cell, seed, device="cuda", workload=workload)
    program = runner.program_of(c)
    warmed = set()
    for i, m in enumerate(c.meta):
        if m["bucket_seconds"] not in warmed:
            program(runner._on_device(c.host[i], c.device), c.extras[i]).cpu()
            warmed.add(m["bucket_seconds"])
    torch.cuda.synchronize()
    rates, p95s, completed = [], [], []
    stream = window_lib.Stream(c.port.prefetch.device_prefetch, c.host, c.device)
    try:
        for _ in range(repeats):
            win = window_lib.run(stream, program, c.extras, seconds=seconds)
            lat = sorted(d["latency_s"] for d in win["done"])
            rates.append(sum(c.meta[d["index"]]["clips"] for d in win["done"]) / win["window_s"])
            p95s.append(1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)])
            completed.append(len(lat))
    finally:
        stream.close()
    return {"cell": cell, "scale": scale,
            "batches": [b["batch"] for b in workload["params"]["buckets"]],
            "utt_per_s": rates, "p95_ms": p95s, "completed": completed,
            "memory_peak_bytes": torch.cuda.max_memory_allocated()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--scales", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    for scale in args.scales:
        try:
            line = one(args.workload, scale, args.seed, args.seconds, args.repeats)
        except torch.cuda.OutOfMemoryError as e:
            print(json.dumps({"cell": args.workload, "scale": scale,
                              "error": str(e).splitlines()[0]}), flush=True)
            return 0
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

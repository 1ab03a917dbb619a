#!/usr/bin/env python3
"""Readings that the check's limits are set from, on one CUDA card.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 ... [--out FILE]

For each seed, in one process: the cell's set-up (weights, stream), then
the batches a run of that seed would check, through the port's step as
the configuration states it (the sound reading) and through the port's
int8 path (`ops/quant.quantize_backbones`, the control: the step that
computes a precision below the configuration's bfloat16), each at the
cell's own batch sizes; then the reference once, and each compared
number of both. With --epilogue, also the reference with every bias
added in float32 to the float32 product before the one rounding to the
compute dtype (as a fused epilogue would), judged as the program is: how
far a sound change of rounding order reads. Prints one JSON line a seed
and, with --out, writes them all. The benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def epilogue_linear(p: dict, x):
    """reference.model.linear with the bias added before the rounding."""
    y = x.float() @ p["kernel"].float()
    return (y + p["bias"].float() if "bias" in p else y).to(x.dtype)


def measure(cell_name: str, seed: int, *, device="cuda", cfg=None, workload=None,
            err=None, raw: Path = None, epilogue: bool = False) -> dict:
    """{"program": numbers, "control": numbers, ...} for one seed; with
    `raw`, the outputs of both and the reference's go to
    raw/<cell>_<seed>.pt."""
    import torch
    from perfbench.harness import runner
    err = err or io.StringIO()
    t0 = time.perf_counter()
    c = runner.set_up(cell_name, seed, device=device, cfg=cfg, workload=workload)
    done = [{"index": i} for i in range(len(c.meta))]
    picked = runner.sample_batches(done, c.meta, c.workload["check_batches"], seed)
    readings = {}
    for label, control in (("program", False), ("control", True)):
        program = runner.program_of(c, control)
        outputs = {i: program(runner._on_device(c.host[i], c.device), c.extras[i]).cpu()
                   for i in picked}
        del program
        if c.device.type == "cuda":
            torch.cuda.empty_cache()
        readings[label] = outputs
    expected = runner.references(c, picked)
    if epilogue:
        from perfbench.reference import model as ref_model
        plain = ref_model.linear
        ref_model.linear = epilogue_linear
        try:
            readings["epilogue"] = runner.references(c, picked)
        finally:
            ref_model.linear = plain
    numbers = {label: runner.judge(c, outs, expected, err) for label, outs in readings.items()}
    if raw is not None:
        raw.mkdir(parents=True, exist_ok=True)
        torch.save({"reference": expected, **readings}, raw / f"{cell_name}_{seed}.pt")
    return {"cell": cell_name, "seed": seed, "batches": picked, **numbers,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--raw", type=Path, default=None)
    ap.add_argument("--epilogue", action="store_true")
    args = ap.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    lines = []
    for seed in args.seeds:
        line = measure(args.workload, seed, raw=args.raw, epilogue=args.epilogue)
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())

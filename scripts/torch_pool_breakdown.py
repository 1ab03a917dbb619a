#!/usr/bin/env python3
"""Where kernel A2's bf16 route (csrc/attentive_pooling.cu:pool_wgmma) spends
its time on one GPU.

Usage (from the root of a checkout, on a machine with a CUDA device):
    python3 scripts/torch_pool_breakdown.py [--batch 4 128]

At both pooling sites of the flagship (`pool_a` [B, 199, 768], `pool_t`
[B, 32, 768], H=128, bf16, inputs as chip_smoke.py makes them) it prints
one JSON line per batch size with:
  * device_ms: the kernel alone after a 128 MB write that flushes the L2,
    with a spin kernel queued first so that the host has issued the launch
    before the card reaches it (chip_smoke.flushed_ms: the wrapper's
    Python time is not counted);
  * device_ms_warm: the same without the flush, 20 launches back to back;
  * host_ms: the wrapper's own time per call on the host clock;
  * span_us, waves: the first block's start to the last block's end on the
    card's global timer, and how many blocks ran one after another on an SM;
  * phases_us: per block (median, and the slowest), from the SM clock
    stamps the kernel writes when given a stamp buffer: the first x panel
    and W1 chunk arriving, the score products of the first tile, its tanh
    epilogue and softmax, its statistics pass, the block's further tiles,
    and the cluster combine and output.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (L2_FLUSH_BYTES, POOL_HIDDEN, POOLING_SITES, SPIN_CYCLES,  # noqa: E402
                        flushed_ms, pooling_inputs)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (  # noqa: E402
    attentive_pooling as ap)

PHASES = ("first_arrival", "products", "epilogue_softmax", "statistics", "more_tiles",
          "combine_output")


def device_ms_warm(fn, iters: int) -> float:
    torch.cuda._sleep(SPIN_CYCLES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / iters


def breakdown(stamps: torch.Tensor) -> dict:
    """Phase times (us) from the blocks' stamps, each block's SM clock
    turned into time by its own clock and timer spans."""
    s = stamps.view(-1, ap.STAMPS).cpu().double()
    g0, c = s[:, 0], s[:, 1:8]
    g1, sm = s[:, 8], s[:, 9].long()
    ghz = (c[:, 6] - c[:, 0]) / (g1 - g0).clamp(min=1)   # cycles per ns
    phases = (c[:, 1:] - c[:, :-1]) / ghz[:, None] / 1e3
    per_sm = torch.bincount(sm)
    return {"blocks": s.shape[0], "span_us": float(g1.max() - g0.min()) / 1e3,
            "waves": int(per_sm.max()), "sm_ghz_median": float(ghz.median()),
            "block_us_median": float((g1 - g0).median()) / 1e3,
            "phases_us_median": {k: float(v) for k, v in zip(PHASES, phases.median(0).values)},
            "phases_us_max": {k: float(v) for k, v in zip(PHASES, phases.max(0).values)}}


def main() -> int:
    ap_ = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap_.add_argument("--batch", type=int, nargs="+", default=[4, 128])
    args = ap_.parse_args()
    if not torch.cuda.is_available():
        print("torch_pool_breakdown: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    ap.build()
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    for site, (S, D) in POOLING_SITES.items():
        for B in args.batch:
            params, x, mask = pooling_inputs(torch, B, S, D, torch.bfloat16, seed=S)
            p = ap.plan(B, S, D, POOL_HIDDEN, num_sms)
            call = lambda: ap.attentive_stats_pooling(params, x, mask)  # noqa: E731
            for _ in range(3):
                call()
            stamps = torch.zeros(p.blocks * ap.STAMPS, dtype=torch.int64, device="cuda")
            flush.zero_()
            ap._launch_bf16(params, x, mask, p, stamps)
            torch.cuda.synchronize()
            print(json.dumps({
                "site": site, "B": B, "S": S, "D": D, "H": POOL_HIDDEN, "plan": p._asdict(),
                "device_ms": flushed_ms(call, flush, 30),
                "device_ms_warm": device_ms_warm(call, 20), "host_ms": host_ms(call, 50),
                **breakdown(stamps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

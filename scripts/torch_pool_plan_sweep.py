#!/usr/bin/env python3
"""Kernel A2's bf16 route (csrc/attentive_pooling.cu:pool_wgmma) under other
plans than `ops/attentive_pooling.plan` picks, on one GPU.

Usage (from the root of a checkout, on a machine with a CUDA device):
    python3 scripts/torch_pool_plan_sweep.py

At the flagship's audio pooling site (`pool_a` [B, 199, 768], H=128, bf16,
inputs as chip_smoke.py makes them) it prints one JSON line per plan with
its device time (chip_smoke.flushed_ms: L2 flushed, host time not counted),
the error against the plain version, and the per-block phases of
scripts/torch_pool_breakdown.py:
  * W1 chunk rows (16, 32, 64, 128) at each ring depth that fits, for the
    plan's cluster of 4 blocks of one tile each (B=4 and B=128);
  * blocks per row (cluster) against tiles per block, 4 x 1, 2 x 2 and
    1 x 4, at B=4, 64 and 128, with 128-row chunks.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import L2_FLUSH_BYTES, POOL_HIDDEN, flushed_ms, pooling_inputs  # noqa: E402
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (  # noqa: E402
    attentive_pooling as ap)
from torch_pool_breakdown import breakdown  # noqa: E402

S, D, H = 199, 768, POOL_HIDDEN


def run(B: int, p: ap.Plan, flush, params, x, mask, want) -> dict:
    got = ap._launch_bf16(params, x, mask, p)
    torch.cuda.synchronize()
    stamps = torch.zeros(p.blocks * ap.STAMPS, dtype=torch.int64, device="cuda")
    flush.zero_()
    ap._launch_bf16(params, x, mask, p, stamps)
    torch.cuda.synchronize()
    b = breakdown(stamps)
    return {"B": B, "cluster": p.cluster, "tiles": p.tiles, "chunk": p.chunk, "depth": p.depth,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "device_ms": flushed_ms(lambda: ap._launch_bf16(params, x, mask, p), flush, 20),
            "blocks": p.blocks, "waves": b["waves"], "block_us_median": b["block_us_median"],
            "phases_us_median": b["phases_us_median"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_pool_plan_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    ap.build()
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    for B in (4, 64, 128):
        params, x, mask = pooling_inputs(torch, B, S, D, torch.bfloat16, seed=S)
        want = ap.attentive_stats_pooling_plain(params, x, mask)
        base = ap.plan(B, S, D, H, num_sms)
        plans = []
        if B != 64:
            for chunk in (16, 32, 64, 128):
                for depth in (2, 3, 4, 7, 8):
                    p = base._replace(cluster=4, tiles=1, chunk=chunk, depth=depth,
                                      smem_bytes=ap.smem_bytes(D, H, chunk, depth, 4))
                    if p.smem_bytes <= ap.MAX_SMEM:
                        plans.append(p)
        for cluster, tiles in ((4, 1), (2, 2), (1, 4)):
            plans.append(base._replace(
                cluster=cluster, tiles=tiles, chunk=128, depth=3,
                smem_bytes=ap.smem_bytes(D, H, 128, 3, cluster)))
        for p in plans:
            print(json.dumps(run(B, p, flush, params, x, mask, want)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

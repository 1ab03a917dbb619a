#!/usr/bin/env python3
"""Where the PyTorch port's flagship eval forward spends its time on one GPU.

Usage (from the root of a checkout, on a machine with a CUDA device):
    python3 scripts/torch_profile_forward.py [--batch 4 128] [--dsp on off] [--out DIR]

For each batch size and front-end setting (4 s clips, 32 text tokens,
random weights from seed 0, compute_dtype bfloat16) it prints one JSON line.
With the DSP on, the batch carries no front-end features, so model_forward
runs the front-end DSP on worst-case audio (chip_smoke.worst_case_dsp_audio:
the notch, HPF and denoise gates fire); off, it carries zero features and
noise audio, as before the DSP was ported. Each line has:
  * stage_ms: host clock around each stage of model_forward, synchronised
    (parameter cast, front-end DSP, wav2vec2 + adapter + feature fusion,
    XLM-R + adapter, cross-attention + pooling + fusion + classifier);
  * forward_ms: the whole model_forward, synchronised;
  * device_busy_ms / device_idle_share: the union of the kernels' time
    intervals in a torch.profiler trace of one forward, against its wall
    time (a union, so nothing is counted twice);
  * top_kernels: the device kernels with the most total time.
With --out, the profiler's table is also written to DIR/profile_B<B>.txt.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import worst_case_dsp_audio  # noqa: E402
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (  # noqa: E402
    ModelConfig)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (  # noqa: E402
    model as mdl)


def example_batch(B, T, S, vocab, device, dsp, seed=0):
    rng = np.random.default_rng(seed)
    audio_mask = np.ones((B, T), np.float32)
    audio_mask[0, T // 2:] = 0
    ids = rng.integers(2, vocab, (B, S)).astype(np.int64)
    text_mask = np.ones((B, S), np.float32)
    ids[:, S // 2:] = 1
    text_mask[:, S // 2:] = 0
    batch = {"audio_mask": audio_mask, "text_ids": ids, "text_mask": text_mask}
    if dsp:
        batch["audio"] = worst_case_dsp_audio(B, T, seed) * audio_mask
    else:
        batch.update(audio=rng.standard_normal((B, T)).astype(np.float32) * 0.1,
                     quality_feats=np.zeros((B, 8), np.float32),
                     cond_feats=np.zeros((B, 12), np.float32))
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def union_ms(intervals) -> float:
    """Length of the union of (start, end) intervals in microseconds, as ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def stages(params, cfg, batch):
    """Host-clock time of each stage of model_forward, synchronised."""
    dtype = torch.bfloat16
    ms = {}
    p, ms["cast"] = timed(lambda: mdl.encoder_params(params, cfg))
    (wave, quality_feats, cond_feats), ms["dsp"] = timed(
        lambda: mdl.frontend_features(cfg, batch))
    (a_seq, a_mask), ms["audio"] = timed(lambda: mdl.encode_audio(
        p, cfg, wave.to(dtype), batch["audio_mask"],
        quality_feats=quality_feats, cond_feats=cond_feats))
    (t_seq, t_mask), ms["text"] = timed(lambda: mdl.encode_text(
        p, cfg, batch["text_ids"], batch["text_mask"]))
    _, ms["heads"] = timed(lambda: mdl.model_heads(params, cfg, a_seq, a_mask,
                                                   t_seq, t_mask))
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[4, 128])
    ap.add_argument("--dsp", choices=("on", "off"), nargs="+", default=["on", "off"])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_forward: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    cfg = ModelConfig(compute_dtype="bfloat16")
    params = mdl.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    for B, dsp in itertools.product(args.batch, args.dsp):
        batch = example_batch(B, 4 * 16000, 32, cfg.text.vocab_size, "cuda", dsp == "on")
        for _ in range(2):
            mdl.model_forward(params, cfg, batch)
        stage_ms = stages(params, cfg, batch)
        fwd = sorted(timed(lambda: mdl.model_forward(params, cfg, batch))[1]
                     for _ in range(5))
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _, wall_ms = timed(lambda: mdl.model_forward(params, cfg, batch))
        cuda = torch.autograd.DeviceType.CUDA
        busy_ms = union_ms([(e.time_range.start, e.time_range.end)
                            for e in prof.events() if e.device_type == cuda])
        events = [e for e in prof.key_averages() if e.device_type == cuda]
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            (args.out / f"profile_B{B}_dsp_{dsp}.txt").write_text(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=40))
        print(json.dumps({
            "B": B, "dsp": dsp, "card": card, "forward_ms": fwd[len(fwd) // 2],
            "stage_ms": stage_ms, "profiled_wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "ms": e.self_device_time_total / 1e3} for e in top]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

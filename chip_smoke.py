#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each:
  1. device   the card (nvidia-smi's name and power limit on a line of its own)
  2. build    nvcc builds every kernel of the path from csrc/ (sm_90a)
  3. kernel   each kernel against its plain PyTorch version on the card, at
              the main path's shapes, with times and the card's bound
  4. agree    a small model on the card against the same model on the CPU
  5. path     the flagship eval forward (wav2vec2-base + XLM-R-base ->
              35-layer OpenMax head, bf16) through `model_forward`, at B=4
              (a few requests) and at B=128 with 4 s clips; every launch
              counter is set to 0 before and read after each run
Then the `kernels` line and, last, {"ok": true, "device": {...}}.

Any failure raises and exits non-zero; a machine without a CUDA device
exits 1 before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores
KERNEL_TOL = 1e-4            # kernel vs plain: summation order over K=512 x 35 layers
AGREE_TOL = {"float32": 1e-4,   # card vs CPU, TF32 off: summation order only
             "bfloat16": 3e-2}  # bf16 rounding at other places (the JAX package's bf16 bound)
REQUESTS_B4 = 5
REQUESTS_B128 = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tiny_config(compute_dtype: str):
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
        ModelConfig, Wav2Vec2Config, XLMRConfig)
    return ModelConfig(
        num_labels=4, adapter_dim=8, shared_dim=16, num_heads=4, proj_dim=32,
        classifier_layers=3, classifier_base_dim=32, frontend_dsp=False,
        compute_dtype=compute_dtype,
        audio=Wav2Vec2Config(conv_dim=(8, 8), conv_stride=(10, 8),
                             conv_kernel=(10, 3), hidden_size=16,
                             num_hidden_layers=2, num_attention_heads=4,
                             intermediate_size=32, num_conv_pos_embeddings=16,
                             num_conv_pos_embedding_groups=4),
        text=XLMRConfig(vocab_size=100, hidden_size=16, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=32,
                        max_position_embeddings=40))


def example_batch(B: int, T: int, S: int, vocab: int, seed: int = 0) -> dict:
    """The flagship entry's batch: row 0's audio half masked, every row's
    text half padded, zero front-end features."""
    rng = np.random.default_rng(seed)
    audio_mask = np.ones((B, T), np.float32)
    audio_mask[0, T // 2:] = 0
    ids = rng.integers(2, vocab, (B, S)).astype(np.int32)
    text_mask = np.ones((B, S), np.float32)
    ids[:, S // 2:] = 1
    text_mask[:, S // 2:] = 0
    return {"audio": rng.standard_normal((B, T)).astype(np.float32) * 0.1,
            "audio_mask": audio_mask, "text_ids": ids, "text_mask": text_mask,
            "quality_feats": np.zeros((B, 8), np.float32),
            "cond_feats": np.zeros((B, 12), np.float32)}


def residual_stack_inputs(torch, B: int, L: int, D: int, seed: int):
    """Classifier-stack parameters with non-trivial LN and bias values."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    a = (6.0 / (2 * D)) ** 0.5
    uni = lambda *s: (torch.rand(*s, device="cuda", generator=g) * 2 - 1) * a
    stacked = {
        "ln_pre": {"scale": 1 + 0.1 * rnd(L, D), "bias": 0.1 * rnd(L, D)},
        "block_ln": {"scale": 1 + 0.1 * rnd(L, D), "bias": 0.1 * rnd(L, D)},
        "block_lin1": {"kernel": uni(L, D, D), "bias": 0.1 * rnd(L, D)},
        "block_lin2": {"kernel": uni(L, D, D), "bias": 0.1 * rnd(L, D)},
    }
    return stacked, rnd(B, D)


def residual_stack_bound(B: int, L: int, D: int):
    """Least time on an H100 (ms) and what bounds it: each input read once
    and the output written once, against the f32 FMAs of the two products."""
    nbytes = 4 * (2 * B * D + L * (2 * D * D + 6 * D))
    flops = 2 * 2 * B * L * D * D
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
        ModelConfig)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as mdl)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
        _build, residual_stack as rs)

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    rs.build()
    emit({"phase": "build", "kernels": ["residual_stack"],
          "seconds": time.perf_counter() - t0,
          "ptxas": [ln for ln in (_build.BUILD_DIR / "residual_stack.log")
                    .read_text().splitlines() if "registers" in ln or "spill" in ln]})

    # 3. kernel against its plain version
    L, D = 35, 512
    rs.residual_stack.launches = 0
    errs = {}
    for B in (1, 3, 4, 8, 11, 128):
        stacked, x = residual_stack_inputs(torch, B, L, D, seed=B)
        got = rs.residual_stack(stacked, x)
        want = rs.residual_stack_plain(stacked, x)
        torch.cuda.synchronize()
        errs[B] = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL):
            raise AssertionError(f"residual_stack B={B}: max |kernel - plain| "
                                 f"{errs[B]} over tolerance {KERNEL_TOL}")
    if rs.residual_stack.launches != 6:
        raise AssertionError(f"residual_stack launched {rs.residual_stack.launches} "
                             "times for 6 calls")
    timing = {}
    for B in (4, 128):
        stacked, x = residual_stack_inputs(torch, B, L, D, seed=B)
        bound_ms, bound_by = residual_stack_bound(B, L, D)
        timing[B] = {
            "ms": cuda_ms(lambda: rs.residual_stack(stacked, x), 50),
            "plain_ms": cuda_ms(lambda: rs.residual_stack_plain(stacked, x), 10),
            "bound_ms": bound_ms, "bound_by": bound_by}
    emit({"phase": "kernel", "name": "residual_stack", "L": L, "D": D,
          "tol": KERNEL_TOL, "max_abs_err": errs, "timing": timing})

    # 4. small model on the card against the CPU
    rng = np.random.default_rng(7)
    B, T, S = 4, 800, 10
    audio_mask = np.ones((B, T), np.float32)
    audio_mask[1, 600:] = 0
    ids = rng.integers(2, 100, (B, S)).astype(np.int32)
    text_mask = np.ones((B, S), np.float32)
    ids[2, 6:] = 1
    text_mask[2, 6:] = 0
    small = {"audio": rng.standard_normal((B, T)).astype(np.float32),
             "audio_mask": audio_mask, "text_ids": ids, "text_mask": text_mask,
             "quality_feats": rng.standard_normal((B, 8)).astype(np.float32),
             "cond_feats": rng.standard_normal((B, 12)).astype(np.float32)}
    for dtype, tol in AGREE_TOL.items():
        cfg = tiny_config(dtype)
        cpu_params = mdl.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
        want = mdl.model_forward(cpu_params, cfg, small)
        got = mdl.model_forward(tree_to(cpu_params, "cuda"), cfg, small)
        torch.cuda.synchronize()
        diffs = {}
        for field, g, w in zip(want._fields, got, want):
            g, w = g.float().cpu(), w.float()
            diffs[field] = float((g - w).abs().max())
            if not torch.allclose(g, w, rtol=tol, atol=tol):
                raise AssertionError(f"{dtype} {field}: card vs CPU max diff "
                                     f"{diffs[field]} over tolerance {tol}")
        emit({"phase": "agree", "dtype": dtype, "tol": tol, "max_abs_diff": diffs})

    # 5. the flagship eval forward
    cfg = ModelConfig(compute_dtype="bfloat16")
    params = mdl.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    path = {}
    launches = 0
    for B, requests in ((4, REQUESTS_B4), (128, REQUESTS_B128)):
        batch = example_batch(B, T=4 * 16000, S=32, vocab=cfg.text.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        rs.residual_stack.launches = 0
        times = []
        for _ in range(requests):
            t0 = time.perf_counter()
            out = mdl.model_forward(params, cfg, batch)
            logits = out.logits.cpu()
            times.append(time.perf_counter() - t0)
        count = rs.residual_stack.launches
        if count != requests:
            raise AssertionError(f"B={B}: residual_stack launched {count} times "
                                 f"in {requests} forwards")
        launches += count
        if tuple(logits.shape) != (B, cfg.num_labels) or not torch.isfinite(logits).all():
            raise AssertionError(f"B={B}: logits {tuple(logits.shape)} not finite "
                                 f"({B}, {cfg.num_labels})")
        for field, v in zip(out._fields, out):
            if not torch.isfinite(v.float()).all():
                raise AssertionError(f"B={B}: {field} is not finite")
        warm = sorted(times[1:])
        ms = 1e3 * warm[len(warm) // 2]
        path[B] = {"requests": requests, "first_ms": 1e3 * times[0], "ms": ms,
                   "utt_per_s": B / (ms / 1e3),
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "residual_stack_launches": count}
        emit({"phase": "path", "B": B, "seconds": 4.0, "text_tokens": 32,
              "card": smi, **path[B]})

    t4 = timing[4]
    emit({"kernels": [{
        "name": "residual_stack", "route": "cuda",
        "source": "multilingual_multimodal_speech_emotion_recognition_tpu_torch/csrc/residual_stack.cu",
        "replaces": "multilingual_multimodal_speech_emotion_recognition_tpu/ops/pallas_kernels.py:114",
        "launches": launches, "max_abs_err": max(errs.values()), "tol": KERNEL_TOL,
        "ms": t4["ms"], "kernel_ms": t4["ms"], "plain_ms": t4["plain_ms"],
        "bound_ms": t4["bound_ms"], "bound_by": t4["bound_by"], "library_ms": None,
        "B": 4, "at_B128": timing[128]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

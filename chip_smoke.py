#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each:
  1. device   the card (nvidia-smi's name and power limit on a line of its own)
  2. build    nvcc builds every kernel from csrc/ (sm_90a), one process per
              source, all started together
  3. kernel   each kernel against its plain PyTorch version on the card, at
              its paths' shapes, with times, the card's bound, the share of
              it reached (ms / bound_ms), TFLOP/s where products bound it,
              A1's and A2's plans and their repeats held bitwise equal,
              A2 also timed alone after a write that flushes the L2,
              and a library call's time where one PyTorch call (SDPA) or
              the port's cuDNN layers compute the same function
  4. agree    a small model on the card against the same model on the CPU,
              with precomputed front-end features and, on 1 s worst-case /
              speech-like / padded rows, with the front-end DSP (gate
              decisions and conditioning flags equal)
  5. path     each path through the entry points a user calls, with every
              launch counter set to 0 just before and read just after:
              - the flagship eval forward (wav2vec2-base + XLM-R-base ->
                35-layer OpenMax head, bf16) through `model_forward`, at B=4
                and at B=128 with 4 s clips (kernel A1), on precomputed
                front-end features;
              - the same forward on a batch without them, so that it runs
                the front-end DSP first (the default config's main path),
                at B=4 and B=128 on worst-case audio (the notch, HPF and
                denoise gates fire) and on speech-like audio: ms, utt/s,
                peak memory, the DSP's own ms, its host reads (torch's sync
                debug mode) and A1's launches;
              - `feature_encoder(allow_fused=True)` at wav2vec2-base width,
                4 s clips, B=4 and B=128, bf16, against the unfused
                extractor (kernel A4);
              - `flash_attention` at the attention sites of the flagship's
                shapes (kernel A3) and `attentive_stats_pooling` at its
                pooling sites (kernel A2), B=4 and B=128: the JAX package
                reaches these two kernels only through these functions
Then the `kernels` line and, last, {"ok": true, "device": {...}}.

A tolerance `tol` is held as the JAX package's tests hold theirs:
|kernel - plain| <= tol * (1 + |plain|) elementwise (rtol = atol = tol).

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
H100_BF16_FLOPS = 989e12     # bf16 tensor cores, dense
KERNEL_TOL = 1e-4            # kernel vs plain in f32: summation order
BF16_TOL = {"conv_tail": 4e-2,   # the JAX package's bound for the fused tail
            "attention": 3e-2}   # and for bf16 pooling: one output rounding
AGREE_TOL = {"float32": 1e-4,   # card vs CPU, TF32 off: summation order only
             "bfloat16": 3e-2}  # bf16 rounding at other places (the JAX package's bf16 bound)
REQUESTS_B4 = 5
REQUESTS_B128 = 3
SAMPLE_RATE = 16000
DSP_HOST_READS = 3   # condition_audio's gates: notch/HPF, denoise, dereverb
CLIP_SAMPLES = 4 * 16000
TEXT_TOKENS = 32
ATTENTION_SITES = {  # (Sq, Skv, D, heads) at the flagship's shapes
    "wav2vec2_self": (199, 199, 768, 12),
    "xlmr_self": (TEXT_TOKENS, TEXT_TOKENS, 768, 12),
    "cross_audio_to_text": (199, TEXT_TOKENS, 256, 8),
    "cross_text_to_audio": (TEXT_TOKENS, 199, 256, 8),
}
POOLING_SITES = {"pool_a": (199, 768), "pool_t": (TEXT_TOKENS, 768)}  # (S, D)
POOL_HIDDEN = 128
L2_FLUSH_BYTES = 128 * 2 ** 20   # written before each flushed launch; the L2 holds 50 MB
SPIN_CYCLES = 2_000_000          # about 1 ms of the H100's clock: the host gets ahead
KERNEL_NAMES = ("residual_stack", "conv_tail", "flash_attention", "attentive_pooling")
SOURCE = "multilingual_multimodal_speech_emotion_recognition_tpu_torch/csrc/{}.cu"
REPLACES = "multilingual_multimodal_speech_emotion_recognition_tpu/ops/pallas_kernels.py:{}"


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


def flushed_ms(fn, flush, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() timed alone, each launch after writing
    `flush` (larger than the 50 MB L2), so that fn finds its inputs in
    device memory as a caller would, not in L2. A spin kernel queued first
    keeps the card busy while the host issues the flush and fn, so the
    host's time per call (tens of us in Python) is not counted."""
    import torch
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        torch.cuda._sleep(SPIN_CYCLES)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound(nbytes: float, op_seconds: float):
    """Least time on an H100 (ms) and what bounds it: the bytes moved at
    the memory rate against the operations at their type's peak rate."""
    t_bytes = nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_bytes, op_seconds), ("bytes" if t_bytes >= op_seconds else "operations")


def product_rate(*dtypes) -> float:
    """Peak rate of a product whose operands have these types: bf16 tensor
    cores when all are bf16 (f32 accumulation is exact there), else f32
    FMAs."""
    import torch
    return H100_BF16_FLOPS if all(d == torch.bfloat16 for d in dtypes) else H100_F32_FLOPS


def check_close(name: str, got, want, tol: float) -> float:
    """max |got - want|; raises unless got is within tol of want."""
    import torch
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{name}: max |kernel - plain| {err} over tolerance {tol}")
    return err


def ptxas_report(log: str) -> dict:
    """ptxas's registers, spills and static shared memory for each entry
    function of one source's build log (`-Xptxas -v`), by mangled name."""
    report, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("registers" in line or "spill" in line):
            report.setdefault(entry, []).append(line.replace("ptxas info    : ", "").strip())
    return report


def tiny_config(compute_dtype: str, frontend_dsp: bool = False):
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
        ModelConfig, Wav2Vec2Config, XLMRConfig)
    return ModelConfig(
        num_labels=4, adapter_dim=8, shared_dim=16, num_heads=4, proj_dim=32,
        classifier_layers=3, classifier_base_dim=32, frontend_dsp=frontend_dsp,
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


def speech_like(B: int, T: int, seed: int) -> np.ndarray:
    """Modulated multi-tone rows plus a little noise, roughly speech-shaped
    (the JAX package's front-end tests use this signal)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / SAMPLE_RATE
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)
    x = env * (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 880 * t)
               + 0.1 * np.sin(2 * np.pi * 1760 * t))
    return (x[None, :] + 0.01 * rng.standard_normal((B, T))).astype(np.float32)


def worst_case_dsp_audio(B: int, T: int, seed: int) -> np.ndarray:
    """Rows that fire every front-end branch that can fire and pass the
    gates (a copy of the JAX package's eval/benchmark.py
    worst_case_dsp_audio): even rows a 50 Hz hum over 130 Hz energy (notch,
    HPF), odd rows an AM square wave whose high sample-energy floor sets
    off the denoiser; both faded in and out over 12 % of the clip."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / SAMPLE_RATE
    edge = max(1, int(0.12 * T))
    env = np.minimum(1.0, np.minimum(np.arange(T), np.arange(T)[::-1]) / edge)
    am = 1.0 + 0.6 * np.sin(2 * np.pi * 3.0 * t)
    hum_clip = (0.3 * np.sin(2 * np.pi * 50.0 * t) + 0.3 * np.sin(2 * np.pi * 130.0 * t)
                + 0.12 * np.sin(2 * np.pi * 220.0 * t) * am)
    noisy_clip = 0.35 * am * np.sign(np.sin(2 * np.pi * 370.0 * t))
    x = np.where((np.arange(B) % 2 == 0)[:, None], hum_clip[None, :], noisy_clip[None, :]) \
        + 0.02 * rng.standard_normal((B, T))
    return np.clip(x * env[None, :], -1.0, 1.0).astype(np.float32)


def host_reads(torch, fn):
    """(fn(), the number of calls inside it that waited for the card to
    read a value back), counted by torch's sync debug mode."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in caught)


def dsp_flags(stats) -> dict:
    """How many rows each front-end branch and gate decision took."""
    c, q = stats["conditioning"], stats["quality"]
    flags = {f: int(getattr(c, f).sum()) for f in
             ("hum_filtered", "hpf_applied", "denoise_applied", "dereverb_applied")}
    flags["decisions"] = {name: int((q.decision == code).sum())
                          for name, code in (("reject", 0), ("uncertain", 1), ("accept", 2))}
    return flags


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
    """Each input read once and the output written once, against the f32
    FMAs of the two products."""
    nbytes = 4 * (2 * B * D + L * (2 * D * D + 6 * D))
    return bound(nbytes, 2 * 2 * B * L * D * D / H100_F32_FLOPS)


def conv_tail_inputs(torch, B: int, T1: int, C: int, dtype, *, has_ln: bool, seed: int):
    """The tail's seven-layer stack (He-scaled kernels [C_out, C_in, K]) and
    a layer-0 output x1 [B, T1, C] shaped like a GELU's."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
        conv_tail as ct)
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    convs = [{"kernel": rnd(C, 1, 10).to(dtype)}]
    for K in ct.TAIL_KERNELS:
        conv = {"kernel": (rnd(C, C, K) * (2.0 / (K * C)) ** 0.5).to(dtype)}
        if has_ln:
            conv["bias"] = (0.1 * rnd(C)).to(dtype)
            conv["ln"] = {"scale": 1 + 0.1 * rnd(C), "bias": 0.1 * rnd(C)}
        convs.append(conv)
    x1 = torch.nn.functional.gelu(rnd(B, T1, C)).to(dtype)
    return convs, x1


def conv_tail_bound(B: int, T1: int, C: int, dtype):
    """x1 read once, the weights once, the output written once, against
    the six layers' products."""
    import torch
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
        conv_tail as ct)
    size = 2 if dtype == torch.bfloat16 else 4
    lengths = ct.tail_lengths(T1)
    flops = sum(2 * B * t * K * C * C for t, K in zip(lengths, ct.TAIL_KERNELS))
    nbytes = size * (B * T1 * C + sum(ct.TAIL_KERNELS) * C * C + B * lengths[-1] * C)
    return bound(nbytes, flops / product_rate(dtype)), flops


def attention_inputs(torch, B: int, Sq: int, Skv: int, D: int, dtype, seed: int):
    """q, k, v and a key mask with row 0's second half and every third key
    of the last row padded."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Sq, D, device="cuda", generator=g).to(dtype)
    k = torch.randn(B, Skv, D, device="cuda", generator=g).to(dtype)
    v = torch.randn(B, Skv, D, device="cuda", generator=g).to(dtype)
    mask = torch.ones(B, Skv, device="cuda")
    mask[0, Skv // 2:] = 0
    mask[-1, ::3] = 0
    return q, k, v, mask


def attention_bound(B: int, Sq: int, Skv: int, D: int, dtype):
    """q, k, v, the mask and the output moved once, against the products as
    the kernel issues them: for bf16 inputs q.k once and p.v twice (p's
    bf16 high and low parts), all on the bf16 tensor cores; for f32 inputs
    q.k and p.v once each, on the f32 CUDA cores. Returns the bound and the
    products' FLOP."""
    import torch
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = size * (2 * B * Sq * D + 2 * B * Skv * D) + 4 * B * Skv
    products = (3 if dtype == torch.bfloat16 else 2) * 2 * B * Sq * Skv * D
    return bound(nbytes, products / product_rate(dtype)), products


def pooling_inputs(torch, B: int, S: int, D: int, dtype, seed: int):
    """Pooling parameters at the model's init scale, x, and a frame mask
    with row 0's second half padded."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    H = POOL_HIDDEN
    params = {"w1": {"kernel": (rnd(D, H) / D ** 0.5).to(dtype), "bias": (0.1 * rnd(H)).to(dtype)},
              "w2": {"kernel": (rnd(H, 1) / H ** 0.5).to(dtype), "bias": (0.1 * rnd(1)).to(dtype)}}
    mask = torch.ones(B, S, device="cuda")
    mask[0, S // 2:] = 0
    return params, rnd(B, S, D).to(dtype), mask


def pooling_bound(B: int, S: int, D: int, dtype):
    """x, the mask, the parameters and the output moved once, against the
    score MLP (tensor cores for bf16 x and W1) and the f32 statistics."""
    import torch
    H = POOL_HIDDEN
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = size * (B * S * D + D * H + 2 * H + 1 + 2 * B * D) + 4 * B * S
    op_s = (2 * B * S * D * H / product_rate(dtype, dtype)
            + (2 * B * S * H + 4 * B * S * D) / H100_F32_FLOPS)
    return bound(nbytes, op_s)


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def card_against_cpu(torch, mdl, cfg, batch: dict, tol: float) -> dict:
    """model_forward of one small model on the card and on the CPU: each
    output's max |card - CPU|; raises where one is out of tolerance."""
    cpu_params = mdl.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    want = mdl.model_forward(cpu_params, cfg, batch)
    got = mdl.model_forward(tree_to(cpu_params, "cuda"), cfg, batch)
    torch.cuda.synchronize()
    diffs = {}
    for field, g, w in zip(want._fields, got, want):
        g, w = g.float().cpu(), w.float()
        diffs[field] = float((g - w).abs().max())
        if not torch.allclose(g, w, rtol=tol, atol=tol):
            raise AssertionError(f"{cfg.compute_dtype} (front-end DSP {cfg.frontend_dsp}) "
                                 f"{field}: card vs CPU max diff {diffs[field]} over "
                                 f"tolerance {tol}")
    return diffs


def reset_counts(wrappers) -> None:
    for w in wrappers.values():
        w.launches = 0


def counts(wrappers) -> dict:
    return {name: w.launches for name, w in wrappers.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch import frontend
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
        ModelConfig)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        layers, model as mdl, wav2vec2 as w2v)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
        _build, attentive_pooling as ap, conv_tail as ct, flash_attention as fa,
        residual_stack as rs)
    wrappers = {"residual_stack": rs.residual_stack, "conv_tail": ct.conv_tail,
                "flash_attention": fa.flash_attention,
                "attentive_pooling": ap.attentive_stats_pooling}
    bf16 = torch.bfloat16

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
    _build.build_all(KERNEL_NAMES)
    for module in (rs, ct, fa, ap):
        module.build()
    emit({"phase": "build", "kernels": list(KERNEL_NAMES),
          "seconds": time.perf_counter() - t0,
          "ptxas": {k: ptxas_report((_build.BUILD_DIR / f"{k}.log").read_text())
                    for k in KERNEL_NAMES if (_build.BUILD_DIR / f"{k}.log").exists()}})

    # 3a. A1: the residual stack, one cooperative grid over the card; B=300
    # has blocks that loop over several row groups
    L, D = 35, 512
    rs.residual_stack.launches = 0
    errs = {}
    batches = (1, 3, 4, 8, 11, 128, 300)
    for B in batches:
        stacked, x = residual_stack_inputs(torch, B, L, D, seed=B)
        got = rs.residual_stack(stacked, x)
        want = rs.residual_stack_plain(stacked, x)
        torch.cuda.synchronize()
        errs[B] = check_close(f"residual_stack B={B}", got, want, KERNEL_TOL)
    if rs.residual_stack.launches != len(batches):
        raise AssertionError(f"residual_stack launched {rs.residual_stack.launches} "
                             f"times for {len(batches)} calls")
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    timing, plans = {}, {}
    for B in (4, 128):
        stacked, x = residual_stack_inputs(torch, B, L, D, seed=B)
        first, second = rs.residual_stack(stacked, x), rs.residual_stack(stacked, x)
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            raise AssertionError(f"residual_stack B={B}: two launches differ")
        p = rs.plan(B, L, D, num_sms)
        plans[B] = {"blocks": p.blocks, "row_groups": p.row_groups, "rows": p.rows,
                    "col_width": p.col_width, "col_groups": p.col_groups,
                    "row_blocks": p.row_blocks, "ring_depth": p.depth,
                    "smem_bytes": p.smem_bytes}
        bound_ms, bound_by = residual_stack_bound(B, L, D)
        ms = cuda_ms(lambda: rs.residual_stack(stacked, x), 50)
        timing[B] = {
            "ms": ms, "plain_ms": cuda_ms(lambda: rs.residual_stack_plain(stacked, x), 10),
            "bound_ms": bound_ms, "bound_by": bound_by, "ms_over_bound": ms / bound_ms}
    emit({"phase": "kernel", "name": "residual_stack", "L": L, "D": D,
          "tol": KERNEL_TOL, "max_abs_err": errs, "bitwise_repeat": True,
          "plan": plans, "timing": timing})

    # 3b. A4: the conv-extractor tail, at the layer-0 output of 4 s clips
    C = 512
    T1 = (CLIP_SAMPLES - 10) // 5 + 1
    tail = {"max_abs_err": {}, "timing": {}}
    for label, B, dtype, has_ln, tol in (
            ("bf16 B=4", 4, bf16, False, BF16_TOL["conv_tail"]),
            ("bf16 B=128", 128, bf16, False, BF16_TOL["conv_tail"]),
            ("bf16 B=4 ln+bias", 4, bf16, True, BF16_TOL["conv_tail"]),
            ("f32 B=4", 4, torch.float32, False, KERNEL_TOL),
            ("f32 B=4 ln+bias", 4, torch.float32, True, KERNEL_TOL)):
        convs, x1 = conv_tail_inputs(torch, B, T1, C, dtype, has_ln=has_ln, seed=B)
        got = ct.conv_tail(convs, x1, has_ln=has_ln)
        want = ct.conv_tail_plain(convs, x1, has_ln=has_ln)
        torch.cuda.synchronize()
        if tuple(got.shape) != (B, ct.tail_lengths(T1)[-1], C):
            raise AssertionError(f"conv_tail {label}: shape {tuple(got.shape)}")
        tail["max_abs_err"][label] = check_close(f"conv_tail {label}", got, want, tol)
        del got, want
    for B, iters in ((4, 20), (128, 10)):
        convs, x1 = conv_tail_inputs(torch, B, T1, C, bf16, has_ln=False, seed=B)
        x_cf = x1.transpose(1, 2).contiguous()   # the port's channels-first layout

        def cudnn_path():
            x = x_cf
            for conv in convs[1:]:
                x = layers.gelu(w2v._conv1d(conv, x, 2))
            return x

        (bound_ms, bound_by), flops = conv_tail_bound(B, T1, C, bf16)
        ms = cuda_ms(lambda: ct.conv_tail(convs, x1, has_ln=False), iters, warmup=1)
        tail["timing"][B] = {
            "ms": ms, "tflop_per_s": flops / ms / 1e9,
            "plain_ms": cuda_ms(lambda: ct.conv_tail_plain(convs, x1, has_ln=False),
                                max(1, iters // 3), warmup=1),
            "cudnn_path_ms": cuda_ms(cudnn_path, iters, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "ms_over_bound": ms / bound_ms,
            "tflop": flops / 1e12}
        del convs, x1, x_cf
    emit({"phase": "kernel", "name": "conv_tail", "C": C, "T1": T1, "tol": BF16_TOL["conv_tail"],
          "f32_tol": KERNEL_TOL, **tail})
    torch.cuda.empty_cache()

    # 3c. A3: masked flash attention at the flagship's attention sites
    attn = {"max_abs_err": {}, "timing": {}}
    for site, (Sq, Skv, D, H) in ATTENTION_SITES.items():
        for B, dtype, tol in ((4, bf16, BF16_TOL["attention"]),
                              (128, bf16, BF16_TOL["attention"]),
                              (4, torch.float32, KERNEL_TOL)):
            q, k, v, mask = attention_inputs(torch, B, Sq, Skv, D, dtype, seed=Sq + Skv)
            got = fa.flash_attention(q, k, v, mask, num_heads=H)
            want = fa.flash_attention_plain(q, k, v, mask, num_heads=H)
            torch.cuda.synchronize()
            label = f"{site} {'bf16' if dtype == bf16 else 'f32'} B={B}"
            attn["max_abs_err"][label] = check_close(f"flash_attention {label}", got, want, tol)
        B = 128
        q, k, v, mask = attention_inputs(torch, B, Sq, Skv, D, bf16, seed=Sq + Skv)
        heads = lambda t: t.view(B, t.shape[1], H, D // H).transpose(1, 2)
        qh, kh, vh = heads(q), heads(k), heads(v)
        keep = (mask != 0)[:, None, None, :]
        (bound_ms, bound_by), products = attention_bound(B, Sq, Skv, D, bf16)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, mask, num_heads=H), 20)
        attn["timing"][site] = {
            "B": B, "Sq": Sq, "Skv": Skv, "D": D, "heads": H, "ms": ms,
            "tflop_per_s": products / ms / 1e9, "ms_over_bound": ms / bound_ms,
            "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v, mask, num_heads=H), 5),
            "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=keep), 20),
            "bound_ms": bound_ms, "bound_by": bound_by, "products_gflop": products / 1e9}
    emit({"phase": "kernel", "name": "flash_attention", "tol": BF16_TOL["attention"],
          "f32_tol": KERNEL_TOL, **attn})

    # 3d. A2: attentive-stats pooling at the pooling sites. The bf16 route
    # (bf16 x and W1) is the tensor-core kernel under `plan`; f32 x takes the
    # CUDA-core route. Timed with L2 flushed before each launch, as a caller
    # finds it (x at B=128 fits the 50 MB L2), and back to back (`ms_warm`).
    pool = {"max_abs_err": {}, "timing": {}, "plan": {}}
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    for site, (S, D) in POOLING_SITES.items():
        for B, dtype, tol in ((4, bf16, BF16_TOL["attention"]),
                              (128, bf16, BF16_TOL["attention"]),
                              (4, torch.float32, KERNEL_TOL),
                              (128, torch.float32, KERNEL_TOL)):
            params, x, mask = pooling_inputs(torch, B, S, D, dtype, seed=S)
            got = ap.attentive_stats_pooling(params, x, mask)
            want = ap.attentive_stats_pooling_plain(params, x, mask)
            torch.cuda.synchronize()
            label = f"{site} {'bf16' if dtype == bf16 else 'f32'} B={B}"
            if ap.attentive_stats_pooling.last_route != ("bf16" if dtype == bf16 else "f32"):
                raise AssertionError(f"attentive_pooling {label}: route "
                                     f"{ap.attentive_stats_pooling.last_route}")
            pool["max_abs_err"][label] = check_close(f"attentive_pooling {label}", got, want, tol)
        for B in (4, 128):
            params, x, mask = pooling_inputs(torch, B, S, D, bf16, seed=S)
            first = ap.attentive_stats_pooling(params, x, mask)
            second = ap.attentive_stats_pooling(params, x, mask)
            torch.cuda.synchronize()
            if not torch.equal(first, second):
                raise AssertionError(f"attentive_pooling {site} B={B}: two launches differ")
            pool["plan"][f"{site} B={B}"] = ap.plan(B, S, D, POOL_HIDDEN, num_sms)._asdict()
            bound_ms, bound_by = pooling_bound(B, S, D, bf16)
            ms = flushed_ms(lambda: ap.attentive_stats_pooling(params, x, mask), flush, 50)
            pool["timing"][f"{site} B={B}"] = {
                "B": B, "S": S, "D": D, "ms": ms,
                "ms_warm": cuda_ms(lambda: ap.attentive_stats_pooling(params, x, mask), 50),
                "plain_ms": flushed_ms(lambda: ap.attentive_stats_pooling_plain(params, x, mask),
                                       flush, 10),
                "bound_ms": bound_ms, "bound_by": bound_by, "ms_over_bound": ms / bound_ms}
    del flush
    print("attentive_pooling plans: " + json.dumps(pool["plan"]), flush=True)
    emit({"phase": "kernel", "name": "attentive_pooling", "tol": BF16_TOL["attention"],
          "f32_tol": KERNEL_TOL, "bitwise_repeat": True, **pool})

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
        emit({"phase": "agree", "dtype": dtype, "tol": tol,
              "max_abs_diff": card_against_cpu(torch, mdl, tiny_config(dtype), small, tol)})

    # 4b. the same with the front-end DSP: 1 s rows (worst case x2, speech-
    # like, speech-like padded to 0.7 s), no precomputed features
    T = SAMPLE_RATE
    audio = np.concatenate([worst_case_dsp_audio(2, T, seed=5), speech_like(2, T, seed=3)])
    audio_mask = np.ones_like(audio)
    audio_mask[3, int(0.7 * T):] = 0
    audio *= audio_mask
    dsp_small = {"audio": audio, "audio_mask": audio_mask, "text_ids": ids,
                 "text_mask": text_mask}
    ent, conf = torch.ones(B), torch.zeros(B)
    want_dsp = frontend.frontend_process(torch.from_numpy(audio), torch.from_numpy(audio_mask),
                                         lid_entropy=ent, lid_confidence=conf)
    got_dsp = frontend.frontend_process(torch.from_numpy(audio).cuda(),
                                        torch.from_numpy(audio_mask).cuda(),
                                        lid_entropy=ent.cuda(), lid_confidence=conf.cuda())
    flags = {"cpu": dsp_flags(want_dsp[3]), "card": dsp_flags(got_dsp[3])}
    for stage, fields in (("quality", ("decision",)),
                          ("conditioning", ("hum_filtered", "hpf_applied", "denoise_applied",
                                            "dereverb_applied", "noise_type"))):
        for field in fields:
            g = getattr(got_dsp[3][stage], field).cpu()
            if not torch.equal(g, getattr(want_dsp[3][stage], field)):
                raise AssertionError(f"front-end {stage}.{field}: card {g.tolist()} vs CPU "
                                     f"{getattr(want_dsp[3][stage], field).tolist()}")
    if not all(flags["cpu"][f] for f in ("hum_filtered", "hpf_applied", "denoise_applied")):
        raise AssertionError(f"front-end branches on the small batch: {flags['cpu']}")
    dsp_diffs = {name: check_close(f"front-end {name} card vs CPU", g.cpu(), w, KERNEL_TOL)
                 for name, g, w in zip(("quality_feats", "cond_feats"), got_dsp[1:3],
                                       want_dsp[1:3])}
    for dtype, tol in AGREE_TOL.items():
        diffs = card_against_cpu(torch, mdl, tiny_config(dtype, frontend_dsp=True), dsp_small, tol)
        emit({"phase": "agree", "dtype": dtype, "frontend_dsp": True, "tol": tol,
              "max_abs_diff": diffs, "dsp_features_max_abs_diff": dsp_diffs,
              "dsp_tol": KERNEL_TOL, "dsp_flags": flags})

    launches = dict.fromkeys(KERNEL_NAMES, 0)

    # 5a. the flagship eval forward (A1)
    cfg = ModelConfig(compute_dtype="bfloat16")
    params = mdl.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    path = {}
    for B, requests in ((4, REQUESTS_B4), (128, REQUESTS_B128)):
        batch = example_batch(B, T=CLIP_SAMPLES, S=TEXT_TOKENS, vocab=cfg.text.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        times = []
        reset_counts(wrappers)
        for _ in range(requests):
            t0 = time.perf_counter()
            out = mdl.model_forward(params, cfg, batch)
            logits = out.logits.cpu()
            times.append(time.perf_counter() - t0)
        count = counts(wrappers)
        if count["residual_stack"] != requests:
            raise AssertionError(f"B={B}: residual_stack launched {count['residual_stack']} "
                                 f"times in {requests} forwards")
        launches["residual_stack"] += count["residual_stack"]
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
                   "launches": count}
        emit({"phase": "path", "path": "model_forward", "B": B, "seconds": 4.0,
              "text_tokens": TEXT_TOKENS, "card": smi, **path[B]})

    # 5a'. the same forward on batches without front-end features: the
    # default config runs the DSP first, on the card
    for kind, make in (("worst_case", worst_case_dsp_audio), ("speech_like", speech_like)):
        for B, requests in ((4, REQUESTS_B4), (128, REQUESTS_B128)):
            batch = example_batch(B, T=CLIP_SAMPLES, S=TEXT_TOKENS, vocab=cfg.text.vocab_size)
            del batch["quality_feats"], batch["cond_feats"]
            batch["audio"] = make(B, CLIP_SAMPLES, seed=B)
            batch["audio_mask"] = np.ones_like(batch["audio"])
            batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
            lid = {"lid_entropy": torch.ones(B, device="cuda"),
                   "lid_confidence": torch.zeros(B, device="cuda")}
            dsp = lambda: frontend.frontend_process(batch["audio"], batch["audio_mask"], **lid)
            stats, dsp_reads = host_reads(torch, dsp)
            stats = stats[3]
            out, forward_reads = host_reads(torch, lambda: mdl.model_forward(params, cfg, batch))
            if dsp_reads != DSP_HOST_READS:
                raise AssertionError(f"{kind} B={B}: the front-end DSP read the card "
                                     f"{dsp_reads} times, not {DSP_HOST_READS}")
            dsp_times = []
            for _ in range(requests):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dsp()
                torch.cuda.synchronize()
                dsp_times.append(time.perf_counter() - t0)
            torch.cuda.reset_peak_memory_stats()
            times = []
            reset_counts(wrappers)
            for _ in range(requests):
                t0 = time.perf_counter()
                out = mdl.model_forward(params, cfg, batch)
                logits = out.logits.cpu()
                times.append(time.perf_counter() - t0)
            count = counts(wrappers)
            if count["residual_stack"] != requests:
                raise AssertionError(f"{kind} B={B}: residual_stack launched "
                                     f"{count['residual_stack']} times in {requests} forwards")
            launches["residual_stack"] += count["residual_stack"]
            for field, v in zip(out._fields, out):
                if not torch.isfinite(v.float()).all():
                    raise AssertionError(f"{kind} B={B}: {field} is not finite")
            if tuple(logits.shape) != (B, cfg.num_labels):
                raise AssertionError(f"{kind} B={B}: logits {tuple(logits.shape)}")
            fired = dsp_flags(stats)
            if kind == "worst_case" and not all(
                    fired[f] for f in ("hum_filtered", "hpf_applied", "denoise_applied")):
                raise AssertionError(f"worst-case B={B}: a heavy branch did not fire: {fired}")
            ms = 1e3 * sorted(times[1:])[len(times[1:]) // 2]
            dsp_ms = 1e3 * sorted(dsp_times[1:])[len(dsp_times[1:]) // 2]
            emit({"phase": "path", "path": "model_forward with the front-end DSP",
                  "audio": kind, "B": B, "seconds": 4.0, "text_tokens": TEXT_TOKENS,
                  "card": smi, "requests": requests, "ms": ms,
                  "utt_per_s": B / (ms / 1e3), "dsp_ms": dsp_ms, "dsp_share": dsp_ms / ms,
                  "host_reads": {"dsp": dsp_reads, "forward": forward_reads},
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "branches": fired, "launches": count})
            del batch, out, stats

    # 5b. feature_encoder(allow_fused=True) (A4), wav2vec2-base width
    w2v_params = mdl.cast_floating(params["audio_backbone"], bf16)
    del params
    torch.cuda.empty_cache()
    fused_path = {}
    for B, calls in ((4, 5), (128, 3)):
        batch = example_batch(B, T=CLIP_SAMPLES, S=TEXT_TOKENS, vocab=cfg.text.vocab_size)
        mask = torch.from_numpy(batch["audio_mask"]).cuda()
        wave = w2v.normalize_waveform(torch.from_numpy(batch["audio"]).cuda(), mask).to(bf16)
        unfused, unfused_m = w2v.feature_encoder(w2v_params, cfg.audio, wave, mask)
        torch.cuda.synchronize()
        reset_counts(wrappers)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            feats, frame_mask = w2v.feature_encoder(w2v_params, cfg.audio, wave, mask,
                                                    allow_fused=True)
        end.record()
        torch.cuda.synchronize()
        count = counts(wrappers)
        if count["conv_tail"] != calls:
            raise AssertionError(f"feature_encoder B={B}: conv_tail launched "
                                 f"{count['conv_tail']} times in {calls} calls")
        launches["conv_tail"] += count["conv_tail"]
        T7 = cfg.audio.feat_extract_output_lengths(CLIP_SAMPLES)
        if tuple(feats.shape) != (B, T7, cfg.audio.conv_dim[-1]) or feats.dtype != bf16:
            raise AssertionError(f"feature_encoder B={B}: {tuple(feats.shape)} {feats.dtype}")
        if not torch.isfinite(feats.float()).all():
            raise AssertionError(f"feature_encoder B={B}: features not finite")
        if not torch.equal(frame_mask, unfused_m):
            raise AssertionError(f"feature_encoder B={B}: frame masks differ")
        err = check_close(f"feature_encoder fused vs unfused B={B}", feats, unfused,
                          BF16_TOL["conv_tail"])
        x0 = torch.empty(B, cfg.audio.conv_dim[0], T1, dtype=bf16, device="cuda")
        fused_path[B] = {
            "calls": calls, "launches": count, "max_abs_diff_vs_unfused": err,
            "tol": BF16_TOL["conv_tail"], "unfused_range": [float(unfused.min()),
                                                            float(unfused.max())],
            "fused_ms": start.elapsed_time(end) / calls,
            "unfused_ms": cuda_ms(lambda: w2v.feature_encoder(w2v_params, cfg.audio,
                                                              wave, mask), calls, warmup=1),
            "transpose_ms": cuda_ms(lambda: x0.transpose(1, 2).contiguous(), 10)}
        emit({"phase": "path", "path": "feature_encoder(allow_fused=True)", "B": B,
              "seconds": 4.0, "card": smi, **fused_path[B]})
        del feats, unfused, x0
    del w2v_params
    torch.cuda.empty_cache()

    # 5c. flash_attention and attentive_stats_pooling (A3, A2) through their
    # own functions, the only way the JAX package reaches them
    for B in (4, 128):
        inputs = {site: attention_inputs(torch, B, Sq, Skv, D, bf16, seed=B + Sq)
                  for site, (Sq, Skv, D, _) in ATTENTION_SITES.items()}
        pool_inputs = {site: pooling_inputs(torch, B, S, D, bf16, seed=B + S)
                       for site, (S, D) in POOLING_SITES.items()}
        torch.cuda.synchronize()
        reset_counts(wrappers)
        outs = {site: fa.flash_attention(*inputs[site], num_heads=ATTENTION_SITES[site][3])
                for site in ATTENTION_SITES}
        pooled = {site: ap.attentive_stats_pooling(*pool_inputs[site])
                  for site in POOLING_SITES}
        torch.cuda.synchronize()
        if ap.attentive_stats_pooling.last_route != "bf16":
            raise AssertionError(f"B={B}: pooling took route "
                                 f"{ap.attentive_stats_pooling.last_route}, not bf16")
        count = counts(wrappers)
        if (count["flash_attention"] != len(ATTENTION_SITES)
                or count["attentive_pooling"] != len(POOLING_SITES)):
            raise AssertionError(f"B={B}: launches {count} for {len(ATTENTION_SITES)} "
                                 f"attention and {len(POOLING_SITES)} pooling calls")
        launches["flash_attention"] += count["flash_attention"]
        launches["attentive_pooling"] += count["attentive_pooling"]
        for site, o in outs.items():
            if tuple(o.shape) != tuple(inputs[site][0].shape) or not torch.isfinite(o.float()).all():
                raise AssertionError(f"flash_attention {site} B={B}: {tuple(o.shape)} not finite")
        for site, o in pooled.items():
            if (tuple(o.shape) != (B, 2 * POOLING_SITES[site][1])
                    or not torch.isfinite(o.float()).all()):
                raise AssertionError(f"attentive_pooling {site} B={B}: {tuple(o.shape)} not finite")
        emit({"phase": "path", "path": "flash_attention + attentive_stats_pooling", "B": B,
              "launches": count, "attention_sites": list(ATTENTION_SITES),
              "pooling_sites": list(POOLING_SITES)})

    for kname, n in launches.items():
        if n < 1:
            raise AssertionError(f"{kname} was launched no time on its path")
    t4 = timing[4]
    tail128 = tail["timing"][128]
    w2v_site = attn["timing"]["wav2vec2_self"]
    pool_a = pool["timing"]["pool_a B=128"]
    emit({"kernels": [
        {"name": "residual_stack", "route": "cuda", "source": SOURCE.format("residual_stack"),
         "replaces": REPLACES.format(114), "launches": launches["residual_stack"],
         "max_abs_err": max(errs.values()), "tol": KERNEL_TOL,
         "ms": t4["ms"], "plain_ms": t4["plain_ms"],
         "bound_ms": t4["bound_ms"], "bound_by": t4["bound_by"],
         "ms_over_bound": t4["ms_over_bound"], "library_ms": None,
         "B": 4, "plan": plans[4], "at_B128": {**timing[128], "plan": plans[128]}},
        {"name": "conv_tail", "route": "cuda", "source": SOURCE.format("conv_tail"),
         "replaces": REPLACES.format(467), "launches": launches["conv_tail"],
         "max_abs_err": max(tail["max_abs_err"].values()), "tol": BF16_TOL["conv_tail"],
         "ms": tail128["ms"], "plain_ms": tail128["plain_ms"],
         "bound_ms": tail128["bound_ms"], "bound_by": tail128["bound_by"],
         "ms_over_bound": tail128["ms_over_bound"], "tflop_per_s": tail128["tflop_per_s"],
         "library_ms": None, "cudnn_path_ms": tail128["cudnn_path_ms"],
         "B": 128, "at_B4": tail["timing"][4]},
        {"name": "flash_attention", "route": "cuda", "source": SOURCE.format("flash_attention"),
         "replaces": REPLACES.format(295), "launches": launches["flash_attention"],
         "max_abs_err": max(attn["max_abs_err"].values()), "tol": BF16_TOL["attention"],
         "ms": w2v_site["ms"], "plain_ms": w2v_site["plain_ms"],
         "bound_ms": w2v_site["bound_ms"], "bound_by": w2v_site["bound_by"],
         "ms_over_bound": w2v_site["ms_over_bound"], "tflop_per_s": w2v_site["tflop_per_s"],
         "library_ms": w2v_site["library_ms"], "B": 128, "site": "wav2vec2_self",
         "sites": attn["timing"]},
        {"name": "attentive_pooling", "route": "cuda",
         "source": SOURCE.format("attentive_pooling"), "replaces": REPLACES.format(208),
         "launches": launches["attentive_pooling"],
         "max_abs_err": max(pool["max_abs_err"].values()), "tol": BF16_TOL["attention"],
         "ms": pool_a["ms"], "plain_ms": pool_a["plain_ms"],
         "bound_ms": pool_a["bound_ms"], "bound_by": pool_a["bound_by"],
         "ms_over_bound": pool_a["ms_over_bound"], "ms_warm": pool_a["ms_warm"],
         "library_ms": None, "B": 128, "site": "pool_a", "route": "bf16",
         "plan": pool["plan"]["pool_a B=128"], "sites": pool["timing"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Inference benchmarking: latency percentiles, throughput, memory,
parameter counts, batch-size scaling efficiency.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
eval/benchmark.py, with the reference's inference_metrics.py:42-336
semantics (warmup + timed runs over batch sizes [1,4,8,16]; latency
mean/std/p50/p95/p99; samples-, words- and audio-seconds-per-second;
psutil CPU/RSS; param counts/model size; scaling-efficiency analysis).
Each timed call ends with the output on the host: a CUDA output is
preceded by torch.cuda.synchronize() and copied back, so a timing holds
the device's work. Device memory is torch.cuda.memory_stats()'s for a CUDA
device and nothing for the CPU. `model_gflops_per_utt`,
`scaling_efficiency`, `benchmark_report` and `worst_case_dsp_audio` are
the JAX module's, copied (numpy).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..utils.runtime import leaves_with_paths


def count_params(params) -> Dict[str, int]:
    """Total element count and bytes (in MB) of every tensor leaf."""
    leaves = [leaf for _, leaf in leaves_with_paths(params)]
    total = int(sum(leaf.numel() for leaf in leaves))
    bytes_total = int(sum(leaf.numel() * leaf.element_size() for leaf in leaves))
    return {"total_params": total, "model_size_mb": bytes_total / 1e6}


def _sync(x):
    """The output on the host: a CUDA tensor after the device's queue
    drains, so that a timing holds the device's work."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return x.detach().cpu()


def benchmark_fn(fn: Callable[[int], object], *, batch_sizes: Sequence[int] = (1, 4, 8, 16),
                 warmup: int = 3, runs: int = 10,
                 audio_seconds_per_sample: float = 0.0,
                 words_per_sample: float = 0.0) -> Dict:
    """fn(batch_size) -> output tensor; called with each batch size.
    Returns the inference_metrics.py-style report dict, with the memory of
    the device the outputs live on (none for the CPU)."""
    try:
        import psutil
        proc = psutil.Process()
    except ImportError:
        proc = None

    results = {}
    for bs in batch_sizes:
        for _ in range(warmup):
            _sync(fn(bs))
        latencies = []
        if proc:
            proc.cpu_percent(interval=None)   # starts the interval the entry reads
        device = None
        for _ in range(runs):
            t0 = time.perf_counter()
            out = fn(bs)
            _sync(out)
            latencies.append(time.perf_counter() - t0)
            device = getattr(out, "device", None)
        lat = np.asarray(latencies)
        entry = {
            "batch_size": bs,
            "latency_mean_ms": float(lat.mean() * 1e3),
            "latency_std_ms": float(lat.std() * 1e3),
            "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
            "latency_p95_ms": float(np.percentile(lat, 95) * 1e3),
            "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
            "samples_per_sec": float(bs / lat.mean()),
        }
        if audio_seconds_per_sample:
            entry["audio_sec_per_sec"] = entry["samples_per_sec"] * audio_seconds_per_sample
        if words_per_sample:
            entry["words_per_sec"] = entry["samples_per_sec"] * words_per_sample
        if proc:
            entry["cpu_percent"] = proc.cpu_percent(interval=None)
            entry["rss_mb"] = proc.memory_info().rss / 1e6
        entry.update(_device_memory(device))
        results[bs] = entry

    return {"per_batch_size": results,
            "scaling": scaling_efficiency(results)}


def _device_memory(device: Optional[torch.device]) -> Dict:
    """Bytes allocated now and at the peak on a CUDA device
    (torch.cuda.memory_stats); {} for any other. A failure to read a card's
    statistics raises."""
    if device is None or device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"device_bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "device_peak_bytes": int(stats.get("allocated_bytes.all.peak", 0))}


def scaling_efficiency(per_batch: Dict[int, Dict]) -> Dict:
    """Throughput scaling vs the smallest batch (inference_metrics.py
    scaling analysis): efficiency(b) = (thr_b / thr_min) / (b / b_min)."""
    if not per_batch:
        return {}
    sizes = sorted(per_batch)
    b0 = sizes[0]
    thr0 = per_batch[b0]["samples_per_sec"]
    eff = {}
    for b in sizes:
        thr = per_batch[b]["samples_per_sec"]
        eff[b] = (thr / thr0) / (b / b0) if thr0 > 0 else 0.0
    best = max(sizes, key=lambda b: per_batch[b]["samples_per_sec"])
    return {"efficiency_vs_smallest": eff, "best_batch_size": best,
            "best_samples_per_sec": per_batch[best]["samples_per_sec"]}


def benchmark_report(result: Dict, param_info: Optional[Dict] = None) -> str:
    lines = ["Inference Benchmark", "==================="]
    if param_info:
        lines.append(f"Parameters: {param_info['total_params']:,} "
                     f"({param_info['model_size_mb']:.1f} MB)")
    lines.append(f"{'batch':>6} {'mean ms':>9} {'p50':>8} {'p95':>8} "
                 f"{'p99':>8} {'samp/s':>9}")
    for bs, e in sorted(result["per_batch_size"].items()):
        lines.append(f"{bs:>6} {e['latency_mean_ms']:9.2f} "
                     f"{e['latency_p50_ms']:8.2f} {e['latency_p95_ms']:8.2f} "
                     f"{e['latency_p99_ms']:8.2f} {e['samples_per_sec']:9.1f}")
    sc = result.get("scaling", {})
    if sc:
        lines.append(f"best batch {sc['best_batch_size']} @ "
                     f"{sc['best_samples_per_sec']:.1f} samples/s")
    return "\n".join(lines)


def model_gflops_per_utt(model_cfg, *, audio_seconds: float = 4.0,
                         text_tokens: int = 32,
                         sample_rate: int = 16000) -> Dict[str, float]:
    """Analytic forward-pass FLOPs per utterance (2 FLOPs per MAC), broken
    down by component. Matmul/conv terms only — elementwise/norm/softmax
    FLOPs are O(activations) and <1% of the total at these shapes.

    Components: wav2vec2 conv feature extractor + conv positional embedding
    + transformer encoder; XLM-R transformer (+ no embedding FLOPs — table
    lookup); cross-attention, pooling, fusion, classifier heads."""
    a = model_cfg.audio
    x = model_cfg.text
    if a.is_conformer:
        raise NotImplementedError(f"backbone={a.backbone!r}: this count is the wav2vec2 "
                                  f"family's (perfbench/counts/conformer_flops.py counts "
                                  f"w2v-BERT 2.0)")

    # conv extractor over T raw samples (strided 1-D convs)
    T = int(audio_seconds * sample_rate)
    conv = 0.0
    t = T
    c_in = 1
    for c_out, k, s in zip(a.conv_dim, a.conv_kernel, a.conv_stride):
        t = (t - k) // s + 1
        conv += 2.0 * t * c_in * c_out * k
        c_in = c_out
    S = t  # encoder frame count

    def transformer(s, h, inter, layers):
        qkvo = 4 * 2.0 * s * h * h
        attn = 4.0 * s * s * h          # QK^T + AV, 2 FLOPs/MAC each
        ffn = 2 * 2.0 * s * h * inter
        return layers * (qkvo + attn + ffn)

    pos_conv = 2.0 * S * (a.hidden_size // a.num_conv_pos_embedding_groups) \
        * a.hidden_size * a.num_conv_pos_embeddings
    w2v2 = transformer(S, a.hidden_size, a.intermediate_size,
                       a.num_hidden_layers)
    xlmr = transformer(text_tokens, x.hidden_size, x.intermediate_size,
                       x.num_hidden_layers)

    # heads: cross-modal attention (q/k/v/out per direction + MHA),
    # adapters, pooling MLPs, fusion MLPs, classifier stack
    sh = model_cfg.shared_dim
    ha, hx = a.hidden_size, x.hidden_size
    cross = 2.0 * (S * (ha * sh * 2 + hx * sh) + text_tokens * (hx * sh * 2 + ha * sh)) \
        + 4.0 * S * text_tokens * sh * 2 \
        + 2.0 * (S * sh * ha + text_tokens * sh * hx)
    ad = model_cfg.adapter_dim
    adapters = 2.0 * 2 * (S * ha * ad + text_tokens * hx * ad)
    pool = 2.0 * (S * (ha * 128 + 128) + text_tokens * (hx * 128 + 128))
    pd = model_cfg.proj_dim
    fusion = 2.0 * (2 * ha * pd + 2 * hx * pd + 2 * pd * pd
                    + 2 * pd * max(32, pd // 2))
    bd = model_cfg.classifier_base_dim
    clf = 2.0 * (pd * bd +  # input projection fused(pd) -> bd
                 model_cfg.classifier_layers * 2 * bd * bd +
                 bd * (bd // 2) + (bd // 2) * model_cfg.num_labels)

    total = conv + pos_conv + w2v2 + xlmr + cross + adapters + pool + fusion + clf
    return {
        "total_gflops": total / 1e9,
        "conv_extractor_gflops": conv / 1e9,
        "audio_transformer_gflops": (w2v2 + pos_conv) / 1e9,
        "text_transformer_gflops": xlmr / 1e9,
        "heads_gflops": (cross + adapters + pool + fusion + clf) / 1e9,
        "audio_frames": float(S),
    }


def worst_case_dsp_audio(rng, batch: int, samples: int,
                         sample_rate: int = 16000) -> np.ndarray:
    """Adversarial audio that fires EVERY heavy gated DSP branch
    (frontend/conditioning.py) while still passing the quality gates'
    reject rules — the bracketing input for the end-to-end bench.

    The heavy stages are gated on batch-level `any()` predicates (the
    batched analogue of the reference's per-clip ifs), so worst case =
    every stage executing for the batch. Two per-clip specialists alternate
    because the hum and denoise detectors want contradictory waveforms:

      even rows — hum + HPF: strong 50 Hz line (Welch peak
        detection), 130 Hz line (>20% sub-200 Hz energy ratio after the
        notch removes the 50 Hz line)
      odd rows — denoise: AM-modulated square wave, whose
        constant-magnitude carrier keeps the sample-level 10th-percentile
        noise floor close to the mean energy (SNR estimate < 15 dB) while
        the 3 Hz AM gives the energy VAD the frame variation it needs for
        speech_prob >= 0.4

    Both wear a trapezoid fade (quiet STFT edge frames keep the quality
    gates' SNR estimate above the 5 dB reject line — a rejected clip is
    zeroed before conditioning and would skip the branches). Dereverb is
    NOT in the worst case: the reference's T60 estimate never exceeds 0.1 s
    on real audio (see frontend/conditioning.py:estimate_t60), so its
    > 0.5 s gate is unfireable there and, replicated bit-faithfully,
    unfireable here.
    The JAX package's tests/test_frontend.py::
    test_worst_case_audio_fires_all_dsp_branches pins all of these
    properties."""
    t = np.arange(samples) / sample_rate
    edge = max(1, int(0.12 * samples))
    env = np.minimum(1.0, np.minimum(np.arange(samples),
                                     np.arange(samples)[::-1]) / edge)
    am = 1.0 + 0.6 * np.sin(2 * np.pi * 3.0 * t)
    hum_clip = (0.3 * np.sin(2 * np.pi * 50.0 * t)
                + 0.3 * np.sin(2 * np.pi * 130.0 * t)
                + 0.12 * np.sin(2 * np.pi * 220.0 * t) * am)
    noisy_clip = 0.35 * am * np.sign(np.sin(2 * np.pi * 370.0 * t))
    x = np.where((np.arange(batch) % 2 == 0)[:, None],
                 hum_clip[None, :], noisy_clip[None, :]) \
        + 0.02 * rng.standard_normal((batch, samples))
    x = x * env[None, :]
    return np.clip(x, -1.0, 1.0).astype(np.float32)

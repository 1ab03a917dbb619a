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
              the port's cuDNN layers compute the same function; the
              group-mode extractor's two kernels (the front, conv 0 + its
              masked group norm + GELU, and A4) at the benchmark's three
              bucket shapes, each against its plain version and the
              unfused cuDNN chain, and the whole extractor on both routes;
              F2 (the grouped positional conv + bias + GELU) at the
              benchmark's wav2vec2-base and WavLM-Large shapes against its
              plain chain (flipped roundings in under 1e-3 of the outputs),
              with cuDNN's F.conv1d on the same shapes as the library
              yardstick the port never calls
  4. agree    a small model on the card against the same model on the CPU,
              with precomputed front-end features and, on 1 s worst-case /
              speech-like / padded rows, with the front-end DSP (gate
              decisions and conditioning flags equal); the TTA step
              (5 views, fed the same noise draws) and its resampled and
              noised views, card against CPU
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
                extractor (the front kernel and A4);
              - `flash_attention` at the attention sites of the flagship's
                shapes (kernel A3) and `attentive_stats_pooling` at its
                pooling sites (kernel A2), B=4 and B=128: the JAX package
                reaches these two kernels only through these functions;
              - manifest eval: 48 WAV clips of 0.6-7 s written here (three
                buckets), scored by the port's eval CLI at full width (random
                weights from seed 0 in a checkpoint, bf16) with 5-view TTA
                and a temperature calibrated on the same manifest: clips/s,
                ms per step, the time the steps waited for the loader, A1's
                launches, host reads per step, the WAV decoder, peak memory,
                and 48 prediction lines joined back to the manifest;
              - bench.py's TTA shape: the 5-view TTA step at B=128 (640
                rows) and B=4, 4 s clips, 32 tokens, the DSP on, then
                logits / 1.2: ms, utt/s, peak memory (kernel A1)
  6. train    training, through the entry points a user calls:
              - a small model's train step and `compute_loss` with its
                gradients on the card against the CPU (f32, dropout out),
                two steps, each from the CPU's parameters and optimizer
                state: losses and gradients within TRAIN_TOL, the parameters
                within TRAIN_TOL plus what AdamW's arithmetic makes of the
                gradients' difference; the frozen leaves bitwise unchanged;
              - the flagship train step, frozen backbones (the default
                TrainConfig), B=16, 4 s clips, 32 tokens, augmentation in
                the step with one speed factor a batch, with the DSP in the
                step and on zero features: ms, utt/s, peak memory, host
                reads a step, heads changed, backbones bitwise unchanged,
                A1 launched no time (the step takes the plain stack);
              - the flagship unfrozen (phase 2): B=16, grad_accum 2, remat
                "full", 3 steps: ms, peak memory, the backbones changed;
              - the train CLI on phase 5d's 48 clips (train and validation
                manifest), 2 epochs, batch 8, --augment --use_amp: seconds
                per epoch, the checkpoints, the frozen store written once,
                A1 on every validation and Weibull-fit step, a Weibull fit
                for every class; then a resume from epoch 0 for one epoch,
                and the eval CLI on the best checkpoint
  7. serve    serving, through the entry points a user calls, on phase 5d's
              full-width checkpoint (bf16, the DSP on):
              - the export CLI: the 4:32,8:16 buckets (torch.export programs,
                A1 as `ser_torch::residual_stack`, the DSP's gates as
                `torch.cond`), a 4 s B=32 int16-wire artifact and a 2-layer
                student: seconds and bytes of each;
              - the exported program against the eager forward on worst-case
                and speech-like rows (both branches of the gates): logits,
                uncertainty and features within AGREE_TOL, one A1 launch a
                predict, the int16 wire equal to the f32 wire on PCM, ms a
                predict at both buckets;
              - `serving.serve` in a thread on a free port: a lone request,
                a closed loop of 256 base64 requests of 1-8 s from 32
                clients, 32 float-list requests; requests/s, latency
                quantiles, batch fill, no batch errors, one A1 launch a
                batch, /healthz and /stats, then the drain;
              - the cascade tier (2-layer student, flagship teacher, the
                threshold at the median of the student's confidences):
                escalation rate;
              - the infer CLI with and without TTA (`--export` JSON), and
                the interface's ms a call after a warm call;
              - `DataFlowPipeline.process_long_audio` on a 12 s clip (ms a
                stage), `StreamingRecognizer` over it in 0.5 s chunks and
                `flush`, `verify_integration`; peak memory
  8. large    the large audio backbones at full width (24 layers, hidden
              1024, 16 heads, FFN 4096, the layer-norm conv stack) with
              XLM-R-base and the 35-layer head, bf16, random weights from
              seed 0; HuBERT-Large has wav2vec2-large's config and runs as it:
              - wav2vec2-large and wavlm-large on the card against the CPU,
                both encoders cut to 2 layers, f32 and bf16 (AGREE_TOL);
              - kernel A4's layer-norm route at [32, 12799, 512] bf16, with
                and without conv biases, against its plain version: ms, plain
                ms, the cuDNN layers with LN and GELU, the bound;
              - `model_forward` at B=4 and B=32, 4 s clips, 32 tokens, the DSP
                on worst-case audio: ms, utt/s, peak memory, A1's launches
                (wav2vec2-base too, at the same shapes);
              - `feature_encoder(allow_fused=True)` at B=4 and B=32, the
                layer-norm route of A4 on the path, against the unfused
                layer-norm extractor;
              - one frozen train step of wavlm-large at B=16: ms, peak memory;
              - migration: the port writes wavlm-large as a reference .pt,
                its import CLI infers the config (stable LN, gated bias, 16
                heads) and the same tree exactly, the logits equal the
                source's, and its eval CLI scores phase 5d's manifest with
                the import; the files are removed
  9. int8/asr int8 serving and Whisper ASR, through the entry points a user
              calls, on phase 5d's checkpoint and manifest:
              - the int8 product (`torch._int_mm`, rows under 17 padded)
                against the plain int32 matmul on the CPU, bitwise, at the
                flagship's [4*199, 768] x [768, 3072] and [128*199, 768] x
                [768, 768]; `linear_int8` card against CPU; times beside the
                bf16 product;
              - the flagship cut to 2 layers at full width with
                `quantize_backbones`, card against CPU from the same
                parameters (AGREE_TOL bf16: the int8 products exact on both
                sides); then the flagship eval forward with
                `quantize_backbones` beside the bf16 one, B=4 and B=128, the DSP on worst-case audio: ms,
                utt/s, peak memory, the backbones' layer bytes, int8 against
                bf16 logits (mean |d| / mean |logit| < 0.25, the JAX
                package's criterion), one A1 launch and one int8 product a
                quantised linear per forward;
              - the export CLI --int8 (one bucket, features precomputed), the
                program against the eager int8 forward (AGREE_TOL), the
                artifact's bytes; the eval CLI --int8 on the manifest, the
                infer CLI --int8 on a clip;
              - whisper-base (d 512, 6 + 6 layers, vocab 51865) card against
                CPU at 2 layers in f32 (tokens equal), then full depth in bf16
                at B=1, 8, 32 on 10 s clips in the 30 s window, 48 new
                tokens: log-mel, encode and decode ms, tokens/s, peak memory;
              - whisper-large-v3's geometry (d 1280, 32 + 32 layers, 128 mels)
                in bf16 and with `quantize_whisper`, B=1 and 8: the same, with
                the weights' bytes;
              - `EnhancedASRIntegration` over `TorchWhisperASR` (whisper-base,
                bf16, on the card) on a clip without text, its 8 features
                through `model_forward` with `use_asr`, then the eval CLI
                --use_asr on the manifest
 10. academic the evaluation suite, cascade fitting and distillation, on
              phase 5d's full-width checkpoint:
              - A1 at the slice's classifiers, the flagship's (L=35, D=512)
                at B = 1 and 8 and the distilled students' (L=8, D=256) and
                (L=3, D=64) at B = 1, 3, 8, 40, against its plain version:
                plans, ms, plain ms and the bound (comparison launches, not
                counted on the path);
              - card against CPU, the flagship cut to 2 layers at full
                width: `collect_logits` over 8 of the clips (bf16,
                AGREE_TOL), `add_noise_at_snr` babble, music and gaussian
                fed one draw (VIEW_TOL), one few-shot `adapt` step and one
                distill step into a 2-layer 'small' student with feature
                matching (f32, dropout out, TRAIN_TOL);
              - the `academic_eval` CLI on 48 new clips whose texts the
                code-mixing and zero-shot tables change: few-shot K 8 and
                16, SNR 10 and 0, zero-shot hi/bn/te, class 3 held out as
                unknown, the benchmark on: seconds per part, the CLI's s,
                every part in academic_evaluation.json, A1 once in each of
                its eval forwards, peak memory; every gathered pass finite,
                and each K's few-shot F1, accuracy and recovery rate finite,
                printed with its adaptation steps and the padded rows they
                dropped;
              - the `distill` CLI, flagship -> 'small' student, 1 epoch,
                batch 8: step ms (CUDA events between the steps that
                `make_distill_step` returns), epoch s, A1
                once a teacher forward and a validation step; the eval CLI
                --predictions_out on the student and on the teacher; the
                `fit_cascade` CLI at an escalation budget of 0.15
  11. rest   the last slice's modules, through the entry points a user calls:
              - 11a. the confidence fusion, cross-lingual and loss-integration
                functions and the legacy heads, card against CPU from the
                same inputs (f32, AGREE_TOL), gradient_reversal's gradient
                on the card among them;
              - 11b. `profiling.trace` around one flagship eval forward at
                B=4: the Chrome trace names A1's kernel, the forward's ms
                and the kernels' device ms (the events on the card alone);
                `device_memory_stats`' keys against the allocator's own
                counters; `debug.checked` raising on a NaN fed to the card;
              - 11c. a one-rank NCCL group from torchrun's environment
                (`multihost.initialize`, mesh (1, 1)): the flagship frozen
                train step through `shard_params(fsdp=True,
                fsdp_min_size=1)` and `shard_batch` (of a batch from
                `device_prefetch`, as the loop takes it) against the unsharded
                step from the same state (TRAIN_TOL), the ms of both (the
                difference is DTensor's host cost); the ring and pipeline
                stacks (P=1, M=4) at wav2vec2-base width, 4 s clips, B=8,
                bf16, against the dense `_encoder_stack` (AGREE_TOL);
              - 11d. the train CLI under the pod branch with world 1, --fsdp,
                on phase 5d's manifest, 1 epoch, batch 8: seconds, the
                checkpoint rank 0 wrote, A1's launches (its validation and
                Weibull passes)
              With more than one card the script says that 11c-d ran with
              world 1 only.
  12. tensor  the 'model' axis's Megatron split (parallel/tensor.py):
              - 12a. a one-rank NCCL group, mesh (1, 1), on the tensor-
                parallel code path: the flagship eval forward (B=4, 4 s, 32
                tokens, bf16, the DSP on) and a frozen B=16 train step
                against the unsharded ones, 0 difference;
              - 12b. two ranks on the one card (two processes of this
                script, gloo: NCCL takes one rank a card; the tensor-
                parallel path's collectives are all-reduces, which gloo
                carries for card tensors), mesh (1, 2): the flagship forward
                against one process (AGREE_TOL in bf16), a frozen B=16 step
                in f32 by step_card_against_cpu's rule against one process,
                the ms of each beside one process's (gloo's hops go through
                the host: a host cost, not NVLink's), A1's launches;
              - 12c. the same two ranks, mesh (2, 1): the `academic_eval`
                CLI on 10c's 48 clips and checkpoint against 10c's run:
                every eval pass's gathered rows (logits, labels, indices,
                SNRs, features) row for row, labels and indices equal, the
                rest finite and within AGREE_TOL; every F1 of its JSON and
                of each rank's results equal, the binned ECE / MCE equal to
                their value from the run's own rows, the other numbers (but
                timings and a sweep's arg-optima) within AGREE_TOL; its
                seconds and A1's launches
Then the script's wall time, the `kernels` line and, last,
{"ok": true, "device": {...}}.

A tolerance `tol` is held as the JAX package's tests hold theirs:
|kernel - plain| <= tol * (1 + |plain|) elementwise (rtol = atol = tol).

Any failure raises and exits non-zero; a machine without a CUDA device
exits 1 before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores
H100_BF16_FLOPS = 989e12     # bf16 tensor cores, dense
H100_INT8_OPS = 1979e12      # int8 tensor cores, dense
KERNEL_TOL = 1e-4            # kernel vs plain in f32: summation order
BF16_TOL = {"conv_tail": 4e-2,   # the JAX package's bound for the fused tail
            "attention": 3e-2}   # and for bf16 pooling: one output rounding
AGREE_TOL = {"float32": 1e-4,   # card vs CPU, TF32 off: summation order only
             "bfloat16": 3e-2}  # bf16 rounding at other places (the JAX package's bf16 bound)
VIEW_TOL = 1e-5      # resampled / noised views, card vs CPU: f32 summation order
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
KERNEL_NAMES = ("residual_stack", "conv_front", "conv_tail", "pos_conv", "flash_attention",
                "attentive_pooling")
EXTRACTOR_BUCKETS = ((512, 2), (256, 4), (128, 8))   # the benchmark's (clips, seconds) a batch
FRONT_FLIP_SHARE = 1e-3   # the front's outputs a bf16 step off the plain version's: sum order
# F2's shapes (B, T, C, Cg, K): the flagship's three buckets (wav2vec2-base) and
# WavLM-Large's 8 s bucket, the benchmark's; its flips are held like the front's
POS_CONV_SHAPES = {"flagship B=512 2s": (512, 99, 768, 48, 128),
                   "flagship B=256 4s": (256, 199, 768, 48, 128),
                   "flagship B=128 8s": (128, 399, 768, 48, 128),
                   "wavlm-large B=32 8s": (32, 399, 1024, 64, 128)}
TRAIN_TOL = 1e-4     # card vs CPU train step, f32, TF32 off: summation order only
TRAIN_LR = 1e-3
TRAIN_B = 16         # the flagship train step's batch
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
UNFROZEN_STEPS = 3
A1_TTA_BATCHES = (20, 40, 640)   # V*B rows of the TTA step: B=4, 8 (the CLI) and 128
MANIFEST_CLIPS = 48
CLIP_TEXTS = ("angry shouting words", "happy cheerful words", "sad crying words",
              "neutral plain words")
SERVE_BUCKETS = "4:32,8:16"     # the README's serving buckets: (seconds, batch size)
SERVE_CLIP_SECONDS = (1.0, 8.0)  # request clips spread over both buckets
SERVE_REQUESTS, SERVE_CLIENTS = 256, 32
FLOAT_REQUESTS = 32              # the same requests as JSON float lists
CASCADE_REQUESTS = 64
STUDENT_LAYERS = 2               # the cascade student: 2-layer encoders, full width
PREDICT_REPEATS = 5
LONG_CLIP_SECONDS = 12.0
STREAM_CHUNK_SECONDS = 0.5
WIRE_TOL = 1e-5      # int16 wire vs f32 wire on PCM: the same values reach the same ops
LARGE_PRESETS = ("wav2vec2-large", "wavlm-large")   # hubert-large has wav2vec2-large's config
AGREE_B = 4                      # rows of agree_rows
LARGE_AGREE_LAYERS = 2           # 8a: both encoders cut to 2 layers, full width
LARGE_BATCHES = ((4, REQUESTS_B4), (32, REQUESTS_B128))   # 32: scripts/tpu_large_backbones.py
LARGE_TAIL_B = 32                # 8c: A4's layer-norm route as a kernel
LARGE_TRAIN_STEPS = 3
WHISPER_PRESETS = {   # whisper-base: the reference's default; large-v3: scripts/tpu_asr_smoke.py
    "whisper-base": dict(vocab_size=51865, num_mel_bins=80, d_model=512, encoder_layers=6,
                         encoder_attention_heads=8, decoder_layers=6,
                         decoder_attention_heads=8, encoder_ffn_dim=2048,
                         decoder_ffn_dim=2048),
    "whisper-large-v3": dict(vocab_size=51866, num_mel_bins=128, d_model=1280,
                             encoder_layers=32, encoder_attention_heads=20,
                             decoder_layers=32, decoder_attention_heads=20,
                             encoder_ffn_dim=5120, decoder_ffn_dim=5120),
}
INT8_SHAPES = ((4 * 199, 768, 3072), (128 * 199, 768, 768))   # (rows, I, O) of 9a
INT8_AGREE_LAYERS = 2     # 9b's card-against-CPU check
INT8_CRITERION = 0.25     # mean |int8 - float| / mean |float| (tests/test_quant.py)
INT8_BATCHES = ((4, REQUESTS_B4), (128, REQUESTS_B128))   # 9b's forwards
INT8_BUCKET = "4:8"       # 9c's one exported bucket
ASR_NEW_TOKENS = 48       # TorchWhisperASR's default, as JaxWhisperASR's
ASR_CLIP_SECONDS = 10.0   # padded to Whisper's 30 s window
ASR_BATCHES = {"whisper-base": (1, 8, 32), "whisper-large-v3": (1, 8)}
ASR_AGREE_LAYERS = 2      # 9d's card-against-CPU check
ASR_EMBED_SCALE = 10.0    # spreads a random model's logits, so argmax ties cannot decide 9d
# 10a's (L, D) -> rows: the flagship's classifier at the benchmark's and the
# CLIs' batches (its teacher and eval forwards run B=8), then the 'small' and
# 'tiny' students' at 8, the CLIs' batch, and 40, its TTA step's
A1_SLICE_SHAPES = {(35, 512): (1, 8), (8, 256): (1, 3, 8, 40), (3, 64): (1, 3, 8, 40)}
ACADEMIC_LAYERS = 2                     # 10b: both encoders cut to 2 layers, full width
# 10c-d's clip texts: words of the code-mixing and zero-shot tables (the, is,
# and, a, it, good, angry, happy, sad, neutral), so both change what they feed
ACADEMIC_TEXTS = ("the angry one is shouting", "a happy word and a good smile",
                  "the sad one is crying", "it is a neutral word")
ACADEMIC_ARGS = ("--few_shot_shots", "8", "16", "--few_shot_epochs", "1", "--snr_levels",
                 "10", "0", "--zero_shot_langs", "hi", "bn", "te",
                 "--open_set_unknown_class", "3")
ACADEMIC_PARTS = ("baseline", "cross_lingual", "calibration", "asr_tracking", "risk_coverage",
                  "open_set", "inference_benchmark", "per_snr", "few_shot", "robustness",
                  "zero_shot", "per_class_accuracy", "confusion_matrix", "part_seconds")
CASCADE_BUDGET = 0.15
STACK_B = 8          # 11c's ring and pipeline stacks: B=8, 4 s clips, wav2vec2-base width
STACK_TOL = 2e-4     # ring / pipeline vs dense in f32 (the JAX package's ring test: 2e-4)
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
        raise AssertionError(f"{name}: max |got - want| {err} over tolerance {tol}")
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
    gates (the port's eval/benchmark.worst_case_dsp_audio, from a
    default_rng seeded with `seed`): even rows a 50 Hz hum over 130 Hz
    energy (notch, HPF), odd rows an AM square wave whose high sample-energy
    floor sets off the denoiser; both faded in and out over 12 % of the
    clip."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import benchmark
    return benchmark.worst_case_dsp_audio(np.random.default_rng(seed), B, T, SAMPLE_RATE)


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


def conv_tail_inputs(torch, B: int, T1: int, C: int, dtype, *, has_ln: bool, seed: int,
                     bias=None):
    """The tail's seven-layer stack (He-scaled kernels [C_out, C_in, K];
    biases where `bias`, by default with the LN) and a layer-0 output x1
    [B, T1, C] shaped like a GELU's."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
        conv_tail as ct)
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    convs = [{"kernel": rnd(C, 1, 10).to(dtype)}]
    for K in ct.TAIL_KERNELS:
        conv = {"kernel": (rnd(C, C, K) * (2.0 / (K * C)) ** 0.5).to(dtype)}
        if has_ln if bias is None else bias:
            conv["bias"] = (0.1 * rnd(C)).to(dtype)
        if has_ln:
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


def front_inputs(torch, B: int, seconds: int, C: int, seed: int):
    """wav2vec2-base's extractor at width C (He-scaled bf16 kernels, a
    perturbed group norm) and B normalised bf16 clips in a `seconds`
    bucket with ragged lengths: row 0 at the bucket's full length, row 1
    shorter than conv 0's kernel, the rest uniform in a quarter to all
    of it."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        wav2vec2 as w2v)
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    convs, c_in = [], 1
    for K in (10, 3, 3, 3, 3, 2, 2):
        convs.append({"kernel": (rnd(C, c_in, K) * (2.0 / (K * c_in)) ** 0.5).bfloat16()})
        c_in = C
    params = {"convs": convs, "group_norm": {"scale": 1 + 0.1 * rnd(C), "bias": 0.1 * rnd(C)}}
    T = seconds * SAMPLE_RATE
    samples = torch.randint(T // 4, T + 1, (B,), device="cuda", generator=g)
    samples[:2] = torch.tensor([T, 7], device="cuda")
    mask = (torch.arange(T, device="cuda")[None, :] < samples[:, None]).float()
    wave = w2v.normalize_waveform(rnd(B, T), mask).bfloat16()
    return params, wave, mask, samples


def conv_front_bound(B: int, T: int, C: int):
    """The waveform read once and the bf16 output written once, against
    conv 0's products once on the f32 CUDA cores."""
    T1 = (T - 10) // 5 + 1
    nbytes = 2 * B * T + 2 * B * T1 * C + 2 * 10 * C + 4 * 2 * C
    return bound(nbytes, 2 * 10 * B * T1 * C / H100_F32_FLOPS)


@contextlib.contextmanager
def unfused_extractor(w2v):
    """feature_encoder's group-mode route off: conv 0 and its f32 group
    norm unfused, as the port ran them before the front kernel."""
    route = w2v.front_route
    w2v.front_route = lambda *a: False
    try:
        yield
    finally:
        w2v.front_route = route


def extractor_phase(torch) -> dict:
    """Phase 3 for the group-mode extractor: the front kernel and A4 at the
    benchmark's bucket shapes (EXTRACTOR_BUCKETS, wav2vec2-base width),
    each against its plain version, with the front's share of outputs
    whose bf16 rounding flipped; times against their bounds, the unfused
    cuDNN chain and cuDNN's layers 1-6; the whole extractor on the two
    kernels against the unfused route. The tail and the whole extractor
    are compared on the rows with two valid frames or more: a row with
    none or one has no variance, so its group norm scales conv 0 by
    rsqrt(eps), about 316, and the tail's bf16 sums in another order
    then differ by more than a bound set for O(1) activations (A4 and
    cuDNN still agree there; the plain matmul does not)."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        layers, wav2vec2 as w2v)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
        conv_front as cf, conv_tail as ct)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
        Wav2Vec2Config)
    C = 512
    cfg = Wav2Vec2Config(conv_dim=(C,) * 7)
    tol = BF16_TOL["conv_tail"]
    out = {}
    for B, seconds in EXTRACTOR_BUCKETS:
        params, wave, mask, samples = front_inputs(torch, B, seconds, C, seed=B)
        conv0, gn = params["convs"][0], params["group_norm"]
        T = seconds * SAMPLE_RATE
        with torch.no_grad():
            reset_counts()
            x1 = cf.conv_front(conv0, gn, wave, samples, 5)
            x7 = ct.conv_tail(params["convs"], x1, has_ln=False)
            torch.cuda.synchronize()
            if (counts()["conv_front"], counts()["conv_tail"]) != (1, 1):
                raise AssertionError(f"extractor B={B}: one launch of each kernel expected")
            front_err, flipped = 0.0, 0
            for rows in torch.arange(B, device="cuda").split(32):
                want = cf.conv_front_plain(conv0, gn, wave[rows], samples[rows], 5)
                front_err = max(front_err, check_close(f"conv_front B={B}", x1[rows], want, tol))
                flipped += int((x1[rows] != want).sum())
                del want
            usual = (samples - 10) // 5 + 1 >= 2
            tail_err = check_close(f"conv_tail B={B}", x7[usual],
                                   ct.conv_tail_plain(params["convs"], x1[usual], has_ln=False),
                                   tol)
            x_cf = x1.transpose(1, 2).contiguous()   # the unfused route's layout

            def cudnn_layers():
                x = x_cf
                for conv in params["convs"][1:]:
                    x = layers.gelu(layers.conv1d(conv, x, 2))
                return x

            front_bound_ms, front_by = conv_front_bound(B, T, C)
            (tail_bound_ms, tail_by), flops = conv_tail_bound(B, x1.shape[1], C, torch.bfloat16)
            front_ms = cuda_ms(lambda: cf.conv_front(conv0, gn, wave, samples, 5), 10)
            tail_ms = cuda_ms(lambda: ct.conv_tail(params["convs"], x1, has_ln=False), 5)
            front = {
                "ms": front_ms, "bound_ms": front_bound_ms, "bound_by": front_by,
                "ms_over_bound": front_ms / front_bound_ms,
                "plain_ms": cuda_ms(lambda: cf.conv_front_plain(conv0, gn, wave, samples, 5),
                                    2, warmup=1),
                "plain_then_transpose_ms": cuda_ms(
                    lambda: cf.conv_front_plain(conv0, gn, wave, samples, 5).contiguous(),
                    2, warmup=1),
                "max_abs_err": front_err, "flipped_share": flipped / x1.numel()}
            if front["flipped_share"] >= FRONT_FLIP_SHARE:
                raise AssertionError(f"conv_front B={B}: {front['flipped_share']} of the "
                                     f"outputs differ from the plain version's, not under "
                                     f"{FRONT_FLIP_SHARE}: a rounding point moved")
            tail = {"ms": tail_ms, "bound_ms": tail_bound_ms, "bound_by": tail_by,
                    "ms_over_bound": tail_ms / tail_bound_ms, "tflop_per_s": flops / tail_ms / 1e9,
                    "cudnn_layers_ms": cuda_ms(cudnn_layers, 5, warmup=1),
                    "max_abs_err": tail_err}
            del x7, x_cf
            feats, frame_mask = w2v.feature_encoder(params, cfg, wave, mask)
            with unfused_extractor(w2v):
                want, want_mask = w2v.feature_encoder(params, cfg, wave, mask)
                unfused_ms = cuda_ms(lambda: w2v.feature_encoder(params, cfg, wave, mask), 3,
                                     warmup=1)
            if not torch.equal(frame_mask, want_mask):
                raise AssertionError(f"feature_encoder B={B}: frame masks differ")
            whole = {"ms": cuda_ms(lambda: w2v.feature_encoder(params, cfg, wave, mask), 5),
                     "unfused_ms": unfused_ms,
                     "max_abs_err": check_close(f"feature_encoder B={B}", feats[usual],
                                                want[usual], tol)}
        out[f"B={B} {seconds}s"] = {"T1": x1.shape[1], "front": front, "tail": tail,
                                    "feature_encoder": whole}
        del params, wave, mask, samples, x1, feats, want
        torch.cuda.empty_cache()
    return {"C": C, "tol": tol, "buckets": out}


def pos_conv_inputs(torch, B: int, T: int, C: int, Cg: int, K: int, seed: int):
    """F2's inputs: a kernel scaled as the init scales it, a bias, and h
    [B, T, C] zero past each clip's frames (row 0 all, row 1 none, row 2
    one, the rest a quarter to all of them), as wav2vec2_encode hands it."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    frames = torch.randint(T // 4, T + 1, (B,), device="cuda", generator=g)
    frames[:3] = torch.tensor([T, 0, 1], device="cuda")
    mask = (torch.arange(T, device="cuda")[None, :] < frames[:, None]).float()
    h = (torch.randn(B, T, C, device="cuda", generator=g) * mask[..., None]).bfloat16()
    conv = {"kernel": (torch.randn(C, Cg, K, device="cuda", generator=g)
                       * (4.0 / (K * C)) ** 0.5).bfloat16(),
            "bias": (0.1 * torch.randn(C, device="cuda", generator=g)).bfloat16()}
    return conv, h


def pos_conv_phase(torch) -> dict:
    """Phase 3 for F2 at POS_CONV_SHAPES: one launch a call; against the
    plain chain, the share of outputs whose bf16 rounding flipped (raised
    at FRONT_FLIP_SHARE) and the largest difference (within the tail's
    bf16 bound); times against the products' bound, the plain chain and
    cuDNN's grouped F.conv1d with its bias alone (the library yardstick)."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
        pos_conv as pc)
    out = {}
    for label, (B, T, C, Cg, K) in POS_CONV_SHAPES.items():
        conv, h = pos_conv_inputs(torch, B, T, C, Cg, K, seed=B + T)
        with torch.no_grad():
            reset_counts()
            got = pc.pos_conv(conv, h)
            torch.cuda.synchronize()
            if counts()["pos_conv"] != 1:
                raise AssertionError(f"pos_conv {label}: one launch expected")
            want = pc.pos_conv_plain(conv, h)
            flipped = got != want
            share = float(flipped.float().mean())
            if share >= FRONT_FLIP_SHARE:
                raise AssertionError(f"pos_conv {label}: {share} of the outputs differ from "
                                     f"the plain chain's, not under {FRONT_FLIP_SHARE}")
            err = check_close(f"pos_conv {label}", got, want, BF16_TOL["conv_tail"])
            del want, flipped
            x = h.transpose(1, 2)
            flops = 2.0 * B * T * C * Cg * K
            bound_ms, bound_by = bound(2 * (2 * B * T * C + C * Cg * K + C),
                                       flops / H100_BF16_FLOPS)
            ms = cuda_ms(lambda: pc.pos_conv(conv, h), 20)
            out[label] = {
                "B": B, "T": T, "C": C, "Cg": Cg, "K": K, "ms": ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "ms_over_bound": ms / bound_ms,
                "tflop_per_s": flops / ms / 1e9,
                "plain_ms": cuda_ms(lambda: pc.pos_conv_plain(conv, h), 3, warmup=1),
                "library_ms": cuda_ms(lambda: torch.nn.functional.conv1d(
                    x, conv["kernel"], conv["bias"], padding=K // 2, groups=C // Cg), 3,
                    warmup=1),
                "max_abs_err": err, "flipped_share": share}
        del conv, h, got, x
        torch.cuda.empty_cache()
    return {"tol": BF16_TOL["conv_tail"], "flip_share_limit": FRONT_FLIP_SHARE, "shapes": out}


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


def card_against_cpu(torch, mdl, cfg, batch: dict, tol: float, cpu_params=None) -> dict:
    """model_forward of one model (random CPU parameters from seed 3 unless
    given) on the card and on the CPU: each output's max |card - CPU|;
    raises where one is out of tolerance."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        tree_to)
    if cpu_params is None:
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


def agree_rows(seed: int) -> dict:
    """AGREE_B 1 s rows (row 1 padded to 0.6 s) with 10 text tokens and
    precomputed front-end features: the batch of the card-against-CPU
    checks at full width."""
    rng = np.random.default_rng(seed)
    B, T, S = AGREE_B, SAMPLE_RATE, 10
    mask = np.ones((B, T), np.float32)
    mask[1, int(0.6 * T):] = 0
    return {"audio": rng.standard_normal((B, T)).astype(np.float32) * mask,
            "audio_mask": mask, "text_ids": rng.integers(2, 1000, (B, S)).astype(np.int32),
            "text_mask": np.ones((B, S), np.float32),
            "quality_feats": rng.standard_normal((B, 8)).astype(np.float32),
            "cond_feats": rng.standard_normal((B, 12)).astype(np.float32)}


def tta_card_against_cpu(torch, audio: np.ndarray, audio_mask: np.ndarray, ids, text_mask):
    """The TTA views and the 5-view TTA step of a small model on the card
    against the CPU, both fed the same standard-normal noise draws: the
    resampled views and all five views within VIEW_TOL, masks equal, the
    step's logits within AGREE_TOL. Returns the errors."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import Config
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
        evaluate as ev)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as mdl)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import audio_dsp
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        tree_to)
    B, T = audio.shape
    x, m = torch.from_numpy(audio), torch.from_numpy(audio_mask)
    draws = [torch.from_numpy(np.random.default_rng(s).standard_normal((B, T))
                              .astype(np.float32)) for s in (21, 22)]
    errs = {}
    for orig, new in ((16000, 15200), (15200, 16000), (16000, 16800), (16800, 16000)):
        errs[f"sinc_resample {orig}->{new}"] = check_close(
            f"sinc_resample {orig}->{new} card vs CPU",
            audio_dsp.sinc_resample(x.cuda(), orig, new).cpu(),
            audio_dsp.sinc_resample(x, orig, new), VIEW_TOL)
    want_w, want_m = audio_dsp.tta_expand(x, m, num_tta=5, noise=draws)
    got_w, got_m = audio_dsp.tta_expand(x.cuda(), m.cuda(), num_tta=5,
                                        noise=[d.cuda() for d in draws])
    if not torch.equal(got_m.cpu(), want_m):
        raise AssertionError("tta_expand: the views' masks differ between card and CPU")
    errs["tta_expand views"] = check_close("tta_expand card vs CPU", got_w.cpu(), want_w,
                                           VIEW_TOL)
    lid = np.ones(B, np.float32), np.full(B, 0.3, np.float32)
    batch = {"audio": audio, "audio_mask": audio_mask, "text_ids": ids,
             "text_mask": text_mask, "lid_entropy": lid[0], "lid_conf": lid[1]}
    for dtype, tol in AGREE_TOL.items():
        cfg = Config(model=tiny_config(dtype, frontend_dsp=True))
        cpu_params = mdl.init_model(cfg.model, torch.Generator().manual_seed(3), "cpu")
        want = ev.make_tta_eval_step(cfg, 5, device="cpu")(cpu_params, batch, noise=draws)
        got = ev.make_tta_eval_step(cfg, 5, device="cuda")(tree_to(cpu_params, "cuda"),
                                                           batch, noise=draws)
        errs[f"tta_step {dtype}"] = check_close(f"TTA step {dtype} card vs CPU", got.cpu(),
                                                want, tol)
    return errs


def write_manifest_clips(root, n: int, seed: int, texts=CLIP_TEXTS) -> str:
    """n clips of 0.6-7 s (the 2, 4 and 8 s buckets) as 16-bit WAVs under
    root/datasets: a class tone (220-660 Hz) with two harmonics under a 3 Hz
    envelope and a little noise, labels 0-3 in turn, texts[label] for each
    clip. Returns the manifest's path."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
        audio_io, manifest)
    rng = np.random.default_rng(seed)
    wavdir = root / "datasets" / "clips"
    wavdir.mkdir(parents=True, exist_ok=True)
    items = []
    for i in range(n):
        label = i % 4
        L = int(SAMPLE_RATE * (0.6 + 6.4 * i / (n - 1)))
        t = np.arange(L) / SAMPLE_RATE
        f0 = 220.0 * (1 + label / 2)
        x = (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)) * (
            0.4 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(4 * np.pi * f0 * t)
            + 0.1 * np.sin(6 * np.pi * f0 * t))
        x += 0.01 * rng.standard_normal(L)
        audio_io.write_wav(wavdir / f"c{i:03d}.wav", x.astype(np.float32), SAMPLE_RATE)
        items.append({"audio": f"clips/c{i:03d}.wav", "text": texts[label],
                      "label": label, "dataset": "synthetic"})
    path = root / "manifest.jsonl"
    manifest.write_manifest(path, items)
    return str(path)


def dropout_free(cfg):
    """cfg with every dropout rate 0 and SpecAugment off: the train step's
    draws cannot match across devices, so card-against-CPU runs without.
    The front-end feature projections and fusions drop out at a fixed 0.1,
    so they are off too (the JAX package's grad-accumulation test does the
    same)."""
    import dataclasses
    return dataclasses.replace(
        cfg, classifier_dropout=0.0, cross_dropout=0.0, fusion_dropout=0.0,
        anchor_dropout=0.0, use_quality_gates=False, use_audio_conditioning=False,
        audio=dataclasses.replace(cfg.audio, hidden_dropout=0.0, attention_dropout=0.0,
                                  activation_dropout=0.0, apply_spec_augment=False),
        text=dataclasses.replace(cfg.text, hidden_dropout=0.0, attention_dropout=0.0))


def tree_leaves(tree):
    """(path, tensor) of a nested dict / list of tensors."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        leaves_with_paths)
    return list(leaves_with_paths(tree))


def cloned(tree):
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        map_leaves)
    return map_leaves(tree, lambda _, t: t.clone())


def train_card_against_cpu(torch, small: dict) -> dict:
    """A small model's train step on the card against the CPU, f32, dropout
    out (the plain classifier stack, as in training): two steps, each from
    the CPU's parameters and optimizer state on both devices. For each,
    compute_loss, its gradients and the parameters after the step through
    `step_card_against_cpu`, and the step's own loss within TRAIN_TOL; the
    frozen leaves bitwise equal to where they started, the count one more.
    Returns the errors of each step."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import TrainConfig
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as mdl)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        optimizer as opt_lib, train_step as ts)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        tree_to)
    cfg = dropout_free(tiny_config("float32"))
    tcfg = TrainConfig(grad_clip=1.0)
    batch = {**small, "labels": np.array([0, 1, 2, 3], np.int32)}
    start = mdl.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    frozen = tree_leaves({k: start[k] for k in ("audio_backbone", "text_backbone")})
    opt = opt_lib.make_train_optimizer(start, lr=TRAIN_LR, total_steps=4)
    steps = {dev: ts.make_train_step(cfg, tcfg, opt, device=dev) for dev in ("cpu", "cuda")}
    params, state = cloned(start), opt.init(start)
    errs = {}
    for n in (1, 2):
        before = cloned(state)
        runs = {}
        for dev, p, s in (("cuda", tree_to(params, "cuda"), tree_to(state, "cuda")),
                          ("cpu", params, state)):
            loss, grads = loss_and_grads(torch, opt, p, lambda view: ts.compute_loss(
                view, cfg, tcfg, batch, generator=torch.Generator(device=dev).manual_seed(0))[0])
            metrics = steps[dev](p, s, batch, n)
            runs[dev] = {"loss": loss, "grads": grads, "params": p, "metrics": metrics}
            leaves = dict(tree_leaves(p))
            if any(not torch.equal(leaves[path].cpu(), t) for path, t in frozen):
                raise AssertionError(f"{dev}: a frozen leaf changed in train step {n}")
            if int(s["count"]) != n:
                raise AssertionError(f"{dev}: step count {int(s['count'])} after {n} steps")
        errs[f"step {n}"] = {
            **step_card_against_cpu(torch, opt, before, runs["cuda"], runs["cpu"]),
            "step_loss": check_close("train step loss card vs CPU",
                                     runs["cuda"]["metrics"].loss.cpu(),
                                     runs["cpu"]["metrics"].loss, TRAIN_TOL)}
    return errs


def train_phases(torch, smi: str, cfg, small: dict, work: Path, manifest: str) -> int:
    """Phase 6 (see the module docstring). Returns A1's launches on the
    paths it drives (the train CLI's validation and Weibull-fit passes, the
    eval CLI's steps)."""
    import dataclasses
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli import (
        eval as eval_cli, train as train_cli)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
        DataConfig, TrainConfig)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
        pipeline, tokenizer)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as mdl)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import audio_dsp
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        checkpoint as ckpt, optimizer as opt_lib, train_step as ts)

    # 6a. a small model's loss, gradients and train steps, card against CPU
    emit({"phase": "agree", "path": "train_step", "dtype": "float32", "dropout": 0.0,
          "tol": TRAIN_TOL, "max_abs_diff": train_card_against_cpu(torch, small)})

    # 6b. the flagship train step, frozen backbones (the default TrainConfig)
    params = mdl.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    frozen = cloned({k: params[k] for k in ("audio_backbone", "text_backbone")})
    heads = cloned({k: params[k] for k in ("audio_adapter", "cross", "fusion", "classifier")})
    tcfg = TrainConfig(batch_size=TRAIN_B, augment=True)
    opt = opt_lib.make_train_optimizer(params, lr=1e-4, total_steps=100)
    state = opt.init(params)
    step = ts.make_train_step(cfg, tcfg, opt)
    zero_feats = example_batch(TRAIN_B, T=CLIP_SAMPLES, S=TEXT_TOKENS, vocab=cfg.text.vocab_size)
    zero_feats["labels"] = np.arange(TRAIN_B, dtype=np.int32) % cfg.num_labels
    with_dsp = {k: v for k, v in zero_feats.items() if k not in ("quality_feats", "cond_feats")}
    with_dsp["audio"] = speech_like(TRAIN_B, CLIP_SAMPLES, seed=11)
    # each speed factor's resampler kernel goes to the card once, at its
    # first use: do that for every factor before the steps are timed
    probe = torch.zeros(1, SAMPLE_RATE, device="cuda")
    for f in audio_dsp.SPEED_FACTORS:
        audio_dsp.speed_perturb(probe, f)
    seed = 0
    for label, host_batch, want_reads in (("the DSP in the step", with_dsp, DSP_HOST_READS),
                                          ("zero features", zero_feats, 0)):
        batch = {k: torch.from_numpy(v).cuda() for k, v in host_batch.items()}
        for _ in range(TRAIN_WARMUP):
            step(params, state, batch, seed)
            seed += 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            step(params, state, batch, seed)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            seed += 1
        metrics, reads = host_reads(torch, lambda: step(params, state, batch, seed))
        seed += 1
        count = counts()
        peak = torch.cuda.max_memory_allocated()
        values = {k: float(v) for k, v in metrics._asdict().items()}
        if not all(np.isfinite(v) for v in values.values()):
            raise AssertionError(f"train step ({label}): metrics not finite: {values}")
        if count["residual_stack"]:
            raise AssertionError(f"train step ({label}): residual_stack launched "
                                 f"{count['residual_stack']} times; training takes the plain stack")
        if reads != want_reads:
            raise AssertionError(f"train step ({label}): {reads} host reads, not {want_reads}")
        # the frozen extractor records no gradient: the kernels in every step
        expect_extractor(count, TRAIN_STEPS + 1, f"train step, frozen backbones ({label})")
        ms = 1e3 * sorted(times)[len(times) // 2]
        emit({"phase": "path", "path": f"train step, frozen backbones, {label}", "card": smi,
              "B": TRAIN_B, "seconds": 4.0, "text_tokens": TEXT_TOKENS, "augment": True,
              "speed_per_batch": True, "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS,
              "step_ms": ms, "step_ms_all": [1e3 * t for t in times],
              "utt_per_s": TRAIN_B / (ms / 1e3), "max_memory_allocated": peak,
              "host_reads_per_step": reads, "metrics": values, "launches": count,
              "step_count": int(state["count"])})
        del batch
    changed = [p for p, t in tree_leaves(heads)
               if not torch.equal(t, dict(tree_leaves(params))[p])]
    same = all(torch.equal(t, dict(tree_leaves(params))[p]) for p, t in tree_leaves(frozen))
    if not changed or not same:
        raise AssertionError(f"frozen train steps: {len(changed)} head leaves changed, "
                             f"backbones bitwise unchanged: {same}")
    emit({"phase": "path", "path": "train step, frozen backbones: what changed",
          "head_leaves_changed": len(changed), "head_leaves": len(tree_leaves(heads)),
          "backbones_bitwise_unchanged": same})
    del heads, state, opt, step
    torch.cuda.empty_cache()

    # 6c. unfrozen (phase 2): B=16 as 2 microbatches, remat "full"
    cfg_u = dataclasses.replace(cfg, remat_encoders="full")
    tcfg_u = TrainConfig(batch_size=TRAIN_B, augment=True, freeze_backbones=False, grad_accum=2)
    opt = opt_lib.make_train_optimizer(params, lr=1e-4, total_steps=100, freeze_backbones=False)
    state = opt.init(params)
    step = ts.make_train_step(cfg_u, tcfg_u, opt)
    batch = {k: torch.from_numpy(v).cuda() for k, v in zero_feats.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for i in range(UNFROZEN_STEPS):
        t0 = time.perf_counter()
        metrics = step(params, state, batch, 100 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    count = counts()
    peak = torch.cuda.max_memory_allocated()
    moved = sum(not torch.equal(t, dict(tree_leaves(params))[p]) for p, t in tree_leaves(frozen))
    if not np.isfinite(float(metrics.loss)) or not moved or count["residual_stack"]:
        raise AssertionError(f"unfrozen train steps: loss {float(metrics.loss)}, {moved} "
                             f"backbone leaves changed, launches {count}")
    expect_extractor(count, 0, "train step, unfrozen")   # a gradient: the unfused path
    emit({"phase": "path", "path": "train step, unfrozen (phase 2), grad_accum 2, remat full",
          "card": smi, "B": TRAIN_B, "microbatch": TRAIN_B // 2, "seconds": 4.0,
          "text_tokens": TEXT_TOKENS, "steps": UNFROZEN_STEPS, "step_ms": [1e3 * t for t in times],
          "max_memory_allocated": peak, "backbone_leaves_changed": moved,
          "backbone_leaves": len(tree_leaves(frozen)), "loss": float(metrics.loss),
          "launches": count})
    del params, frozen, state, opt, step, batch
    torch.cuda.empty_cache()

    # 6d. the train CLI on phase 5d's clips, a resume, then the eval CLI
    save_dir = work / "train"
    datasets = str(work / "datasets")
    args = ["--train_manifest", manifest, "--val_manifest", manifest, "--epochs", "2",
            "--batch_size", "8", "--augment", "--use_amp", "--save_dir", str(save_dir),
            "--dataset_root", datasets]
    val_steps = pipeline.BucketedLoader(
        pipeline.SERDataset(manifest, DataConfig(dataset_root=datasets)), batch_size=8,
        tokenizer=tokenizer.get_tokenizer(vocab_size=cfg.text.vocab_size),
        shuffle=False).batches_per_epoch()
    train_steps = pipeline.BucketedLoader(   # the train loop's full batches an epoch
        pipeline.SERDataset(manifest, DataConfig(dataset_root=datasets)), batch_size=8,
        tokenizer=tokenizer.get_tokenizer(vocab_size=cfg.text.vocab_size), shuffle=True,
        drop_remainder=True).batches_per_epoch()
    a1 = 0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = train_cli.main(args)
    cli_s = time.perf_counter() - t0
    count = counts()
    peak = torch.cuda.max_memory_allocated()
    history = res["history"]
    del res
    torch.cuda.empty_cache()
    epochs = {int(d.name.split("_")[1]): d for d in save_dir.glob("epoch_*")}
    if sorted(epochs) != [0, 1] or len(history) != 2:
        raise AssertionError(f"train CLI: checkpoints {sorted(d.name for d in epochs.values())}, "
                             f"{len(history)} epochs")
    # the loop's best is the first epoch with the highest F1
    best, last = epochs[int(np.argmax([h["val_f1"] for h in history]))], epochs[1]
    passes = len(history) + 1 + (best != last)   # validation, Weibull fit (+ the best's)
    if count["residual_stack"] != passes * val_steps:
        raise AssertionError(f"train CLI: residual_stack launched {count['residual_stack']} "
                             f"times, not {passes} passes x {val_steps} steps")
    a1 += count["residual_stack"]
    expect_extractor(count, count["residual_stack"] + len(history) * train_steps, "train CLI")
    store = save_dir / "frozen_store"
    store_params = store / ckpt.PARAMS_FILE
    written = store_params.stat().st_mtime_ns
    if (sorted(p.name for p in save_dir.glob("*/frozen_store")) or
            not all((d / ckpt.FROZEN_REF).exists() for d in epochs.values()) or
            any(written >= (d / ckpt.PARAMS_FILE).stat().st_mtime_ns for d in epochs.values())):
        raise AssertionError("train CLI: the checkpoints do not share one frozen store "
                             "written before them")
    final, _ = ckpt.restore_checkpoint(last)
    weibull = {k: v.cpu() for k, v in final["classifier"]["weibull"].items()}
    fitted = [c for c in range(cfg.num_labels)
              if weibull["alpha"][c] == 2.5 and weibull["activation_vectors"][c].abs().sum() > 0]
    if fitted != list(range(cfg.num_labels)):
        raise AssertionError(f"train CLI: Weibull fitted for classes {fitted} only: {weibull}")
    ckpt_bytes = {d.name: (d / ckpt.PARAMS_FILE).stat().st_size
                  + (d / ckpt.OPT_STATE_FILE).stat().st_size for d in epochs.values()}
    del final
    emit({"phase": "path", "path": "train CLI (2 epochs, batch 8, --augment --use_amp)",
          "card": smi, "clips": MANIFEST_CLIPS, "cli_s": cli_s,
          "epoch_s": [h["seconds"] for h in history], "val_f1": [h["val_f1"] for h in history],
          "train_loss": [h["train_loss"] for h in history],
          "checkpoints": sorted(ckpt_bytes), "checkpoint_bytes": ckpt_bytes,
          "frozen_store_bytes": store_params.stat().st_size, "best": best.name,
          "weibull_alpha": weibull["alpha"].tolist(), "weibull_beta": weibull["beta"].tolist(),
          "val_steps": val_steps, "launches": count, "max_memory_allocated": peak})

    reset_counts()
    t0 = time.perf_counter()
    res = train_cli.main(args + ["--resume_from", str(epochs[0])])
    resume_s = time.perf_counter() - t0
    count = counts()
    resumed = res["history"]
    del res
    torch.cuda.empty_cache()
    if [h["epoch"] for h in resumed] != [1] or count["residual_stack"] != 2 * val_steps:
        raise AssertionError(f"resume: epochs {[h['epoch'] for h in resumed]}, "
                             f"residual_stack launched {count['residual_stack']} times")
    if store_params.stat().st_mtime_ns != written:
        raise AssertionError("resume: the frozen store was written again")
    a1 += count["residual_stack"]
    expect_extractor(count, count["residual_stack"] + train_steps, "train CLI --resume_from")
    emit({"phase": "path", "path": "train CLI --resume_from epoch_0 (1 epoch)", "card": smi,
          "cli_s": resume_s, "epoch_s": resumed[0]["seconds"], "val_f1": resumed[0]["val_f1"],
          "straight_val_f1": history[1]["val_f1"], "train_loss": resumed[0]["train_loss"],
          "straight_train_loss": history[1]["train_loss"], "launches": count})

    reset_counts()
    t0 = time.perf_counter()
    res = eval_cli.main(["--manifest", manifest, "--checkpoint", str(best), "--batch_size", "8"])
    eval_s = time.perf_counter() - t0
    count = counts()
    if (res["logits"].shape != (MANIFEST_CLIPS, cfg.num_labels)
            or not np.isfinite(res["logits"]).all()
            or count["residual_stack"] != len(res["step_seconds"])):
        raise AssertionError(f"eval CLI on {best.name}: logits {res['logits'].shape}, "
                             f"launches {count} in {len(res['step_seconds'])} steps")
    a1 += count["residual_stack"]
    expect_extractor(count, count["residual_stack"], "eval CLI on the trained checkpoint")
    emit({"phase": "path", "path": "eval CLI on the trained checkpoint", "card": smi,
          "checkpoint": best.name, "cli_s": eval_s, "weighted_f1": res["weighted_f1"],
          "steps": len(res["step_seconds"]), "launches": count})
    del res
    torch.cuda.empty_cache()
    return a1


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def local_opener():
    """urllib without proxies: the server is on this machine's loopback."""
    import urllib.request
    return urllib.request.build_opener(urllib.request.ProxyHandler({}))


def get_json(opener, url: str) -> dict:
    with opener.open(url, timeout=30) as r:
        return json.loads(r.read())


def request_clips(n: int, seconds, seed: int):
    """n clips of uniform length in `seconds`, int16 PCM (a tone pair under
    a 3 Hz envelope and a little noise), with a text each."""
    rng = np.random.default_rng(seed)
    clips = []
    for i in range(n):
        L = int(SAMPLE_RATE * rng.uniform(*seconds))
        t = np.arange(L) / SAMPLE_RATE
        f0 = rng.uniform(150.0, 400.0)
        x = (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)) * (
            0.3 * np.sin(2 * np.pi * f0 * t) + 0.15 * np.sin(4 * np.pi * f0 * t))
        x += 0.01 * rng.standard_normal(L)
        clips.append((np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16),
                      CLIP_TEXTS[i % len(CLIP_TEXTS)]))
    return clips


def post_all(url: str, bodies, clients: int):
    """A closed loop: `clients` threads POST the bodies to /predict, each
    its next one as soon as its last came back. Returns (wall seconds, the
    latency of each request in ms, the responses, the failures)."""
    import threading
    import urllib.request
    opener = local_opener()
    latency, responses, failures = [None] * len(bodies), [None] * len(bodies), []
    order = iter(range(len(bodies)))
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                i = next(order, None)
            if i is None:
                return
            req = urllib.request.Request(url + "/predict", data=bodies[i],
                                         headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with opener.open(req, timeout=600) as r:
                    responses[i] = json.loads(r.read())
            except OSError as e:
                failures.append(f"{type(e).__name__}: {e}")
            latency[i] = 1e3 * (time.perf_counter() - t0)

    threads = [threading.Thread(target=client) for _ in range(min(clients, len(bodies)))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads):
        raise AssertionError("HTTP clients still running after 900 s")
    return wall, latency, responses, failures


def quantiles(ms) -> dict:
    a = np.asarray(ms, np.float64)
    return {"p50": float(np.percentile(a, 50)), "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99)), "max": float(a.max())}


def artifact_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def serve_phases(torch, smi: str, cfg, work: Path, *, device: str = "cuda",
                 buckets: str = SERVE_BUCKETS, clip_seconds=SERVE_CLIP_SECONDS,
                 requests: int = SERVE_REQUESTS, clients: int = SERVE_CLIENTS,
                 float_requests: int = FLOAT_REQUESTS,
                 cascade_requests: int = CASCADE_REQUESTS,
                 long_clip_seconds: float = LONG_CLIP_SECONDS,
                 segment_seconds: float = 4.0) -> int:
    """Phase 7 (see the module docstring) on phase 5d's checkpoint
    (`work/checkpoint`, `cfg`'s model). Returns A1's launches on the paths
    it drives. The keywords cut it to a tiny model's size for a CPU
    rehearsal."""
    import base64
    import dataclasses
    import threading
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
        export as ex, frontend, integration, interface, serving)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli import (
        export as export_cli, infer as infer_cli)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
        Config, to_json)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import tokenizer
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as mdl)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        checkpoint as ckpt)
    cuda = torch.device(device).type == "cuda"
    ck = work / "checkpoint"

    def extractor(want: int, what: str) -> None:
        # every predict and forward here runs a wav2vec2-base extractor in bf16
        # with no gradient: the kernels, on the card only
        expect_extractor(counts(), want if cuda else 0, f"serve: {what}")
    tok = tokenizer.HashTokenizer(cfg.text.vocab_size)
    (s0, b0), (s1, b1) = [(float(a), int(b)) for a, b in
                          (pair.split(":") for pair in buckets.split(","))]
    a1 = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # 7a. export through the CLI: the bucketed f32 artifacts, one int16-wire
    # artifact at the first bucket's shape, the cascade's student
    student_cfg = dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, num_hidden_layers=STUDENT_LAYERS),
        text=dataclasses.replace(cfg.text, num_hidden_layers=STUDENT_LAYERS))
    student = mdl.init_model(student_cfg, torch.Generator(device=device).manual_seed(1), device)
    ckpt.save_checkpoint(work / "student", params=student,
                         config_json=to_json(Config(model=student_cfg)))
    del student
    common = ["--text_tokens", str(TEXT_TOKENS), "--device", device]
    exports = {}
    for name, args in (
            ("buckets", ["--checkpoint", str(ck), "--buckets", buckets]),
            ("int16", ["--checkpoint", str(ck), "--batch_size", str(b0),
                       "--audio_seconds", str(s0), "--wire", "int16"]),
            ("student", ["--checkpoint", str(work / "student"), "--buckets", buckets])):
        out = work / f"serve_{name}"
        t0 = time.perf_counter()
        export_cli.main(args + ["--out_dir", str(out)] + common)
        exports[name] = {"seconds": time.perf_counter() - t0, "bytes": artifact_bytes(out),
                         "program_bytes": sum(f.stat().st_size
                                              for f in out.rglob("program.pt2"))}
    emit({"phase": "path", "path": "serve: export CLI", "card": smi, "buckets": buckets,
          "text_tokens": TEXT_TOKENS, "student_layers": STUDENT_LAYERS, "exports": exports})
    art, art_i16, art_student = (work / f"serve_{n}" for n in ("buckets", "int16", "student"))
    first = f"b{s0:g}s_bs{b0}"

    # 7b. the exported program against the eager forward, both DSP branches
    params, _ = ckpt.restore_checkpoint(ck, device=device)
    served = ex.ServingModel(art / first, device)
    served_i16 = ex.ServingModel(art_i16, device)
    T0 = int(s0 * SAMPLE_RATE)
    agree = {}
    for kind, make in (("worst_case", worst_case_dsp_audio), ("speech_like", speech_like)):
        pcm = np.clip(np.rint(make(b0, T0, seed=7) * 32768.0), -32768, 32767).astype(np.int16)
        lens = np.full(b0, T0, np.int32)
        lens[1::4] = T0 * 3 // 4           # some rows padded
        mask = (np.arange(T0)[None, :] < lens[:, None]).astype(np.float32)
        pcm[mask == 0] = 0
        ids = example_batch(b0, T0, TEXT_TOKENS, cfg.text.vocab_size, seed=3)
        batch = {"audio": pcm.astype(np.float32) / 32768.0, "audio_mask": mask,
                 "text_ids": ids["text_ids"], "text_mask": ids["text_mask"],
                 "lid_entropy": np.ones(b0, np.float32), "lid_conf": np.zeros(b0, np.float32)}
        dev = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        stats = frontend.frontend_process(dev["audio"], dev["audio_mask"],
                                          lid_entropy=dev["lid_entropy"],
                                          lid_confidence=dev["lid_conf"])[3]
        fired = dsp_flags(stats)
        heavy = ("hum_filtered", "hpf_applied", "denoise_applied")
        if (kind == "worst_case") != all(fired[f] > 0 for f in heavy) or (
                kind == "speech_like" and any(fired[f] for f in heavy)):
            raise AssertionError(f"serve {kind}: the gates took {fired}")
        reset_counts()
        got = served.predict(batch)
        extractor(1, f"{kind}, one predict")
        count = counts()["residual_stack"]
        if count != 1:
            raise AssertionError(f"serve {kind}: one predict launched A1 {count} times")
        a1 += count
        with torch.inference_mode():
            o = mdl.model_forward(params, cfg, dev, use_openmax=True)
        want = {"logits": o.logits, "uncertainty": o.uncertainty, "features": o.features}
        diff = {k: float(np.abs(got[k] - want[k].float().cpu().numpy()).max()) for k in want}
        for k, v in got.items():
            if not np.isfinite(v).all():
                raise AssertionError(f"serve {kind}: {k} is not finite")
        if max(diff.values()) > AGREE_TOL[cfg.compute_dtype]:
            raise AssertionError(f"serve {kind}: exported vs eager {diff}")
        reset_counts()
        wire = served_i16.predict({**{k: batch[k] for k in batch if k not in
                                      ("audio", "audio_mask")}, "audio": pcm, "audio_len": lens})
        a1 += counts()["residual_stack"]
        extractor(1, f"{kind}, one int16-wire predict")
        wire_diff = {k: float(np.abs(wire[k] - got[k]).max()) for k in got}
        if not all(np.allclose(wire[k], got[k], rtol=WIRE_TOL, atol=WIRE_TOL) for k in got):
            raise AssertionError(f"serve {kind}: int16 wire vs f32 wire {wire_diff}")
        times, eager_times = [], []
        reset_counts()
        for _ in range(PREDICT_REPEATS):
            t0 = time.perf_counter()
            served.predict(batch)
            times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            with torch.inference_mode():
                mdl.model_forward(params, cfg, dev, use_openmax=True).logits.cpu()
            eager_times.append(time.perf_counter() - t0)
        count = counts()["residual_stack"]
        extractor(2 * PREDICT_REPEATS, f"{kind}, predicts and eager forwards")
        if count != 2 * PREDICT_REPEATS:
            raise AssertionError(f"serve {kind}: {count} launches in {PREDICT_REPEATS} "
                                 f"predicts and forwards")
        a1 += count
        agree[kind] = {"max_abs_diff": diff, "int16_vs_f32_wire": wire_diff,
                       "branches": fired, "predict_ms": 1e3 * float(np.median(times)),
                       "predict_ms_all": [1e3 * x for x in times],
                       "eager_forward_ms": 1e3 * float(np.median(eager_times))}
        del dev, o, want
    served_second = ex.ServingModel(art / f"b{s1:g}s_bs{b1}", device)
    T1 = int(s1 * SAMPLE_RATE)
    batch1 = example_batch(b1, T1, TEXT_TOKENS, cfg.text.vocab_size, seed=4)
    batch1 = {"audio": speech_like(b1, T1, seed=4), "audio_mask": np.ones((b1, T1), np.float32),
              "text_ids": batch1["text_ids"], "text_mask": batch1["text_mask"],
              "lid_entropy": np.ones(b1, np.float32), "lid_conf": np.zeros(b1, np.float32)}
    times = []
    reset_counts()
    for _ in range(PREDICT_REPEATS + 1):
        t0 = time.perf_counter()
        served_second.predict(batch1)
        times.append(time.perf_counter() - t0)
    a1 += counts()["residual_stack"]
    extractor(PREDICT_REPEATS + 1, "the second bucket's predicts")
    emit({"phase": "path", "path": "serve: exported program vs eager model_forward",
          "card": smi, "B": b0, "seconds": s0, "tol": AGREE_TOL[cfg.compute_dtype],
          "wire_tol": WIRE_TOL, "agree": agree,
          "second_bucket": {"B": b1, "seconds": s1, "first_ms": 1e3 * times[0],
                            "predict_ms": 1e3 * float(np.median(times[1:]))}})
    del served, served_i16, served_second
    if cuda:
        torch.cuda.empty_cache()

    # 7c. HTTP: serving.serve in a thread on a free port, the bucketed
    # artifacts; a lone request, a closed loop of base64 int16 requests from
    # `clients` threads, then float-list requests; /healthz and /stats
    captured = []
    make_http_server = serving.make_http_server

    def capture(*args, **kwargs):
        captured.append(make_http_server(*args, **kwargs))
        return captured[-1]

    serving.make_http_server = capture
    # each bucket worker's predict, timed: how much of a loop the programs
    # take, and how a predict under load compares with one alone (7b)
    predict_s = []
    predict = ex.ServingModel.predict

    def timed_predict(self, batch):
        t0 = time.perf_counter()
        out = predict(self, batch)
        predict_s.append(time.perf_counter() - t0)
        return out

    ex.ServingModel.predict = timed_predict
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    t_start = time.perf_counter()
    server = threading.Thread(target=serving.serve, args=(str(art),), daemon=True,
                              kwargs=dict(host="127.0.0.1", port=port, tokenizer=tok,
                                          device=device))
    server.start()
    opener = local_opener()
    try:
        while True:
            try:
                health = get_json(opener, url + "/healthz")
                break
            except OSError:
                if not server.is_alive() or time.perf_counter() - t_start > 600:
                    raise AssertionError("serve: the server did not come up") from None
                time.sleep(0.5)
        startup_s = time.perf_counter() - t_start
        clips = request_clips(requests, clip_seconds, seed=5)
        b64 = [json.dumps({"audio_b64": base64.b64encode(pcm.astype("<i2").tobytes()).decode(),
                           "sample_rate": SAMPLE_RATE, "text": text}).encode()
               for pcm, text in clips]
        floats = [json.dumps({"audio": (pcm.astype(np.float32) / 32768.0).tolist(),
                              "sample_rate": SAMPLE_RATE, "text": text}).encode()
                  for pcm, text in clips[:float_requests]]
        reset_counts()
        _, lone_ms, _, failed = post_all(url, b64[:1], 1)
        count = counts()["residual_stack"]
        extractor(1, "the lone HTTP request")
        if failed or count != 1:
            raise AssertionError(f"serve: the lone request: {failed}, {count} launches")
        a1 += count
        loops = {}
        for name, bodies in (("audio_b64", b64), ("float_lists", floats)):
            before = get_json(opener, url + "/stats")
            reset_counts()
            predict_s.clear()
            wall, ms, responses, failed = post_all(url, bodies, clients)
            count = counts()["residual_stack"]
            after = get_json(opener, url + "/stats")
            batches = after["batches"] - before["batches"]
            extractor(batches, f"HTTP {name} batches")
            if failed or after["batch_errors"] or any(r is None or "emotion" not in r
                                                       for r in responses):
                raise AssertionError(f"serve {name}: {len(failed)} failed, "
                                     f"{after['batch_errors']} batch errors: {failed[:3]}")
            if count != batches:
                raise AssertionError(f"serve {name}: A1 launched {count} times in "
                                     f"{batches} batches")
            a1 += count
            by_bucket = {}
            for r in responses:
                by_bucket[r["bucket_seconds"]] = by_bucket.get(r["bucket_seconds"], 0) + 1
            loops[name] = {"requests": len(bodies), "clients": min(clients, len(bodies)),
                           "wall_s": wall, "requests_per_s": len(bodies) / wall,
                           "latency_ms": quantiles(ms), "batches": batches,
                           # the server's fills are a running mean over its batches
                           "mean_batch_fill": (after["mean_batch_fill"] * after["batches"]
                                               - before["mean_batch_fill"] * before["batches"])
                           / batches,
                           "requests_by_bucket": by_bucket,
                           "predict_ms": quantiles([1e3 * x for x in predict_s]),
                           "predict_share_of_wall": sum(predict_s) / wall,
                           "body_mb": sum(map(len, bodies)) / 2 ** 20, "launches": count,
                           "server_stats": after}
        health = get_json(opener, url + "/healthz")
        if health["status"] != "ok" or [b["batch_size"] for b in health["buckets"]] != [b0, b1] \
                or not all(b["loaded"] for b in health["buckets"]):
            raise AssertionError(f"serve: /healthz {health}")
    finally:
        serving.make_http_server = make_http_server
        ex.ServingModel.predict = predict
        if captured:
            captured[0].shutdown()
        server.join(timeout=120)
    if server.is_alive():
        raise AssertionError("serve: the server did not drain")
    emit({"phase": "path", "path": "serve: HTTP (serving.serve in a thread)", "card": smi,
          "buckets": buckets, "clip_seconds": list(clip_seconds), "startup_s": startup_s,
          "lone_request_ms": lone_ms[0], "loops": loops, "healthz": health})

    # 7d. the cascade: the 2-layer student answers, unsure rows escalate to
    # the flagship teacher; the threshold is the median of the student's
    # confidences on the same requests
    waves = [(pcm.astype(np.float32) / 32768.0, text) for pcm, text in clips[:cascade_requests]]

    def submit_all(core):
        out = [None] * len(waves)

        def run(i):
            out[i] = core.submit(*waves[i], timeout=600)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(waves))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        return time.perf_counter() - t0, out

    student_core = serving.BatchingServer(serving.ArtifactRouter(art_student, preload=True,
                                                                 device=device), tokenizer=tok)
    teacher_core = serving.BatchingServer(serving.ArtifactRouter(art, preload=True,
                                                                 device=device), tokenizer=tok)
    try:
        reset_counts()
        student_s, first = submit_all(student_core)
        threshold = float(np.median([r["confidence"] for r in first]))
        cascade = serving.CascadeServer(student_core, teacher_core,
                                        confidence_threshold=threshold)
        cascade_s, answers = submit_all(cascade)
        summary = cascade.stats_summary()
        count = counts()["residual_stack"]
    finally:
        student_core.close()
        teacher_core.close()
    batches = summary["student"]["batches"] + summary["teacher"]["batches"]
    extractor(batches, "cascade batches, student and teacher")
    if count != batches or summary["student"]["batch_errors"] or summary["teacher"]["batch_errors"]:
        raise AssertionError(f"serve cascade: {count} launches in {batches} batches: {summary}")
    a1 += count
    emit({"phase": "path", "path": "serve: cascade (2-layer student, flagship teacher)",
          "card": smi, "requests": len(waves), "confidence_threshold": threshold,
          "escalation_rate": summary["escalation_rate"],
          "student_only_requests_per_s": len(waves) / student_s,
          "cascade_requests_per_s": len(waves) / cascade_s,
          "escalated": sum(r["escalated"] for r in answers), "launches": count,
          "stats": summary})

    # 7e. cli.infer on one of phase 5d's clips, plain and with feature-
    # averaging TTA; then the interface's ms a call after a warm call
    wav = sorted((work / "datasets" / "clips").glob("*.wav"))[-1]
    infer = {}
    iface = interface.EmotionRecognitionInterface(str(ck), device=device, tokenizer=tok)
    for tta in (False, True):
        out = work / f"infer_{'tta' if tta else 'plain'}.json"
        reset_counts()
        t0 = time.perf_counter()
        res = infer_cli.main(["--checkpoint", str(ck), "--audio", str(wav), "--text",
                              CLIP_TEXTS[1], "--export", str(out), "--device", device]
                             + (["--use_tta"] if tta else []))
        cli_s = time.perf_counter() - t0
        saved = json.loads(out.read_text())
        if saved["emotion_labels"] != res["emotion_labels"] or not np.isfinite(
                res["logits"]).all():
            raise AssertionError(f"infer tta={tta}: {saved['emotion_labels']}")
        iface.predict_emotion(str(wav), CLIP_TEXTS[1], use_tta=tta)   # warm
        times = []
        for _ in range(PREDICT_REPEATS):
            t0 = time.perf_counter()
            iface.predict_emotion(str(wav), CLIP_TEXTS[1], use_tta=tta)
            times.append(time.perf_counter() - t0)
        count = counts()["residual_stack"]
        extractor(PREDICT_REPEATS + 2, f"infer tta={tta}")
        if count != PREDICT_REPEATS + 2:
            raise AssertionError(f"infer tta={tta}: {count} launches in the CLI's call and "
                                 f"{PREDICT_REPEATS + 1} interface calls")
        a1 += count
        infer["tta" if tta else "plain"] = {
            "cli_s": cli_s, "ms": 1e3 * float(np.median(times)),
            "ms_all": [1e3 * x for x in times], "emotion": res["emotion_labels"][0],
            "confidence": float(res["confidence"][0]), "export_bytes": out.stat().st_size}
    emit({"phase": "path", "path": "infer CLI and interface", "card": smi,
          "clip_seconds": iface.preprocess_audio(str(wav)).size / SAMPLE_RATE,
          "infer": infer})
    del iface

    # 7f. the staged pipeline on a long clip, the stream in chunks, the
    # integration check
    icfg = Config(model=cfg)
    long_clip = speech_like(1, int(long_clip_seconds * SAMPLE_RATE), seed=9)[0]
    pipe = integration.DataFlowPipeline(params, icfg, tokenizer=tok)
    reset_counts()
    pipe.process_audio_segment(long_clip[:int(segment_seconds * SAMPLE_RATE)],
                               CLIP_TEXTS[0])   # warm
    t0 = time.perf_counter()
    outs = pipe.process_long_audio(long_clip, CLIP_TEXTS[0], segment_seconds=segment_seconds)
    pipe_s = time.perf_counter() - t0
    count = counts()["residual_stack"]
    extractor(len(outs) + 1, "pipeline segments")
    if count != len(outs) + 1 or not all(np.isfinite(o["logits"]).all() for o in outs):
        raise AssertionError(f"pipeline: {count} launches in {len(outs)} + 1 segments")
    a1 += count
    stages = {}
    for o in outs:
        for m in o["stage_metrics"]:
            stages.setdefault(m.stage_name, []).append(1e3 * m.processing_time)
    rec = integration.StreamingRecognizer(params, icfg, tokenizer=tok,
                                          segment_seconds=segment_seconds)
    chunk = int(STREAM_CHUNK_SECONDS * SAMPLE_RATE)
    reset_counts()
    t0 = time.perf_counter()
    results, push_ms = [], []
    for start in range(0, long_clip.size, chunk):
        t1 = time.perf_counter()
        done = rec.push_audio(long_clip[start:start + chunk], CLIP_TEXTS[0])
        if done:
            push_ms.append(1e3 * (time.perf_counter() - t1))
        results += done
    tail = rec.flush(CLIP_TEXTS[0])
    stream_s = time.perf_counter() - t0
    results += [tail] if tail is not None else []
    count = counts()["residual_stack"]
    extractor(len(results), "stream segments")
    if count != len(results) or not all(np.isfinite(r["smoothed_logits"]).all()
                                        for r in results):
        raise AssertionError(f"stream: {count} launches in {len(results)} segments")
    a1 += count
    checks = integration.verify_integration(params, icfg)
    if not checks["all_passed"]:
        raise AssertionError(f"verify_integration: {checks}")
    emit({"phase": "path", "path": "integration: pipeline, stream, verify", "card": smi,
          "clip_seconds": long_clip_seconds, "segments": len(outs), "pipeline_s": pipe_s,
          "stage_ms_mean": {k: float(np.mean(v)) for k, v in stages.items()},
          "stream_segments": len(results), "stream_s": stream_s,
          "stream_segment_ms": push_ms,
          "speaker_changed": [r["speaker_changed"] for r in results],
          "verify_integration": checks,
          "max_memory_allocated": torch.cuda.max_memory_allocated() if cuda else None})
    del params, pipe, rec
    if cuda:
        torch.cuda.empty_cache()
    return a1


def large_config(preset: str, **audio):
    """The flagship config (XLM-R-base, the 35-layer head, bf16) with a
    large audio preset, its fields replaced by `audio`."""
    import dataclasses
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
        AUDIO_BACKBONE_PRESETS, ModelConfig)
    return ModelConfig(compute_dtype="bfloat16", audio=dataclasses.replace(
        AUDIO_BACKBONE_PRESETS[preset](), **audio))


def large_backbone_phases(torch, smi: str, work: Path, manifest: str) -> dict:
    """Phase 8 (see the module docstring). Returns each kernel's launches on
    the paths it drives, and A4's layer-norm route timed as a kernel."""
    import dataclasses
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli import (
        eval as eval_cli, import_checkpoint)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
        TrainConfig, XLMRConfig, config_from_json)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        layers, model as mdl, ref_convert, wav2vec2 as w2v)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
        conv_tail as ct)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        checkpoint as ckpt, optimizer as opt_lib, train_step as ts)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        tree_to)
    t_start = time.perf_counter()
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    bf16 = torch.bfloat16

    # 8a. card against CPU at full width, both encoders cut to 2 layers
    rows = agree_rows(seed=8)
    for preset in LARGE_PRESETS:
        cfg = dataclasses.replace(large_config(preset, num_hidden_layers=LARGE_AGREE_LAYERS),
                                  text=XLMRConfig(num_hidden_layers=LARGE_AGREE_LAYERS))
        cpu_params = mdl.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
        for dtype, tol in AGREE_TOL.items():
            diffs = card_against_cpu(torch, mdl, dataclasses.replace(cfg, compute_dtype=dtype),
                                     rows, tol, cpu_params=cpu_params)
            emit({"phase": "agree", "preset": preset, "layers": LARGE_AGREE_LAYERS,
                  "dtype": dtype, "tol": tol, "B": AGREE_B, "seconds": 1.0,
                  "max_abs_diff": diffs})
        del cpu_params

    # 8c's kernel half: A4's layer-norm route at [32, 12799, 512] bf16,
    # with conv biases (wav2vec2-large) and without (WavLM-Large)
    C = 512
    T1 = (CLIP_SAMPLES - 10) // 5 + 1
    ln_route = {"max_abs_err": {}}
    for label, bias in (("bias", True), ("no bias", False)):
        convs, x1 = conv_tail_inputs(torch, LARGE_TAIL_B, T1, C, bf16, has_ln=True, seed=32,
                                     bias=bias)
        got = ct.conv_tail(convs, x1, has_ln=True)
        want = ct.conv_tail_plain(convs, x1, has_ln=True)
        torch.cuda.synchronize()
        ln_route["max_abs_err"][label] = check_close(f"conv_tail LN route {label}", got, want,
                                                     BF16_TOL["conv_tail"])
        del got, want
        if not bias:
            continue
        x_cf = x1.transpose(1, 2).contiguous()

        def cudnn_path():
            x = x_cf
            for conv in convs[1:]:
                x = layers.gelu(w2v.channel_layer_norm(conv["ln"], layers.conv1d(conv, x, 2),
                                                      1e-5))
            return x

        (bound_ms, bound_by), flops = conv_tail_bound(LARGE_TAIL_B, T1, C, bf16)
        # the LN's scale and shift, f32, read once besides
        ln_bytes = len(ct.TAIL_KERNELS) * 2 * C * 4
        bound_ms = max(bound_ms, 1e3 * ln_bytes / H100_BYTES_PER_S)
        ms = cuda_ms(lambda: ct.conv_tail(convs, x1, has_ln=True), 10, warmup=1)
        ln_route.update({
            "B": LARGE_TAIL_B, "T1": T1, "C": C, "ms": ms, "tflop_per_s": flops / ms / 1e9,
            "plain_ms": cuda_ms(lambda: ct.conv_tail_plain(convs, x1, has_ln=True), 3,
                                warmup=1),
            "cudnn_path_ms": cuda_ms(cudnn_path, 10, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "ms_over_bound": ms / bound_ms})
        del convs, x1, x_cf
    emit({"phase": "kernel", "name": "conv_tail", "route": "layer norm", "card": smi,
          "tol": BF16_TOL["conv_tail"], **ln_route})
    torch.cuda.empty_cache()

    # the base preset first, at the same shapes, for comparison
    for preset in ("wav2vec2-base",) + LARGE_PRESETS:
        cfg = large_config(preset)
        params = mdl.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        # 8b. model_forward, 4 s clips, 32 tokens, the DSP on worst-case audio
        for B, requests in LARGE_BATCHES:
            batch = example_batch(B, T=CLIP_SAMPLES, S=TEXT_TOKENS, vocab=cfg.text.vocab_size)
            del batch["quality_feats"], batch["cond_feats"]
            batch["audio"] = worst_case_dsp_audio(B, CLIP_SAMPLES, seed=B)
            batch["audio_mask"] = np.ones_like(batch["audio"])
            batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
            mdl.model_forward(params, cfg, batch).logits.cpu()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            times = []
            for _ in range(requests):
                t0 = time.perf_counter()
                out = mdl.model_forward(params, cfg, batch)
                logits = out.logits.cpu()
                times.append(time.perf_counter() - t0)
            count = counts()
            if count["residual_stack"] != requests:
                raise AssertionError(f"{preset} B={B}: residual_stack launched "
                                     f"{count['residual_stack']} times in {requests} forwards")
            launches["residual_stack"] += count["residual_stack"]
            # the large presets' layer-norm extractor keeps the unfused path;
            # their positional conv (Cg = 64) takes F2
            expect_extractor(count, requests if preset == "wav2vec2-base" else 0,
                             f"{preset} B={B}", pos_conv=requests)
            if tuple(logits.shape) != (B, cfg.num_labels):
                raise AssertionError(f"{preset} B={B}: logits {tuple(logits.shape)}")
            for field, v in zip(out._fields, out):
                if not torch.isfinite(v.float()).all():
                    raise AssertionError(f"{preset} B={B}: {field} is not finite")
            ms = 1e3 * sorted(times)[len(times) // 2]
            emit({"phase": "path", "path": "model_forward by audio backbone, DSP on "
                  "worst-case audio", "preset": preset,
                  "same_config": ["hubert-large"] if preset == "wav2vec2-large" else [],
                  "B": B, "seconds": 4.0, "text_tokens": TEXT_TOKENS, "card": smi,
                  "requests": requests, "ms": ms, "ms_all": [1e3 * t for t in times],
                  "utt_per_s": B / (ms / 1e3),
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "launches": count})
            del batch, out
        if preset == "wav2vec2-base":
            del params
            continue

        # 8c. feature_encoder(allow_fused=True): the layer-norm route on the
        # path, against the unfused layer-norm extractor
        w2v_params = mdl.cast_floating(params["audio_backbone"], bf16)
        for B, calls in ((4, 5), (32, 3)):
            record = fused_extractor_path(torch, w2v_params, cfg.audio, B, calls,
                                          vocab=cfg.text.vocab_size)
            launches["conv_tail"] += record["launches"]["conv_tail"]
            emit({"phase": "path", "path": "feature_encoder(allow_fused=True), layer norm",
                  "preset": preset, "conv_bias": cfg.audio.conv_bias, "B": B, "seconds": 4.0,
                  "card": smi, **record})
        del w2v_params
        torch.cuda.empty_cache()
        if preset != "wavlm-large":
            del params
            torch.cuda.empty_cache()
            continue

        # 8d. one frozen train step at B=16 (augmentation in the step, zero
        # front-end features), timed after a first step
        heads = cloned({k: params[k] for k in ("cross", "classifier")})
        frozen = cloned(params["audio_backbone"])
        opt = opt_lib.make_train_optimizer(params, lr=1e-4, total_steps=100)
        state = opt.init(params)
        step = ts.make_train_step(cfg, TrainConfig(batch_size=TRAIN_B, augment=True), opt)
        host = example_batch(TRAIN_B, T=CLIP_SAMPLES, S=TEXT_TOKENS, vocab=cfg.text.vocab_size)
        host["labels"] = np.arange(TRAIN_B, dtype=np.int32) % cfg.num_labels
        batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
        step(params, state, batch, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(LARGE_TRAIN_STEPS):
            t0 = time.perf_counter()
            metrics = step(params, state, batch, 1 + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        changed = sum(not torch.equal(t, dict(tree_leaves(params))[p])
                      for p, t in tree_leaves(heads))
        same = all(torch.equal(t, dict(tree_leaves(params["audio_backbone"]))[p])
                   for p, t in tree_leaves(frozen))
        if not np.isfinite(float(metrics.loss)) or not changed or not same:
            raise AssertionError(f"{preset} train step: loss {float(metrics.loss)}, {changed} "
                                 f"head leaves changed, backbone unchanged {same}")
        emit({"phase": "path", "path": "train step, frozen backbones, large backbone",
              "preset": preset, "card": smi, "B": TRAIN_B, "seconds": 4.0,
              "text_tokens": TEXT_TOKENS, "augment": True, "steps": LARGE_TRAIN_STEPS,
              "step_ms": 1e3 * sorted(times)[len(times) // 2],
              "step_ms_all": [1e3 * t for t in times],
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "loss": float(metrics.loss), "head_leaves_changed": changed,
              "backbone_bitwise_unchanged": same})
        del heads, frozen, opt, state, step, batch
        torch.cuda.empty_cache()

        # 8e. migration: the port writes the model as a reference .pt (the
        # positional conv as a plain weight, so that the round trip is
        # exact), its import CLI reads it back, its eval CLI scores phase
        # 5d's manifest with the import
        t0 = time.perf_counter()
        ref_path, imported = work / "large_reference.pt", work / "large_imported"
        sds = ref_convert.reference_state_dicts_from_params(params, cfg, pos_conv_style="plain")
        sds.update(epoch=3, f1=0.5, optimizer={"state": {}, "param_groups": []}, scheduler={})
        torch.save(sds, ref_path)
        del sds
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        report = import_checkpoint.main(["--reference_checkpoint", str(ref_path),
                                         "--out", str(imported)])
        import_s = time.perf_counter() - t0
        imported_cfg = config_from_json(ckpt.load_config_json(imported)).model
        if imported_cfg != cfg:
            raise AssertionError(f"import inferred {imported_cfg.audio}, not {cfg.audio}")
        got_params, _ = ckpt.restore_checkpoint(imported, device="cuda")
        differ = [p for p, t in tree_leaves(params)
                  if not p.startswith("asr_proj") and not torch.equal(
                      dict(tree_leaves(got_params))[p], t)]
        if differ or report["left_at_init"] != ["asr_proj"]:
            raise AssertionError(f"import: {len(differ)} leaves differ ({differ[:3]}), left at "
                                 f"init {report['left_at_init']}")
        batch = example_batch(4, T=CLIP_SAMPLES, S=TEXT_TOKENS, vocab=cfg.text.vocab_size)
        want = mdl.model_forward(params, cfg, batch).logits.cpu()
        got = mdl.model_forward(got_params, imported_cfg, batch).logits.cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"import: logits differ by {float((got - want).abs().max())}")
        del got_params, params
        torch.cuda.empty_cache()
        reset_counts()
        t0 = time.perf_counter()
        res = eval_cli.main(["--manifest", manifest, "--checkpoint", str(imported),
                             "--batch_size", "8", "--dataset_root", str(work / "datasets")])
        eval_s = time.perf_counter() - t0
        count = counts()
        if res["logits"].shape != (MANIFEST_CLIPS, cfg.num_labels) or not np.isfinite(
                res["logits"]).all() or count["residual_stack"] != len(res["step_seconds"]):
            raise AssertionError(f"eval CLI on the import: logits {res['logits'].shape}, "
                                 f"launches {count} in {len(res['step_seconds'])} steps")
        launches["residual_stack"] += count["residual_stack"]
        emit({"phase": "path", "path": "migration: reference .pt -> import CLI -> eval CLI",
              "preset": preset, "card": smi, "reference_pt_bytes": ref_path.stat().st_size,
              "write_s": write_s, "import_cli_s": import_s, "eval_cli_s": eval_s,
              "inferred": {"do_stable_layer_norm": imported_cfg.audio.do_stable_layer_norm,
                           "gated_relpos_bias": imported_cfg.audio.gated_relpos_bias,
                           "heads": imported_cfg.audio.num_attention_heads},
              "tree_exact": True, "logits_exact": True, "report": report,
              "eval_clips_per_s": MANIFEST_CLIPS / res["pass_seconds"], "launches": count})
        ref_path.unlink()
        shutil.rmtree(imported)
    emit({"phase": "path", "path": "large backbones (phase 8)",
          "seconds": time.perf_counter() - t_start})
    return {"launches": launches, "ln_route": ln_route}


def fused_extractor_path(torch, w2v_params: dict, audio_cfg, B: int, calls: int,
                         vocab: int) -> dict:
    """`feature_encoder(allow_fused=True)` `calls` times on B 4 s clips in
    bf16, with the launch counters set to 0 just before: one conv_tail
    launch a call (and in group mode one conv_front launch), the unfused
    extractor's frame mask and, within BF16_TOL["conv_tail"], its
    features; the fused and unfused ms and the transpose of conv 0's
    output that the layer-norm route adds."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        wav2vec2 as w2v)
    bf16 = torch.bfloat16
    batch = example_batch(B, T=CLIP_SAMPLES, S=TEXT_TOKENS, vocab=vocab)
    mask = torch.from_numpy(batch["audio_mask"]).cuda()
    wave = w2v.normalize_waveform(torch.from_numpy(batch["audio"]).cuda(), mask).to(bf16)
    with unfused_extractor(w2v):
        unfused, unfused_m = w2v.feature_encoder(w2v_params, audio_cfg, wave, mask)
        unfused_ms = cuda_ms(lambda: w2v.feature_encoder(w2v_params, audio_cfg, wave, mask),
                             calls, warmup=1)
    torch.cuda.synchronize()
    reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        feats, frame_mask = w2v.feature_encoder(w2v_params, audio_cfg, wave, mask,
                                                allow_fused=True)
    end.record()
    torch.cuda.synchronize()
    count = counts()
    what = f"feature_encoder ({audio_cfg.feat_extract_norm} norm) B={B}"
    fronts = calls if audio_cfg.feat_extract_norm == "group" else 0
    if count["conv_tail"] != calls or count["conv_front"] != fronts:
        raise AssertionError(f"{what}: conv_tail launched {count['conv_tail']} and "
                             f"conv_front {count['conv_front']} times in {calls} calls")
    T7 = audio_cfg.feat_extract_output_lengths(CLIP_SAMPLES)
    if tuple(feats.shape) != (B, T7, audio_cfg.conv_dim[-1]) or feats.dtype != bf16:
        raise AssertionError(f"{what}: {tuple(feats.shape)} {feats.dtype}")
    if not torch.isfinite(feats.float()).all():
        raise AssertionError(f"{what}: features not finite")
    if not torch.equal(frame_mask, unfused_m):
        raise AssertionError(f"{what}: frame masks differ")
    err = check_close(f"{what}: fused vs unfused", feats, unfused, BF16_TOL["conv_tail"])
    T1 = (CLIP_SAMPLES - audio_cfg.conv_kernel[0]) // audio_cfg.conv_stride[0] + 1
    x0 = torch.empty(B, audio_cfg.conv_dim[0], T1, dtype=bf16, device="cuda")
    return {"calls": calls, "launches": count, "max_abs_diff_vs_unfused": err,
            "tol": BF16_TOL["conv_tail"],
            "unfused_range": [float(unfused.min()), float(unfused.max())],
            "fused_ms": start.elapsed_time(end) / calls, "unfused_ms": unfused_ms,
            "transpose_ms": cuda_ms(lambda: x0.transpose(1, 2).contiguous(), 10)}


def tree_bytes(tree) -> int:
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        leaves_with_paths)
    return sum(leaf.numel() * leaf.element_size() for _, leaf in leaves_with_paths(tree))


def int8_asr_phases(torch, smi: str, cfg, work: Path, manifest: str) -> int:
    """Phase 9 (see the module docstring) on phase 5d's checkpoint and
    manifest (`work/checkpoint`, `cfg`'s model). Returns A1's launches on
    the paths it drives."""
    import dataclasses

    import torch.nn.functional as F
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli import (
        eval as eval_cli, export as export_cli, infer as infer_cli)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
        config_from_json)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
        audio_io, tokenizer)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.export import (
        OUTPUTS, ServingModel)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.frontend import asr
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as mdl, whisper as tw)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import quant
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        checkpoint as ckpt)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        leaves_with_paths, tree_to)
    t_start = time.perf_counter()
    bf16 = torch.bfloat16
    a1 = 0

    # 9a. the int8 product: torch._int_mm (rows padded under 17) against
    # the plain int32 matmul on the CPU, bitwise on the same int8 inputs;
    # the whole int8 linear (bf16 in and out) card against CPU; times
    # beside the bf16 product at the same shape
    g = torch.Generator().manual_seed(9)
    products = {}
    for M, I, O in INT8_SHAPES:
        xq = torch.randint(-127, 128, (M, I), generator=g, dtype=torch.int8)
        kq = quant.card_layout(torch.randint(-127, 128, (I, O), generator=g, dtype=torch.int8))
        xq_d, kq_d = xq.cuda(), kq.cuda()
        if not torch.equal(quant.int8_matmul(xq_d, kq_d).cpu(), quant.int8_matmul_plain(xq, kq)):
            raise AssertionError(f"int8 product [{M}, {I}] x [{I}, {O}]: the card's int32 "
                                 "product is not the plain one")
        p = quant.quantize_linear({"kernel": 0.02 * torch.randn(I, O, generator=g),
                                   "bias": 0.02 * torch.randn(O, generator=g)})
        x = torch.randn(M, I, generator=g).to(bf16)
        p_d, x_d = tree_to(p, "cuda"), x.cuda()
        lin_err = float((quant.linear_int8(p_d, x_d).cpu().float()
                         - quant.linear_int8(p, x).float()).abs().max())
        if lin_err != 0.0:
            raise AssertionError(f"linear_int8 [{M}, {I}] x [{I}, {O}] bf16: card off the CPU "
                                 f"by {lin_err}")
        kb, bias = torch.randn(I, O, device="cuda", dtype=bf16), p_d["bias"].to(bf16)
        bound_ms, bound_by = bound(M * I + I * O + 4 * M * O, 2 * M * I * O / H100_INT8_OPS)
        products[f"{M}x{I}x{O}"] = {
            "rows": M, "I": I, "O": O, "int32_bitwise_equal": True,
            "linear_int8_max_abs_err": lin_err,
            "int_mm_ms": cuda_ms(lambda: torch._int_mm(xq_d, kq_d), 20),
            "bf16_matmul_ms": cuda_ms(lambda: torch.matmul(x_d, kb), 20),
            "linear_int8_ms": cuda_ms(lambda: quant.linear_int8(p_d, x_d), 20),
            "linear_bf16_ms": cuda_ms(lambda: torch.matmul(x_d, kb) + bias, 20),
            "int_mm_bound_ms": bound_ms, "int_mm_bound_by": bound_by}
    emit({"phase": "library", "name": "int8 product (torch._int_mm, ops/quant.py)",
          "card": smi, "shapes": products})

    # 9b. first the flagship cut to 2 layers at full width, its backbones
    # quantised, on the card against the CPU from the same parameters (the
    # int8 products exact on both sides, bf16 rounding elsewhere)
    small = dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, num_hidden_layers=INT8_AGREE_LAYERS),
        text=dataclasses.replace(cfg.text, num_hidden_layers=INT8_AGREE_LAYERS))
    cpu_q = quant.quantize_backbones(mdl.init_model(small, torch.Generator().manual_seed(3),
                                                    "cpu"))
    diffs = card_against_cpu(torch, mdl, small, agree_rows(seed=9), AGREE_TOL["bfloat16"],
                             cpu_params=cpu_q)
    emit({"phase": "agree", "path": "model_forward, int8 backbones",
          "layers": INT8_AGREE_LAYERS, "dtype": small.compute_dtype,
          "tol": AGREE_TOL["bfloat16"], "B": AGREE_B, "seconds": 1.0, "max_abs_diff": diffs})
    del cpu_q

    # then the flagship eval forward with quantize_backbones beside the bf16
    # one, the DSP on worst-case audio: one A1 launch and one int8 product
    # per quantised layer linear a forward
    params = mdl.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    qparams = quant.quantize_backbones(params)
    per_forward = sum(leaf.shape[0] for path, leaf in leaves_with_paths(qparams)
                      if path.endswith("kernel_q"))
    layers_bytes = {name: tree_bytes({k: p[k]["layers"] for k in ("audio_backbone",
                                                                   "text_backbone")})
                    for name, p in (("float32", params), ("int8", qparams))}
    for B, requests in INT8_BATCHES:
        batch = example_batch(B, T=CLIP_SAMPLES, S=TEXT_TOKENS, vocab=cfg.text.vocab_size)
        del batch["quality_feats"], batch["cond_feats"]
        batch["audio"] = worst_case_dsp_audio(B, CLIP_SAMPLES, seed=B)
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        row, logits = {}, {}
        for name, p in (("bf16", params), ("int8", qparams)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            times = []
            for _ in range(requests):
                t0 = time.perf_counter()
                logits[name] = mdl.model_forward(p, cfg, batch).logits.float().cpu()
                times.append(time.perf_counter() - t0)
            count = counts()
            int8_count = count["int8_matmul"]
            if count["residual_stack"] != requests:
                raise AssertionError(f"{name} forward B={B}: residual_stack launched "
                                     f"{count['residual_stack']} times in {requests} forwards")
            expect_extractor(count, requests, f"{name} forward B={B}")   # convs stay float
            if int8_count != (requests * per_forward if name == "int8" else 0):
                raise AssertionError(f"{name} forward B={B}: {int8_count} int8 products in "
                                     f"{requests} forwards of {per_forward}")
            a1 += requests
            warm = sorted(times[1:])
            ms = 1e3 * warm[len(warm) // 2]
            row[name] = {"first_ms": 1e3 * times[0], "ms": ms, "utt_per_s": B / (ms / 1e3),
                         "max_memory_allocated": torch.cuda.max_memory_allocated(),
                         "launches": count, "int8_products": int8_count}
        ref = logits["bf16"]
        rel = float((logits["int8"] - ref).abs().mean() / (ref.abs().mean() + 1e-6))
        if not torch.isfinite(logits["int8"]).all() or rel >= INT8_CRITERION:
            raise AssertionError(f"int8 forward B={B}: mean |int8 - bf16| / mean |bf16| {rel} "
                                 f"(criterion {INT8_CRITERION})")
        emit({"phase": "path", "path": "model_forward, int8 backbones beside bf16, DSP on "
              "worst-case audio", "B": B, "seconds": CLIP_SAMPLES / SAMPLE_RATE,
              "text_tokens": TEXT_TOKENS, "card": smi, "requests": requests, **row,
              "int8_vs_bf16": rel, "criterion": INT8_CRITERION,
              "int8_products_per_forward": per_forward,
              "backbone_layer_bytes": layers_bytes})
    del params, qparams

    # 9c. the export CLI --int8 on phase 5d's checkpoint (one bucket, the
    # features precomputed), the program against the eager int8 forward;
    # the eval CLI --int8 on phase 5d's manifest, the infer CLI --int8 on a clip
    ck = work / "checkpoint"
    mcfg = config_from_json(ckpt.load_config_json(ck)).model
    art = work / "int8_export"
    t0 = time.perf_counter()
    export_cli.main(["--checkpoint", str(ck), "--out_dir", str(art), "--buckets", INT8_BUCKET,
                     "--int8", "--no_dsp", "--text_tokens", str(TEXT_TOKENS)])
    export_s = time.perf_counter() - t0
    seconds, size = (float(INT8_BUCKET.split(":")[0]), int(INT8_BUCKET.split(":")[1]))
    served = ServingModel(art / f"b{seconds:g}s_bs{size}", device="cuda")
    batch = example_batch(size, T=int(seconds * SAMPLE_RATE), S=TEXT_TOKENS,
                          vocab=mcfg.text.vocab_size, seed=5)
    reset_counts()
    served.predict(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = served.predict(batch)
    predict_ms = 1e3 * (time.perf_counter() - t0)
    qparams = quant.quantize_backbones(ckpt.restore_checkpoint(ck, device="cuda")[0])
    with torch.inference_mode():
        eager = mdl.model_forward(qparams, mcfg, {k: torch.from_numpy(v).cuda()
                                                  for k, v in batch.items()},
                                  use_openmax=True)
    count = counts()
    if count["residual_stack"] != 3:
        raise AssertionError(f"int8 artifact: residual_stack launched {count['residual_stack']} "
                             "times in 2 predicts and an eager forward")
    a1 += 3
    export_err = {name: check_close(f"int8 artifact {name}", torch.from_numpy(got[name]),
                                    want.float().cpu(), AGREE_TOL["bfloat16"])
                  for name, want in zip(OUTPUTS, (eager.logits, eager.uncertainty,
                                                  eager.features))}
    del qparams, served
    reset_counts()
    t0 = time.perf_counter()
    res = eval_cli.main(["--manifest", manifest, "--checkpoint", str(ck), "--int8",
                         "--batch_size", "8"])
    eval_s = time.perf_counter() - t0
    steps = len(res["step_seconds"]) + len(res["calibration_step_seconds"])
    count = counts()
    if count["residual_stack"] != steps or not count["int8_matmul"]:
        raise AssertionError(f"eval CLI --int8: residual_stack launched "
                             f"{count['residual_stack']} times in {steps} steps, "
                             f"{count['int8_matmul']} int8 products")
    if not np.isfinite(res["logits"]).all():
        raise AssertionError("eval CLI --int8: logits not finite")
    a1 += steps
    clip = work / "datasets" / "clips" / "c000.wav"
    reset_counts()
    t0 = time.perf_counter()
    inferred = infer_cli.main(["--checkpoint", str(ck), "--audio", str(clip), "--text",
                               CLIP_TEXTS[0], "--int8"])
    infer_s = time.perf_counter() - t0
    if counts()["residual_stack"] != 1 or not np.isfinite(
            inferred["probabilities"]).all():
        raise AssertionError("infer CLI --int8: not one A1 launch or probabilities not finite")
    a1 += 1
    emit({"phase": "path", "path": "int8 serving: export CLI, exported vs eager, eval CLI, "
          "infer CLI", "card": smi, "bucket": INT8_BUCKET, "export_s": export_s,
          "artifact_bytes": artifact_bytes(art), "predict_ms": predict_ms,
          "exported_vs_eager": export_err, "tol": AGREE_TOL["bfloat16"],
          "eval_cli_s": eval_s, "eval_steps": steps, "eval_clips_per_s":
          len(res["logits"]) / res["pass_seconds"], "infer_cli_s": infer_s})

    # 9d. whisper-base: card against CPU at 2 layers in f32 (tokens equal),
    # then full depth in bf16: log-mel, encode and the 48-token greedy
    # decode timed apart
    def transcribe_timed(p, wcfg, B, seed):
        wave = torch.from_numpy(speech_like(B, int(ASR_CLIP_SECONDS * SAMPLE_RATE), seed))
        wave = F.pad(wave, (0, 30 * SAMPLE_RATE - wave.shape[1])).cuda()
        prefix = torch.full((B, 1), wcfg.decoder_start_token_id, dtype=torch.int32,
                            device="cuda")
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            mel = tw.log_mel_spectrogram(wave, n_mels=wcfg.num_mel_bins)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            enc = tw.encode(p, wcfg, mel)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            toks, confs = tw.greedy_decode(p, wcfg, enc, prefix, max_new_tokens=ASR_NEW_TOKENS)
            toks, confs = toks.cpu(), confs.cpu()
            t3 = time.perf_counter()
            runs.append({"mel_ms": 1e3 * (t1 - t0), "encode_ms": 1e3 * (t2 - t1),
                         "decode_ms": 1e3 * (t3 - t2),
                         "tokens_per_s": B * ASR_NEW_TOKENS / (t3 - t2),
                         "max_memory_allocated": torch.cuda.max_memory_allocated()})
        if tuple(toks.shape) != (B, ASR_NEW_TOKENS) or not (
                torch.isfinite(confs).all() and (confs > 0).all() and (confs <= 1).all()):
            raise AssertionError(f"decode B={B}: tokens {tuple(toks.shape)} or confidences "
                                 "out of (0, 1]")
        return {"B": B, "first": runs[0], **runs[1]}

    base_cfg = tw.WhisperConfig(**WHISPER_PRESETS["whisper-base"])
    small = dataclasses.replace(base_cfg, encoder_layers=ASR_AGREE_LAYERS,
                                decoder_layers=ASR_AGREE_LAYERS)
    cpu_p = tw.init_whisper(small, torch.Generator().manual_seed(0), "cpu")
    cpu_p["decoder"]["embed_tokens"] *= ASR_EMBED_SCALE
    wave = torch.from_numpy(speech_like(2, int(ASR_CLIP_SECONDS * SAMPLE_RATE), seed=3))
    prefix = torch.full((2, 1), small.decoder_start_token_id, dtype=torch.int32)
    want_t, want_c = tw.transcribe_batch(cpu_p, small, wave, prefix, max_new_tokens=ASR_NEW_TOKENS)
    got_t, got_c = tw.transcribe_batch(tree_to(cpu_p, "cuda"), small, wave.cuda(),
                                       prefix.cuda(), max_new_tokens=ASR_NEW_TOKENS)
    if not torch.equal(got_t.cpu(), want_t):
        raise AssertionError("whisper-base, 2 layers: the card's tokens are not the CPU's")
    conf_err = check_close("whisper-base confidences", got_c.cpu(), want_c,
                           AGREE_TOL["float32"])
    emit({"phase": "agree", "path": "whisper-base transcribe_batch", "layers": ASR_AGREE_LAYERS,
          "dtype": "float32", "tokens_equal": True, "confidence_max_abs_err": conf_err,
          "tol": AGREE_TOL["float32"], "new_tokens": ASR_NEW_TOKENS})
    del cpu_p
    base = tw.init_whisper(base_cfg, torch.Generator(device="cuda").manual_seed(0), "cuda", bf16)
    emit({"phase": "path", "path": "whisper-base decode, bf16", "card": smi,
          "clip_seconds": ASR_CLIP_SECONDS, "new_tokens": ASR_NEW_TOKENS,
          "weight_bytes": tree_bytes(base),
          "runs": [transcribe_timed(base, base_cfg, B, seed=B)
                   for B in ASR_BATCHES["whisper-base"]]})

    # 9e. whisper-large-v3 geometry in bf16 and with quantize_whisper
    large_cfg = tw.WhisperConfig(**WHISPER_PRESETS["whisper-large-v3"])
    large = tw.init_whisper(large_cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
                            bf16)
    for name in ("bf16", "int8"):
        if name == "int8":
            large = quant.quantize_whisper(large)
        reset_counts()
        runs = [transcribe_timed(large, large_cfg, B, seed=B)
                for B in ASR_BATCHES["whisper-large-v3"]]
        products = counts()["int8_matmul"]
        if (products > 0) != (name == "int8"):
            raise AssertionError(f"whisper-large-v3 {name}: {products} int8 products")
        emit({"phase": "path", "path": f"whisper-large-v3 decode, {name}", "card": smi,
              "clip_seconds": ASR_CLIP_SECONDS, "new_tokens": ASR_NEW_TOKENS,
              "weight_bytes": tree_bytes(large),
              "layer_weight_bytes": tree_bytes({k: large[k]["layers"]
                                                for k in ("encoder", "decoder")}),
              "int8_products": products, "runs": runs})
    del large

    # 9f. EnhancedASRIntegration over TorchWhisperASR (whisper-base, bf16)
    # on one of phase 5d's clips with no text; its features through
    # model_forward with use_asr; then the eval CLI --use_asr
    backend = asr.TorchWhisperASR(base, base_cfg, max_new_tokens=ASR_NEW_TOKENS, device="cuda")
    audio = audio_io.load_audio(str(clip), sr=SAMPLE_RATE, dataset_root=None)
    text, tokens, _ = backend.transcribe(audio, SAMPLE_RATE)
    t0 = time.perf_counter()
    result = asr.EnhancedASRIntegration(backend=backend).process(audio, SAMPLE_RATE)
    process_s = time.perf_counter() - t0
    on_card = backend.params["decoder"]["embed_tokens"].is_cuda
    if not (backend.available and on_card and result.text == text and text
            and 1 <= len(tokens) <= ASR_NEW_TOKENS):
        raise AssertionError(f"TorchWhisperASR: available {backend.available}, on cuda "
                             f"{on_card}, {len(tokens)} tokens, text {text!r}")
    del base, backend
    asr_cfg = dataclasses.replace(mcfg, use_asr=True)
    params, _ = ckpt.restore_checkpoint(ck, device="cuda")
    ids, tmask = tokenizer.get_tokenizer(vocab_size=asr_cfg.text.vocab_size).encode_batch(
        [CLIP_TEXTS[0]], TEXT_TOKENS)
    batch = {"audio": audio[None], "audio_mask": np.ones((1, len(audio)), np.float32),
             "text_ids": ids, "text_mask": tmask, "asr_feats": result.asr_features[None]}
    reset_counts()
    with torch.inference_mode():
        with_asr = mdl.model_forward(params, asr_cfg, batch).logits.float().cpu()
        without = mdl.model_forward(params, mcfg, batch).logits.float().cpu()
    if counts()["residual_stack"] != 2 or not torch.isfinite(with_asr).all() \
            or torch.equal(with_asr, without):
        raise AssertionError("model_forward with use_asr: not finite, not one A1 launch a "
                             "forward, or the ASR features changed nothing")
    a1 += 2
    del params
    reset_counts()
    t0 = time.perf_counter()
    res = eval_cli.main(["--manifest", manifest, "--checkpoint", str(ck), "--use_asr",
                         "--batch_size", "8"])
    asr_eval_s = time.perf_counter() - t0
    steps = len(res["step_seconds"]) + len(res["calibration_step_seconds"])
    if counts()["residual_stack"] != steps or not np.isfinite(res["logits"]).all():
        raise AssertionError("eval CLI --use_asr: not one A1 launch a step, or logits not finite")
    a1 += steps
    emit({"phase": "path", "path": "ASR: EnhancedASRIntegration(TorchWhisperASR) -> "
          "model_forward(use_asr) -> eval CLI --use_asr", "card": smi,
          "backend_device": "cuda", "tokens": len(tokens), "text_chars": len(text),
          "process_s": process_s, "asr_features": result.asr_features.tolist(),
          "logits_shift": float((with_asr - without).abs().max()),
          "eval_cli_s": asr_eval_s, "eval_steps": steps})
    emit({"phase": "path", "path": "int8 and ASR (phase 9)",
          "seconds": time.perf_counter() - t_start, "residual_stack_launches": a1})
    return a1


def academic_card_against_cpu(torch, cfg, work: Path) -> dict:
    """10b: the battery's parts on the card against the CPU, the flagship
    cut to ACADEMIC_LAYERS encoder layers at full width from one set of CPU
    parameters: collect_logits over 8 of the clips (bf16, AGREE_TOL), noise
    at SNR on 4 s rows (VIEW_TOL), one few-shot adapt step and one distill
    step into a 'small' student cut the same way (f32, dropout out,
    TRAIN_TOL). Returns the errors."""
    import dataclasses
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
        Config, DataConfig, TrainConfig)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
        manifest as manifest_lib, pipeline, tokenizer)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
        evaluate as ev, few_shot, robustness)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as mdl)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        distill, optimizer as opt_lib)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        tree_to)
    errs = {}
    cut = dataclasses.replace(cfg, audio=dataclasses.replace(cfg.audio,
                                                             num_hidden_layers=ACADEMIC_LAYERS),
                              text=dataclasses.replace(cfg.text,
                                                       num_hidden_layers=ACADEMIC_LAYERS))
    cpu_params = mdl.init_model(cut, torch.Generator().manual_seed(3), "cpu")
    card_params = tree_to(cpu_params, "cuda")

    # the baseline pass: collect_logits over the same 8 clips (0.6-1.8 s) at
    # the CLIs' batch of 8
    rows = manifest_lib.read_manifest(work / "manifest.jsonl")[:8]
    manifest_lib.write_manifest(work / "agree.jsonl", rows)
    data = DataConfig(dataset_root=str(work / "datasets"))
    tok = tokenizer.get_tokenizer(vocab_size=cut.text.vocab_size)
    loader = pipeline.BucketedLoader(pipeline.SERDataset(str(work / "agree.jsonl"), data),
                                     batch_size=8, tokenizer=tok, shuffle=False)
    bf16_cfg = Config(model=dataclasses.replace(cut, compute_dtype="bfloat16"), data=data)
    want = ev.collect_logits(cpu_params, bf16_cfg, loader, use_openmax=True, device="cpu")
    got = ev.collect_logits(card_params, bf16_cfg, loader, use_openmax=True, device="cuda")
    if not np.array_equal(got["indices"], want["indices"]):
        raise AssertionError("collect_logits: the card and the CPU scored other rows")
    errs["collect_logits bf16"] = check_close(
        "collect_logits card vs CPU", torch.from_numpy(got["logits"]),
        torch.from_numpy(want["logits"]), AGREE_TOL["bfloat16"])

    # noise at SNR: 4 s rows, one padded; gaussian fed one draw
    rng = np.random.default_rng(10)
    wave = torch.from_numpy(speech_like(AGREE_B, CLIP_SAMPLES, seed=10))
    mask = torch.ones_like(wave)
    mask[1, CLIP_SAMPLES // 2:] = 0
    wave = wave * mask
    draw = torch.from_numpy(rng.standard_normal(tuple(wave.shape)).astype(np.float32))
    for noise_type in ("gaussian", "babble", "music"):
        for snr in (10.0, 0.0):
            w = robustness.add_noise_at_snr(wave, mask, snr, noise_type=noise_type, noise=draw)
            g = robustness.add_noise_at_snr(wave.cuda(), mask.cuda(), snr, noise_type=noise_type,
                                            noise=draw.cuda())
            errs[f"add_noise_at_snr {noise_type} {snr:g} dB"] = check_close(
                f"add_noise_at_snr {noise_type} {snr:g} dB card vs CPU", g.cpu(), w, VIEW_TOL)

    # one few-shot adapt step and one distill step, f32, dropout out: the
    # loss and its gradients, then the parameters after the step
    f32 = dataclasses.replace(dropout_free(cut), compute_dtype="float32")
    batch = {**agree_rows(seed=10), "labels": np.array([0, 1, 2, 3], np.int32),
             "example_mask": np.array([1, 1, 1, 0], np.float32)}
    opt = few_shot.make_adapt_optimizer(cpu_params, TRAIN_LR)
    runs = {}
    for dev, params in (("cpu", cpu_params), ("cuda", card_params)):
        loss, grads = loss_and_grads(
            torch, opt, params, lambda view: few_shot.adapt_loss(
                view, f32, batch, torch.Generator(device=dev)))
        runs[dev] = {"loss": loss, "grads": grads,
                     "params": few_shot.adapt(params, f32, lambda: [batch], num_epochs=1,
                                              lr=TRAIN_LR)}
    errs.update({f"few_shot adapt step {k}": v for k, v in step_card_against_cpu(
        torch, opt, opt.init(cpu_params), runs["cuda"], runs["cpu"]).items()})

    small = distill.student_model_config(f32, "small")
    student_cfg = dropout_free(dataclasses.replace(
        small, audio=dataclasses.replace(small.audio, num_hidden_layers=ACADEMIC_LAYERS),
        text=dataclasses.replace(small.text, num_hidden_layers=ACADEMIC_LAYERS)))
    dcfg = distill.DistillConfig(feature_match_weight=0.1)
    tcfg = TrainConfig(grad_clip=1.0)
    student = mdl.init_model(student_cfg, torch.Generator().manual_seed(4), "cpu")
    student["distill_proj"] = {"kernel": 0.05 * torch.randn(
        student_cfg.proj_dim, cut.proj_dim, generator=torch.Generator().manual_seed(5)),
        "bias": torch.zeros(cut.proj_dim)}
    torch_batch = {k: torch.from_numpy(v) for k, v in batch.items() if k != "example_mask"}
    opt = opt_lib.make_train_optimizer(student, lr=TRAIN_LR, total_steps=4,
                                       freeze_backbones=False, grad_clip=1.0)
    runs = {}
    for dev, teacher in (("cpu", cpu_params), ("cuda", card_params)):
        params = cloned(tree_to(student, dev))
        dev_batch = {k: v.to(dev) for k, v in torch_batch.items()}
        loss, grads = loss_and_grads(torch, opt, params, lambda view: distill.distill_loss(
            view, teacher, dev_batch, torch.Generator(device=dev), teacher_cfg=f32,
            student_cfg=student_cfg, tcfg=tcfg, dcfg=dcfg)[0])
        step = distill.make_distill_step(f32, student_cfg, tcfg, dcfg, opt, device=dev)
        metrics = step(params, teacher, opt.init(params), torch_batch, 0)
        runs[dev] = {"loss": loss, "grads": grads, "params": params, "metrics": metrics}
    for k, v in runs["cpu"]["metrics"].items():
        errs[f"distill step {k}"] = check_close(f"distill step {k} card vs CPU",
                                                runs["cuda"]["metrics"][k].cpu(), v, TRAIN_TOL)
    errs.update({f"distill step {k}": v for k, v in step_card_against_cpu(
        torch, opt, opt.init(student), runs["cuda"], runs["cpu"]).items()})
    return errs


def loss_and_grads(torch, opt, params: dict, loss_of):
    """(loss, {path: gradient}) of loss_of(view) at the optimizer's trained
    leaves of `params`, through detached aliases."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        map_leaves)
    alias = {p: t.detach().requires_grad_(True) for p, t in opt.trainable(params)}
    loss = loss_of(map_leaves(params, lambda p, t: alias.get(p, t)))
    grads = torch.autograd.grad(loss, list(alias.values()), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip(alias, grads))


def step_card_against_cpu(torch, opt, state: dict, card: dict, cpu: dict) -> dict:
    """One AdamW step of `opt` taken on the card and on the CPU from the
    same parameters and optimizer `state` (on the CPU, as it was before the
    step); `card` and `cpu` hold each device's loss, gradients
    (`loss_and_grads`) and parameters after the step. The loss and the
    gradients are held within TRAIN_TOL. Each parameter is held within
    TRAIN_TOL plus lr |u(g_card) - u(g_cpu)|, u the step's direction
    m_hat / (sqrt(v_hat) + eps) from `state`'s moments, in f64: what the
    optimizer's own arithmetic makes of the gradients' rounding. That term
    is about 2 lr where a gradient that is zero but for rounding (the
    attention key biases, which the softmax cancels) flips its sign, and
    under TRAIN_TOL where the gradients agree. Returns the errors and the
    count of elements where the term exceeds TRAIN_TOL."""
    errs = {"loss": check_close("loss card vs CPU", card["loss"].cpu(), cpu["loss"], TRAIN_TOL),
            "grads": max(check_close(f"grad {p} card vs CPU", card["grads"][p].cpu(), g,
                                     TRAIN_TOL) for p, g in cpu["grads"].items())}
    count = int(state["count"])

    def direction(grads: dict) -> dict:
        g = {p: t.detach().cpu().double() for p, t in grads.items()}
        if opt.grad_clip is not None:
            norm = torch.stack([t.square().sum() for t in g.values()]).sum().sqrt()
            g = {p: t * min(1.0, opt.grad_clip / float(norm)) for p, t in g.items()}
        out = {}
        for p, t in g.items():
            m = opt.b1 * state["mu"][p].double() + (1 - opt.b1) * t
            v = opt.b2 * state["nu"][p].double() + (1 - opt.b2) * t * t
            out[p] = (m / (1 - opt.b1 ** (count + 1))
                      / ((v / (1 - opt.b2 ** (count + 1))).sqrt() + opt.eps))
        return out

    u_card, u_cpu = direction(card["grads"]), direction(cpu["grads"])
    card_leaves = dict(tree_leaves(card["params"]))
    worst, moved, elements = 0.0, 0, 0
    for p, want in tree_leaves(cpu["params"]):
        got = card_leaves[p].cpu()
        tol = TRAIN_TOL * (1 + want.abs())
        if p in u_cpu:
            lr = float(opt.schedules[opt.labels[p]](count))
            term = lr * (u_card[p] - u_cpu[p]).abs()
            moved += int((term > TRAIN_TOL).sum())
            elements += want.numel()
            tol = tol + term.float()
        diff = (got - want).abs()
        if not bool((diff <= tol).all()):
            raise AssertionError(f"param {p} card vs CPU after the step: max |got - want| "
                                 f"{float(diff.max())} over its tolerance")
        worst = max(worst, float(diff.max()))
    errs.update({"params": worst, "trained_elements": elements,
                 "elements_rounding_moves_over_tol": moved})
    return errs


def academic_phases(torch, smi: str, cfg, work: Path) -> int:
    """Phase 10 (see the module docstring) on phase 5d's full-width
    checkpoint. Returns A1's launches on the paths it drives (the
    academic_eval CLI's eval forwards, the distill CLI's teacher forwards
    and student validation, the eval CLI's steps)."""
    import copy
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli import (
        academic_eval as academic_cli, distill as distill_cli, eval as eval_cli,
        fit_cascade as fit_cli)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import DataConfig
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
        pipeline, tokenizer)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
        evaluate as ev, few_shot)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
        residual_stack as rs)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import distill
    t_start = time.perf_counter()
    a1 = 0

    # 10a. A1 at the slice's classifier shapes against its plain version
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs, plans, timing = {}, {}, {}
    reset_counts()
    for (L, D), batches in A1_SLICE_SHAPES.items():
        for B in batches:
            stacked, x = residual_stack_inputs(torch, B, L, D, seed=B + D)
            got = rs.residual_stack(stacked, x)
            want = rs.residual_stack_plain(stacked, x)
            torch.cuda.synchronize()
            label = f"L={L} D={D} B={B}"
            errs[label] = check_close(f"residual_stack {label}", got, want, KERNEL_TOL)
            p = rs.plan(B, L, D, num_sms)
            plans[label] = {"blocks": p.blocks, "rows": p.rows, "col_width": p.col_width,
                            "col_groups": p.col_groups, "row_blocks": p.row_blocks,
                            "ring_depth": p.depth, "smem_bytes": p.smem_bytes}
            bound_ms, bound_by = residual_stack_bound(B, L, D)
            ms = cuda_ms(lambda: rs.residual_stack(stacked, x), 50)
            timing[label] = {"ms": ms,
                             "plain_ms": cuda_ms(lambda: rs.residual_stack_plain(stacked, x), 10),
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "ms_over_bound": ms / bound_ms}
    compared = counts()["residual_stack"]
    if compared < sum(map(len, A1_SLICE_SHAPES.values())):
        raise AssertionError(f"10a: residual_stack launched {compared} times")
    emit({"phase": "kernel", "name": "residual_stack", "shapes": "slice", "card": smi,
          "tol": KERNEL_TOL, "max_abs_err": errs, "plan": plans, "timing": timing})

    # 10b. card against CPU at ACADEMIC_LAYERS layers, full width
    t0 = time.perf_counter()
    agree = academic_card_against_cpu(torch, cfg, work)
    emit({"phase": "agree", "path": "academic parts and distill step",
          "layers": ACADEMIC_LAYERS, "tol": {"logits": AGREE_TOL["bfloat16"],
                                             "noise": VIEW_TOL, "train": TRAIN_TOL},
          "max_abs_diff": agree, "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    # 10c. the academic_eval CLI on 48 clips whose texts the code-mixing
    # and zero-shot tables change, on phase 5d's checkpoint
    root = work / "academic"
    manifest = write_manifest_clips(root, MANIFEST_CLIPS, seed=10, texts=ACADEMIC_TEXTS)
    datasets = str(root / "datasets")
    tok = tokenizer.get_tokenizer(vocab_size=cfg.text.vocab_size)
    ds = pipeline.SERDataset(manifest, DataConfig(dataset_root=datasets))
    steps = pipeline.BucketedLoader(ds, batch_size=8, tokenizer=tok,
                                    shuffle=False).batches_per_epoch()
    few_shot_steps = 0
    for k in (8, 16):
        _, eval_idx = few_shot.select_shots(len(ds), k)
        sub = copy.copy(ds)
        sub.items = [ds.items[i] for i in eval_idx]
        few_shot_steps += pipeline.BucketedLoader(sub, batch_size=4, tokenizer=tok,
                                                  shuffle=False).batches_per_epoch()
    # eval passes over the manifest: baseline, open set, 3 noise types x 2
    # SNRs, 2 code-mix languages x 5 ratios, 3 zero-shot languages; the
    # benchmark's 3 batch sizes x (2 + 5) calls; the few-shot evaluations
    want_a1 = (2 + 3 * 2 + 2 * 5 + 3) * steps + 3 * 7 + few_shot_steps
    out_dir = work / "academic_out"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    # every pass's rows, kept for phase 12c, and each K's adaptation steps
    with PassRows(ev) as passes, AdaptSteps(few_shot) as adapt_steps:
        res = academic_cli.main(["--checkpoint", str(work / "checkpoint"), "--manifest",
                                 manifest, "--dataset_root", datasets, "--output_dir",
                                 str(out_dir), "--batch_size", "8", *ACADEMIC_ARGS])
    academic_s = time.perf_counter() - t0
    passes.save(work / "academic_passes.npz", steps=steps, few_shot_steps=few_shot_steps)
    count = counts()
    peak = torch.cuda.max_memory_allocated()
    saved = json.loads((out_dir / "academic_evaluation.json").read_text())
    missing = [part for part in ACADEMIC_PARTS if part not in saved]
    if missing or not (out_dir / "academic_report.txt").exists():
        raise AssertionError(f"academic_eval: parts {missing} missing from its JSON")
    if count["residual_stack"] != want_a1:
        raise AssertionError(f"academic_eval: residual_stack launched {count['residual_stack']} "
                             f"times, not once in each of its {want_a1} eval forwards")
    if (res["baseline"]["num_samples"] != MANIFEST_CLIPS
            or [r["num_shots"] for r in res["few_shot"]] != [8, 16]
            or set(res["zero_shot"]["per_language"]) != {"en", "hi", "bn", "te"}):
        raise AssertionError(f"academic_eval: {res['baseline']['num_samples']} samples, shots "
                             f"{[r['num_shots'] for r in res['few_shot']]}")
    # every pass's rows finite (a partial batch's padded rows are dropped
    # before each consumer), and each K's few-shot numbers
    nonfinite = {f"pass {i}'s {k}": int((~np.isfinite(v)).sum())
                 for i, rows in enumerate(passes.passes) for k, v in rows.items()
                 if np.issubdtype(v.dtype, np.floating) and not np.isfinite(v).all()}
    shots = [{"num_shots": r["num_shots"], "f1": r["f1_score"], "accuracy": r["accuracy"],
              "recovery_rate": r["recovery_rate"], **steps_k}
             for r, steps_k in zip(res["few_shot"], adapt_steps.runs)]
    emit({"phase": "path", "path": "academic_eval CLI few-shot adaptation", "card": smi,
          "shots": shots})
    if nonfinite or not all(np.isfinite([r["f1_score"], r["accuracy"], r["recovery_rate"]]).all()
                            for r in res["few_shot"]) or len(adapt_steps.runs) != 2:
        raise AssertionError(f"academic_eval: non-finite entries {nonfinite}, few-shot {shots}")
    a1 += count["residual_stack"]
    # the few-shot adaptation trains the heads on the frozen extractor
    expect_extractor(count, count["residual_stack"] + sum(r["steps"] for r in adapt_steps.runs),
                     "academic_eval CLI")
    bench = res["inference_benchmark"]
    emit({"phase": "path", "path": "academic_eval CLI (the 8-part battery)", "card": smi,
          "clips": MANIFEST_CLIPS, "batch_size": 8, "args": " ".join(ACADEMIC_ARGS),
          "cli_s": academic_s, "part_seconds": res["part_seconds"],
          "parts": [part for part in ACADEMIC_PARTS if part in saved],
          "weighted_f1": res["baseline"]["weighted_f1"],
          "benchmark_ms": {b: e["latency_p50_ms"] for b, e in bench["per_batch_size"].items()},
          "benchmark_device_peak_bytes": {b: e.get("device_peak_bytes")
                                          for b, e in bench["per_batch_size"].items()},
          "params": bench["params"], "max_memory_allocated": peak, "launches": count,
          "eval_steps_per_pass": steps, "few_shot_eval_steps": few_shot_steps})
    del res
    torch.cuda.empty_cache()

    # 10d. distil the flagship into a 'small' student, score both, fit the
    # cascade; a CUDA event after each step that make_distill_step returns
    # (and one when it is made) times the steps without reading the card
    student_dir = work / "student"
    make_step, marks = distill.make_distill_step, []

    def mark():
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    def timed_make_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def timed_step(*step_args):
            metrics = step(*step_args)
            mark()
            return metrics

        mark()
        return timed_step

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    distill.make_distill_step = timed_make_step
    t0 = time.perf_counter()
    try:
        res = distill_cli.main(["--teacher_checkpoint", str(work / "checkpoint"),
                                "--train_manifest", manifest, "--val_manifest", manifest,
                                "--student_preset", "small", "--epochs", "1", "--batch_size",
                                "8", "--dataset_root", datasets, "--save_dir", str(student_dir)])
    finally:
        distill.make_distill_step = make_step
    distill_s = time.perf_counter() - t0
    count = counts()
    peak = torch.cuda.max_memory_allocated()
    train_steps = pipeline.BucketedLoader(ds, batch_size=8, tokenizer=tok, shuffle=True,
                                          drop_remainder=True).batches_per_epoch()
    marks[-1].synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    if len(step_ms) != train_steps or count["residual_stack"] != train_steps + steps:
        raise AssertionError(f"distill CLI: {len(step_ms)} steps, residual_stack launched "
                             f"{count['residual_stack']} times, not {train_steps} teacher "
                             f"forwards + {steps} validation steps")
    if not all(np.isfinite(v) for v in res["history"][0].values()):
        raise AssertionError(f"distill CLI: {res['history'][0]}")
    a1 += count["residual_stack"]
    expect_extractor(count, count["residual_stack"], "distill CLI, teacher and student")
    warm = sorted(step_ms[1:])
    emit({"phase": "path", "path": "distill CLI (flagship -> small, 1 epoch, batch 8)",
          "card": smi, "cli_s": distill_s, "epoch_s": res["history"][0]["epoch_seconds"],
          "step_ms": {"first": step_ms[0], "median_after_first": warm[len(warm) // 2],
                      "all": step_ms},
          "history": res["history"], "max_memory_allocated": peak, "launches": count,
          "student_classifier": {"L": 8, "D": 256}})
    best = res["best_path"]
    del res
    torch.cuda.empty_cache()

    predictions, eval_s = {}, {}
    for tier, checkpoint in (("student", best), ("teacher", str(work / "checkpoint"))):
        predictions[tier] = str(work / f"{tier}_predictions.jsonl")
        reset_counts()
        t0 = time.perf_counter()
        res = eval_cli.main(["--manifest", manifest, "--checkpoint", checkpoint,
                             "--dataset_root", datasets, "--batch_size", "8",
                             "--predictions_out", predictions[tier]])
        eval_s[tier] = time.perf_counter() - t0
        n = counts()["residual_stack"]
        expect_extractor(counts(), n, f"eval CLI on the {tier}")
        if n != len(res["step_seconds"]) or res["logits"].shape != (MANIFEST_CLIPS,
                                                                    cfg.num_labels):
            raise AssertionError(f"eval CLI on the {tier}: logits {res['logits'].shape}, "
                                 f"{n} launches in {len(res['step_seconds'])} steps")
        a1 += n
        del res
    t0 = time.perf_counter()
    fit = fit_cli.main(["--student_predictions", predictions["student"],
                        "--teacher_predictions", predictions["teacher"],
                        "--escalation_budget", str(CASCADE_BUDGET),
                        "--out", str(work / "cascade.json")])
    fit_s = time.perf_counter() - t0
    if not 0.0 <= fit["escalation_rate"] <= CASCADE_BUDGET or fit["n"] != MANIFEST_CLIPS:
        raise AssertionError(f"fit_cascade: {fit}")
    emit({"phase": "path", "path": "cascade: eval CLI on student and teacher, fit_cascade CLI",
          "card": smi, "eval_cli_s": eval_s, "fit_cascade_s": fit_s, "fit": fit})
    emit({"phase": "path", "path": "evaluation suite (phase 10)",
          "seconds": time.perf_counter() - t_start, "residual_stack_launches": a1})
    return a1


def research_card_against_cpu(torch) -> dict:
    """11a: the confidence fusion, cross-lingual and loss-integration
    functions and the legacy heads, on the card against the CPU from the
    same inputs and parameters (made on the CPU, copied), f32. The
    gradient of the cross-lingual total through gradient_reversal and the
    language head is held too. Returns the errors."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        classifier as cls, layers)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.research import (
        confidence_fusion as cf, cross_lingual as cl, loss_integration as li)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        tree_to)
    rng = np.random.default_rng(21)
    B, A, X, F = 8, 768, 768, 256
    raw = rng.random((14, B)).astype(np.float32)
    raw[0] *= 30.0
    raw[5] *= 2.5
    audio, text = (rng.standard_normal((B, n)).astype(np.float32) for n in (A, X))
    feats = rng.standard_normal((B, F)).astype(np.float32)
    emo, lang = rng.integers(0, 4, B), rng.integers(0, cl.NUM_LANGUAGES, B)
    logits = (3 * rng.standard_normal((B, 4))).astype(np.float32)
    prev = rng.standard_normal((B, 4)).astype(np.float32)
    conf = rng.random(B).astype(np.float32)
    fusion = cf.init_adaptive_fusion(A, X, device="cpu")
    head = cl.init_language_head(F, device="cpu")
    legacy = cls.init_legacy_mlp(layers.Init(None, "cpu"), F, 4, hidden=128)
    outs = {}
    for dev in ("cpu", "cuda"):
        t = lambda a: torch.from_numpy(np.array(a)).to(dev)
        cfeats = cf.ConfidenceFeatures(*(t(r) for r in raw[:7]), t(raw[7] > 0.5),
                                       t(raw[8] > 0.3), *(t(r) for r in raw[9:]))
        fused, fconf, info = cf.adaptive_fusion(tree_to(fusion, dev), t(audio), t(text), cfeats)
        f = t(feats).requires_grad_(True)
        lang_logits = cl.language_adversarial_head(tree_to(head, dev), f, alpha=0.5)
        losses = cl.cross_lingual_losses(t(logits), t(emo), lang_logits, t(lang),
                                         cl.consistency_loss(f, t(emo), t(lang)))
        (grad,) = torch.autograd.grad(losses["total_loss"], f)
        acts, leg_logits = cls.legacy_mlp_forward(tree_to(legacy, dev), t(feats))
        fit = cls.legacy_fit_weibull(acts, t(emo), 4)
        om = cls.legacy_openmax_forward({**tree_to(legacy, dev), "weibull": fit}, t(feats))
        total = li.compute_total_loss({
            "ce_loss": losses["emotion_loss"],
            "energy_margin_loss": li.energy_margin_loss(t(logits), t(conf > 0.7)),
            "temporal_consistency_loss": li.temporal_consistency_loss(
                t(logits), t(prev), t(conf), t(conf[::-1].copy())),
            "confidence_calibration_loss": li.confidence_calibration_loss(
                t(conf), t(emo == logits.argmax(-1)))}, epoch=120)
        outs[dev] = {"fused": fused, "fusion_confidence": fconf, **info,
                     "language_logits": lang_logits, "reversed_gradient": grad,
                     **{k: v for k, v in losses.items()}, "legacy_logits": leg_logits,
                     "legacy_openmax_logits": om, **{f"weibull_{k}": v for k, v in fit.items()},
                     **{f"phase_{k}": v for k, v in total.items() if k != "phase"}}
    return {k: check_close(f"11a {k} card vs CPU", v.detach().cpu(),
                           outs["cpu"][k].detach(), AGREE_TOL["float32"])
            for k, v in outs["cuda"].items()}


def parallel_phases(torch, smi: str, cfg, work: Path, manifest: str) -> int:
    """Phase 11 (see the module docstring) on phase 5d's manifest. Returns
    A1's launches on the paths it drives (the traced eval forward, the
    pod-branch train CLI's validation and Weibull passes)."""
    import os
    import torch.distributed as dist
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli import (
        train as train_cli)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
        DataConfig, TrainConfig)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
        pipeline, prefetch, tokenizer)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        layers, model as mdl, wav2vec2 as w2v)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.parallel import (
        mesh as mesh_lib, multihost as mh, pipeline as pipe, sequence as seq)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        checkpoint as ckpt, optimizer as opt_lib, train_step as ts)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import (
        debug, profiling)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
        map_leaves)
    t_start = time.perf_counter()
    dev = torch.device("cuda")

    def step_ms(fn, warmup: int, iters: int) -> list:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return times

    def median(ms: list) -> float:
        return sorted(ms)[len(ms) // 2]

    # 11a. research functions and legacy heads, card against CPU
    emit({"phase": "agree", "path": "research functions and legacy heads (phase 11a)",
          "dtype": "float32", "tol": AGREE_TOL["float32"],
          "max_abs_diff": research_card_against_cpu(torch)})

    # 11b. profiling.trace around one flagship eval forward at B=4; the
    # memory counters; debug.checked raising on a NaN fed to the card
    params = mdl.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in example_batch(
        4, T=CLIP_SAMPLES, S=TEXT_TOKENS, vocab=cfg.text.vocab_size).items()}
    with torch.inference_mode():
        mdl.model_forward(params, cfg, batch, deterministic=True)
        torch.cuda.synchronize()
        reset_counts()
        with profiling.trace(work / "trace") as prof:
            t0 = time.perf_counter()
            out = mdl.model_forward(params, cfg, batch, deterministic=True)
            profiling.sync(out.logits)
            forward_ms = 1e3 * (time.perf_counter() - t0)
    a1 = counts()["residual_stack"]
    if a1 != 1:
        raise AssertionError(f"11b: residual_stack launched {a1} times in one forward")
    trace_path = work / "trace" / profiling.TRACE_FILE
    # the kernels are the events on the card; the CPU ops' self device time
    # is their kernels' again, so they stay out of the sum (as in the
    # profiler's own table)
    from torch.autograd import DeviceType
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device_us = lambda e: e.self_device_time_total
    a1_events = [e for e in kernels if "residual_stack_kernel" in e.key]
    if not a1_events or "residual_stack_kernel" not in trace_path.read_text():
        raise AssertionError("11b: the trace does not name A1's kernel (residual_stack_kernel)")
    mem = profiling.device_memory_stats()
    allocator = torch.cuda.memory_stats()
    for key, counter in (("bytes_in_use", "allocated_bytes.all.current"),
                         ("peak_bytes_in_use", "allocated_bytes.all.peak")):
        if mem[key] != allocator[counter]:
            raise AssertionError(f"11b: {key} {mem[key]} is not the allocator's {counter} "
                                 f"{allocator[counter]}")
    if not 0 < mem["bytes_in_use"] <= mem["peak_bytes_in_use"] <= mem["bytes_limit"]:
        raise AssertionError(f"11b: memory counters out of order: {mem}")
    checked = debug.checked(lambda x: layers.linear(params["classifier"]["out_proj2"], x))
    half = params["classifier"]["out_proj2"]["kernel"].shape[0]
    bad = torch.full((2, half), float("nan"), device=dev)
    try:
        checked(bad)
        raise AssertionError("11b: debug.checked did not raise on a NaN")
    except FloatingPointError as e:
        checked_message = str(e)
    emit({"phase": "path", "path": "profiling.trace around the flagship eval forward, B=4",
          "card": smi, "trace_bytes": trace_path.stat().st_size, "forward_ms": forward_ms,
          "device_kernel_ms": sum(device_us(e) for e in kernels) / 1e3,
          "a1_kernel": [e.key for e in a1_events][:1],
          "a1_kernel_ms": sum(device_us(e) for e in a1_events) / 1e3, "launches": a1,
          "device_memory_stats": {k: mem.get(k) for k in ("bytes_in_use", "peak_bytes_in_use",
                                                          "bytes_limit")},
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "checked_raised": checked_message})
    del batch, out

    # 11c. a one-rank process group (torchrun's environment for one rank)
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if not mh.initialize():
            raise AssertionError("11c: multihost.initialize brought up no group")
        mesh = mesh_lib.make_mesh()
        backend = dist.get_backend()
        if torch.cuda.device_count() > 1:
            emit({"phase": "note", "note": f"{torch.cuda.device_count()} cards: phase 11c-d "
                  "ran with world 1 only"})

        # the flagship frozen train step, sharded (FSDP, min size 1) and not
        tcfg = TrainConfig(batch_size=TRAIN_B, augment=True)
        host = example_batch(TRAIN_B, T=CLIP_SAMPLES, S=TEXT_TOKENS, vocab=cfg.text.vocab_size)
        host["labels"] = np.arange(TRAIN_B, dtype=np.int32) % cfg.num_labels
        plain_batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        opt = opt_lib.make_train_optimizer(params, lr=1e-4, total_steps=100)
        plain_p = cloned(params)
        plain_s = opt.init(plain_p)
        sharded_p = mesh_lib.shard_params(cloned(params), mesh, fsdp=True, fsdp_min_size=1)
        sharded_s = opt.init(sharded_p)
        # the loop's route: device_prefetch puts the rows on the card, then
        # shard_batch lays them over the mesh
        (dev_batch, _), = prefetch.device_prefetch(iter([host]), dev,
                                                   skip=pipeline.TRAIN_HOST_KEYS)
        sharded_batch = mesh_lib.shard_batch(dev_batch, mesh)
        plain_step = ts.make_train_step(cfg, tcfg, opt, device=dev)
        sharded_step = ts.make_train_step(cfg, tcfg, opt, device=dev)
        m_plain = plain_step(plain_p, plain_s, plain_batch, 0)
        m_sharded = sharded_step(sharded_p, sharded_s, sharded_batch, 0)
        errs = {"loss": check_close("11c sharded step loss", m_sharded.loss.cpu(),
                                    m_plain.loss.cpu(), TRAIN_TOL)}
        got = dict(tree_leaves(mh.host_replicated(sharded_p)))
        errs["params"] = max(check_close(f"11c sharded step {p}", got[p].cpu(), t.cpu(),
                                         TRAIN_TOL) for p, t in tree_leaves(plain_p))
        # on a (1, 1) mesh a Shard placement splits nothing: the count says
        # the moments took the parameters' layout (two ranks: the CPU tests)
        moments = [m for m in sharded_s["mu"].values()
                   if any(pl.is_shard() for pl in m.placements)]
        seed = iter(range(1, 10 ** 6))
        plain_ms = step_ms(lambda: plain_step(plain_p, plain_s, plain_batch, next(seed)),
                           TRAIN_WARMUP, TRAIN_STEPS)
        sharded_ms = step_ms(lambda: sharded_step(sharded_p, sharded_s, sharded_batch,
                                                  next(seed)), TRAIN_WARMUP, TRAIN_STEPS)
        emit({"phase": "path", "path": "train step, frozen backbones, FSDP (min size 1) on a "
              "one-rank mesh vs unsharded", "card": smi, "backend": backend, "mesh": [1, 1],
              "B": TRAIN_B, "seconds": CLIP_SAMPLES / SAMPLE_RATE, "text_tokens": TEXT_TOKENS,
              "tol": TRAIN_TOL, "max_abs_diff": errs,
              "moments_with_shard_placements": len(moments),
              "plain_step_ms": median(plain_ms), "sharded_step_ms": median(sharded_ms),
              "dtensor_host_ms": median(sharded_ms) - median(plain_ms),
              "plain_step_ms_all": plain_ms, "sharded_step_ms_all": sharded_ms})
        del plain_p, plain_s, sharded_p, sharded_s, plain_batch, sharded_batch, dev_batch, opt
        del plain_step, sharded_step
        torch.cuda.empty_cache()

        # the ring and the pipeline (P=1, M=4) against the dense stack: in f32
        # at the JAX package's ring tolerance; in the compute dtype (timed),
        # each no further from the f32 dense result than twice the dense
        # stack's own rounding, plus STACK_TOL (the ring keeps its
        # probabilities in f32 where the dense stack casts them to bf16)
        acfg = cfg.audio
        dtype = getattr(torch, cfg.compute_dtype)
        rng = np.random.default_rng(31)
        S = CLIP_SAMPLES   # the feature extractor's frames (199 for 4 s at base width)
        for k, stride in zip(acfg.conv_kernel, acfg.conv_stride):
            S = (S - k) // stride + 1
        h32 = torch.from_numpy(rng.standard_normal((STACK_B, S, acfg.hidden_size))
                               .astype(np.float32)).to(dev)
        lengths = np.linspace(S, S // 3, STACK_B).astype(int)
        mask = torch.from_numpy((np.arange(S)[None, :] < lengths[:, None])
                                .astype(np.float32)).to(dev)
        valid = mask[..., None]

        def stacks(dt):
            stacked = map_leaves(params["audio_backbone"]["layers"], lambda _, t: t.to(dt))
            h = h32.to(dt)
            return {"dense": lambda: w2v._encoder_stack(stacked, acfg, h,
                                                         layers.key_mask_bias(mask)),
                    "ring": lambda: seq.encoder_stack_sequence_parallel(stacked, acfg, h, mask,
                                                                        mesh),
                    "pipeline": lambda: pipe.encoder_stack_pipeline(stacked, acfg, h, mask, mesh,
                                                                    num_microbatches=4)}

        with torch.no_grad():
            f32 = stacks(torch.float32)
            want = f32["dense"]() * valid
            f32_errs = {name: check_close(f"11c {name} stack vs dense, f32",
                                          f32[name]() * valid, want, STACK_TOL)
                        for name in ("ring", "pipeline")}
            del f32
            low = stacks(dtype)
            low_errs = {name: float((fn().float() * valid - want).abs().max())
                        for name, fn in low.items()}
            for name in ("ring", "pipeline"):
                if low_errs[name] > 2 * low_errs["dense"] + STACK_TOL:
                    raise AssertionError(f"11c {name} stack in {cfg.compute_dtype}: "
                                         f"{low_errs[name]} from the f32 result, the dense "
                                         f"stack {low_errs['dense']}")
            stack_ms = {name: median(step_ms(fn, 1, 5)) for name, fn in low.items()}
            del low
        emit({"phase": "path", "path": "ring and pipeline stacks (P=1, M=4) vs the dense "
              "stack", "card": smi, "B": STACK_B, "S": S, "E": acfg.hidden_size,
              "layers": acfg.num_hidden_layers, "f32_tol": STACK_TOL,
              "f32_max_abs_diff": f32_errs, "dtype": cfg.compute_dtype,
              "max_abs_diff_from_f32_dense": low_errs, "ms": stack_ms})
        del params, h32
        torch.cuda.empty_cache()

        # 11d. the train CLI under the pod branch (world 1) on phase 5d's clips
        save_dir = work / "pod_train"
        datasets = str(work / "datasets")
        args = ["--train_manifest", manifest, "--val_manifest", manifest, "--epochs", "1",
                "--batch_size", "8", "--use_amp", "--fsdp", "--save_dir", str(save_dir),
                "--dataset_root", datasets]
        val_steps = pipeline.BucketedLoader(
            pipeline.SERDataset(manifest, DataConfig(dataset_root=datasets)), batch_size=8,
            tokenizer=tokenizer.get_tokenizer(vocab_size=cfg.text.vocab_size),
            shuffle=False).batches_per_epoch()
        train_steps = pipeline.BucketedLoader(
            pipeline.SERDataset(manifest, DataConfig(dataset_root=datasets)), batch_size=8,
            tokenizer=tokenizer.get_tokenizer(vocab_size=cfg.text.vocab_size), shuffle=True,
            drop_remainder=True).batches_per_epoch()
        reset_counts()
        t0 = time.perf_counter()
        res = train_cli.main(args)
        cli_s = time.perf_counter() - t0
        count = counts()
        written = sorted(d.name for d in save_dir.glob("epoch_*"))
        if len(written) != 1 or not (save_dir / written[0] / ckpt.OPT_STATE_FILE).exists():
            raise AssertionError(f"11d: rank 0 wrote {written}")
        saved = json.loads((save_dir / written[0] / "config.json").read_text())
        if not saved["mesh"]["fsdp"] or count["residual_stack"] != 2 * val_steps:
            raise AssertionError(f"11d: mesh {saved['mesh']}, residual_stack launched "
                                 f"{count['residual_stack']} times, not 2 passes x "
                                 f"{val_steps} steps")
        a1 += count["residual_stack"]
        # under the pod branch the forwards take the mesh's ModelGroup: the
        # positional conv keeps the plain chain
        expect_extractor(count, count["residual_stack"] + train_steps,
                         "train CLI under the pod branch", pos_conv=0)
        emit({"phase": "path", "path": "train CLI under the pod branch (world 1, --fsdp, "
              "1 epoch, batch 8, --use_amp)", "card": smi, "backend": backend,
              "cli_s": cli_s, "epoch_s": res["history"][0]["seconds"],
              "val_f1": res["history"][0]["val_f1"], "checkpoint": written[0],
              "written_by": "rank 0", "val_steps": val_steps, "launches": count})
        del res
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    emit({"phase": "path", "path": "research, utils and parallelism (phase 11)",
          "seconds": time.perf_counter() - t_start, "residual_stack_launches": a1})
    return a1


TP_WORKERS = 2          # 12b-c: ranks on the one card
TP_B = 4                # 12a-b's eval forward
TP_FORWARDS = 5
TP_WORKER_TIMEOUT = 420
TP_ACADEMIC_OUT = "academic_group_out"


#: fields of a results JSON that 12c does not hold to one process: timings,
#: and the arg-optima of a sweep (a rounding can move an optimum to another
#: point of the curve; the curve's area is held)
UNHELD_FIELDS = ("part_seconds", "inference_benchmark", "report", "latency", "optimal")


def result_numbers(tree, prefix: str = "") -> dict:
    """Every number and string of a results JSON by path, but UNHELD_FIELDS."""
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        return {prefix: tree}
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if not any(word in str(k) for word in UNHELD_FIELDS):
            out.update(result_numbers(v, path))
    return out


#: fields binned by confidence (15 bins of 1/15): a rounding moves a clip
#: whose confidence sits on a bin's edge into the next bin, so these are
#: held to their value recomputed from the run's own gathered rows
BINNED_FIELDS = ("calibration/ece", "calibration/mce", "calibration/quality")


def calibration_of(rows: dict) -> dict:
    """The battery's calibration fields of the baseline pass's rows, as
    eval/academic.py computes them."""
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
        academic, calibration)
    logits = rows["logits"]
    m = calibration.compute_calibration_metrics(logits.argmax(axis=1), rows["labels"],
                                                academic._softmax(logits))
    return {"calibration/ece": m.ece, "calibration/mce": m.mce,
            "calibration/quality": calibration.calibration_quality(m.ece)}


def same(a, b) -> bool:
    """a == b, a NaN equal to a NaN."""
    return a == b or (isinstance(a, float) and isinstance(b, float) and a != a and b != b)


def check_results(got: dict, want: dict, got_rows: dict, tol: float):
    """A results JSON against another: the same fields; the F1s, integers
    and strings equal; BINNED_FIELDS equal to their value recomputed from
    `got_rows` (the baseline pass's gathered rows); every other number
    within tol (rtol = atol = tol). (the largest difference of those, every
    field out of bounds)."""
    got, want = result_numbers(got), result_numbers(want)
    if got.keys() != want.keys():
        return 0.0, [f"fields {sorted(got.keys() ^ want.keys())} differ"]
    own, worst, bad = calibration_of(got_rows), 0.0, []
    for path, w in want.items():
        g = got[path]
        if path in BINNED_FIELDS:
            if not same(g, own[path]):
                bad.append(f"{path} is {g}, its rows give {own[path]}")
        elif "f1" in path or not isinstance(w, float) or w != w:
            if not same(g, w):
                bad.append(f"{path} is {g}, not {w}")
        else:
            worst = max(worst, abs(g - w))
            if not abs(g - w) <= tol * (1 + abs(w)):
                bad.append(f"{path} is {g}, not {w} within {tol}")
    return worst, bad


class PassRows:
    """While entered, every eval pass's gathered host rows (the logits, the
    labels, the row indices, the SNRs), in the order the battery gathers
    them: eval/evaluate.gather_rows, which each pass calls, on one process
    too. `save` writes them as one .npz, `load` reads them back."""

    def __init__(self, ev):
        self.ev, self.passes = ev, []

    def __enter__(self):
        gather = self.gather = self.ev.gather_rows

        def kept(rows, *args, **kwargs):
            out = gather(rows, *args, **kwargs)
            self.passes.append({k: np.asarray(v) for k, v in out.items()})
            return out

        self.ev.gather_rows = kept
        return self

    def __exit__(self, *exc):
        self.ev.gather_rows = self.gather
        return False

    def save(self, path: Path, **extra) -> None:
        np.savez(path, **extra, **{f"{i}/{k}": v for i, rows in enumerate(self.passes)
                                   for k, v in rows.items()})

    @staticmethod
    def load(path: Path) -> list:
        data = np.load(path)
        passes = {}
        for key in data.files:
            if "/" in key:
                i, k = key.split("/")
                passes.setdefault(int(i), {})[k] = data[key]
        return [passes[i] for i in sorted(passes)]


class AdaptSteps:
    """While entered, each few-shot `adapt` (one a K) counts its adaptation
    steps and the padded rows (example_mask 0) its batches held, in `runs`:
    eval/few_shot.make_adapt_step, which each adapt calls once, wrapped."""

    def __init__(self, few_shot):
        self.few_shot, self.runs = few_shot, []

    def __enter__(self):
        make = self.make = self.few_shot.make_adapt_step

        def counted(*args, **kwargs):
            step, run = make(*args, **kwargs), {"steps": 0, "padded_rows": 0}
            self.runs.append(run)

            def counted_step(params, opt_state, batch, generator):
                run["steps"] += 1
                run["padded_rows"] += int((np.asarray(batch["example_mask"]) == 0).sum())
                return step(params, opt_state, batch, generator)
            return counted_step

        self.few_shot.make_adapt_step = counted
        return self

    def __exit__(self, *exc):
        self.few_shot.make_adapt_step = self.make
        return False


def check_passes(got: list, want: list, tol: float):
    """Each pass's rows against one process's, row for row: integer columns
    equal; float ones finite on both sides and within tol (rtol = atol =
    tol). (the largest difference, the non-finite entries of each column
    that has any on either side, every column out of bounds)."""
    if [sorted(p) for p in got] != [sorted(p) for p in want]:
        return 0.0, {}, [f"{len(got)} passes gathered {[sorted(p) for p in got]}, one "
                         f"process {len(want)}: {[sorted(p) for p in want]}"]
    worst, nonfinite, bad = 0.0, {}, []
    for i, (g, w) in enumerate(zip(got, want)):
        for k, wv in w.items():
            gv, where = g[k], f"pass {i}'s {k}"
            if gv.shape != wv.shape:
                bad.append(f"{where} is {gv.shape}, not {wv.shape}")
            elif not np.issubdtype(wv.dtype, np.floating):
                if not np.array_equal(gv, wv):
                    bad.append(f"{where} differs in {int((gv != wv).sum())} entries")
            else:
                odd = ~np.isfinite(gv) | ~np.isfinite(wv)
                if odd.any():
                    nonfinite[f"{i}/{k}"] = int(odd.sum())
                    continue
                diff = np.abs(gv.astype(np.float64) - wv)
                if diff.size:
                    worst = max(worst, float(diff.max()))
                    if (diff > tol * (1 + np.abs(wv))).any():
                        bad.append(f"{where}: max |got - want| {float(diff.max())} over {tol}")
    return worst, nonfinite, bad


def capture_grads(opt, into: dict):
    """opt.apply_ wrapped to keep the gradients each step hands it."""
    apply_ = opt.apply_

    def wrapped(params, grads, state, ok=None):
        into.clear()
        into.update(grads)
        return apply_(params, grads, state, ok)
    opt.apply_ = wrapped


def tp_flagship_batch(torch, cfg, B: int, labels: bool = False) -> dict:
    """example_batch without front-end features (the DSP runs), on the card."""
    host = example_batch(B, T=CLIP_SAMPLES, S=TEXT_TOKENS, vocab=cfg.text.vocab_size)
    del host["quality_feats"], host["cond_feats"]
    if labels:
        host["labels"] = np.arange(B, dtype=np.int32) % cfg.num_labels
    return {k: torch.from_numpy(v).cuda() for k, v in host.items()}


def tp_worker(rank: int, port: int, work: Path) -> int:
    """One of 12b-c's ranks: two processes of this script on the one card,
    joined by gloo. Writes rank{rank}.pt (12b) and rank{rank}_academic.json
    (12c) into `work`."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli import (
        academic_eval as academic_cli)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
        ModelConfig, TrainConfig)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
        evaluate as ev, few_shot)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as mdl)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.parallel import (
        mesh as mesh_lib, tensor)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        optimizer as opt_lib, train_step as ts)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=TP_WORKERS)
    try:
        # 12b. mesh (1, 2): the flagship forward, then a frozen f32 step
        cfg = ModelConfig(compute_dtype="bfloat16")
        params = mdl.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        mesh = mesh_lib.make_mesh(data=1, model=TP_WORKERS, device="cuda")
        sharded = mesh_lib.shard_params(params, mesh)
        del params
        view, tp = tensor.split(sharded)
        batch = tp_flagship_batch(torch, cfg, TP_B)
        with torch.inference_mode():
            mdl.model_forward(view, cfg, batch, tp=tp)
            torch.cuda.synchronize()
            reset_counts()
            times = []
            for _ in range(TP_FORWARDS):
                t0 = time.perf_counter()
                logits = mdl.model_forward(view, cfg, batch, tp=tp).logits.cpu()
                times.append(1e3 * (time.perf_counter() - t0))
        count = counts()
        forward = {"ms_all": times, "launches": count["residual_stack"], "logits": logits,
                   "extractor": count}

        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        tcfg = TrainConfig(batch_size=TRAIN_B, augment=True)
        opt = opt_lib.make_train_optimizer(sharded, lr=TRAIN_LR, total_steps=100)
        state = opt.init(sharded)
        grads = {}
        capture_grads(opt, grads)
        step = ts.make_train_step(f32, tcfg, opt, device="cuda")
        train_batch = mesh_lib.shard_batch(tp_flagship_batch(torch, cfg, TRAIN_B, True), mesh)
        metrics = step(sharded, state, train_batch, 0)
        model_dim = mesh.mesh_dim_names.index(mesh_lib.MODEL_AXIS)

        def local(tree: dict) -> dict:
            # each leaf's local part and the dimension the 'model' axis splits
            out = {}
            for path, t in tree.items():
                pl = t.placements[model_dim]
                out[path] = (t.to_local().detach().cpu(), pl.dim if pl.is_shard() else None)
            return out

        trained = dict(opt.trainable(sharded))
        result = {"forward": forward, "loss": metrics.loss.cpu(), "grads": local(grads),
                  "params": local(trained)}
        state = opt.init(sharded)
        seeds = iter(range(1, 100))
        step_times = []
        for _ in range(TRAIN_WARMUP + TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(sharded, state, train_batch, next(seeds))
            torch.cuda.synchronize()
            step_times.append(1e3 * (time.perf_counter() - t0))
        result["step_ms_all"] = step_times[TRAIN_WARMUP:]
        torch.save(result, work / f"rank{rank}.pt")
        del sharded, view, state, opt, step, train_batch, grads, trained, result
        torch.cuda.empty_cache()

        # 12c. the academic_eval CLI under the group, mesh (2, 1) from the
        # checkpoint's config; every pass's gathered rows kept
        manifest = str(work / "academic" / "manifest.jsonl")
        reset_counts()
        t0 = time.perf_counter()
        with PassRows(ev) as passes, AdaptSteps(few_shot) as adapt_steps:
            res = academic_cli.main(["--checkpoint", str(work / "checkpoint"), "--manifest",
                                     manifest, "--dataset_root",
                                     str(work / "academic" / "datasets"),
                                     "--output_dir", str(work / TP_ACADEMIC_OUT),
                                     "--batch_size", "8", *ACADEMIC_ARGS])
        seconds = time.perf_counter() - t0
        passes.save(work / f"rank{rank}_passes.npz")
        (work / f"rank{rank}_academic.json").write_text(json.dumps({
            "seconds": seconds, "launches": counts()["residual_stack"],
            "extractor": counts(), "adapt_steps": sum(r["steps"] for r in adapt_steps.runs),
            "num_samples": res["baseline"]["num_samples"],
            "results": {k: v for k, v in res.items() if k != "report"}},
            default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o)))
    finally:
        dist.destroy_process_group()
    return 0


def tensor_parallel_phases(torch, smi: str, cfg, work: Path) -> int:
    """Phase 12 (see the module docstring) on phase 10c's checkpoint, clips
    and results. Returns A1's launches on the paths it drives (12a's
    forwards, 12b's forwards on rank 0, 12c's CLI on rank 0)."""
    import dataclasses
    import os
    import torch.distributed as dist
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import TrainConfig
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        model as mdl)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.parallel import (
        mesh as mesh_lib, multihost as mh, tensor)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        optimizer as opt_lib, train_step as ts)
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    a1 = 0
    median = lambda ms: sorted(ms)[len(ms) // 2]

    # 12a. a one-rank NCCL group, mesh (1, 1): the tensor-parallel path
    # against the unsharded one, bitwise
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    params = mdl.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    try:
        if not mh.initialize():
            raise AssertionError("12a: multihost.initialize brought up no group")
        backend = dist.get_backend()
        mesh = mesh_lib.make_mesh(data=1, model=1)
        batch = tp_flagship_batch(torch, cfg, TP_B)
        sharded = mesh_lib.shard_params(cloned(params), mesh)
        reset_counts()
        with torch.inference_mode():
            plain = mdl.model_forward(params, cfg, batch).logits
            view, tp = tensor.split(sharded)
            got = mdl.model_forward(view, cfg, batch, tp=tp).logits
        forward_diff = float((got - plain).abs().max())
        if not torch.equal(got, plain):
            raise AssertionError(f"12a: the tensor-parallel forward on a (1, 1) mesh is "
                                 f"{forward_diff} off the unsharded one")
        count = counts()["residual_stack"]
        if count != 2:
            raise AssertionError(f"12a: residual_stack launched {count} times in 2 forwards")
        expect_extractor(counts(), 2, "12a: forwards on a (1, 1) mesh and unsharded",
                         pos_conv=1)   # the unsharded forward's: F2 takes no ModelGroup
        a1 += count
        tcfg = TrainConfig(batch_size=TRAIN_B, augment=True)
        opt = opt_lib.make_train_optimizer(params, lr=TRAIN_LR, total_steps=100)
        train_batch = tp_flagship_batch(torch, cfg, TRAIN_B, labels=True)
        plain_p, plain_s = params, opt.init(params)
        m_plain = ts.make_train_step(cfg, tcfg, opt, device=dev)(plain_p, plain_s,
                                                                 train_batch, 0)
        tp_s = opt.init(sharded)
        m_tp = ts.make_train_step(cfg, tcfg, opt, device=dev)(
            sharded, tp_s, mesh_lib.shard_batch(train_batch, mesh), 0)
        step_diff = {"loss": float((m_tp.loss - m_plain.loss).abs())}
        whole = dict(tree_leaves(mh.host_replicated(sharded)))
        step_diff["params"] = max(float((whole[p] - t).abs().max())
                                  for p, t in tree_leaves(plain_p))
        if not torch.equal(m_tp.loss, m_plain.loss) or step_diff["params"] != 0.0:
            raise AssertionError(f"12a: the tensor-parallel step on a (1, 1) mesh differs from "
                                 f"the unsharded one: {step_diff}")
        emit({"phase": "path", "path": "tensor-parallel code path on a one-rank mesh (1, 1) "
              "vs unsharded", "card": smi, "backend": backend, "B": TP_B, "train_B": TRAIN_B,
              "seconds": CLIP_SAMPLES / SAMPLE_RATE, "text_tokens": TEXT_TOKENS,
              "dtype": cfg.compute_dtype, "frontend_dsp": True,
              "forward_max_abs_diff": forward_diff, "step_max_abs_diff": step_diff,
              "launches": count})
        del plain, got, sharded, view, plain_p, plain_s, tp_s, whole, opt
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()

    # 12b's one-process references on the card: the same forward, and the
    # frozen step in f32 from the same parameters and optimizer state
    params = mdl.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = tp_flagship_batch(torch, cfg, TP_B)
    with torch.inference_mode():
        mdl.model_forward(params, cfg, batch)
        torch.cuda.synchronize()
        one_ms = []
        for _ in range(TP_FORWARDS):
            t0 = time.perf_counter()
            one_logits = mdl.model_forward(params, cfg, batch).logits.cpu()
            one_ms.append(1e3 * (time.perf_counter() - t0))
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    tcfg = TrainConfig(batch_size=TRAIN_B, augment=True)
    opt = opt_lib.make_train_optimizer(params, lr=TRAIN_LR, total_steps=100)
    state = opt.init(params)
    state_cpu = {"count": state["count"].cpu(),
                 "mu": {p: t.cpu() for p, t in state["mu"].items()},
                 "nu": {p: t.cpu() for p, t in state["nu"].items()}}
    grads = {}
    capture_grads(opt, grads)
    step = ts.make_train_step(f32, tcfg, opt, device=dev)
    train_batch = tp_flagship_batch(torch, cfg, TRAIN_B, labels=True)
    metrics = step(params, state, train_batch, 0)
    one = {"loss": metrics.loss.cpu(), "grads": {p: g.cpu() for p, g in grads.items()},
           "params": {p: t.detach().cpu() for p, t in opt.trainable(params)}}
    state = opt.init(params)
    seeds = iter(range(1, 100))
    one_step_ms = []
    for _ in range(TRAIN_WARMUP + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, state, train_batch, next(seeds))
        torch.cuda.synchronize()
        one_step_ms.append(1e3 * (time.perf_counter() - t0))
    one_step_ms = one_step_ms[TRAIN_WARMUP:]
    del params, state, step, train_batch, grads
    torch.cuda.empty_cache()

    # 12b-c on two ranks: two processes of this script on the one card
    port = free_port()
    logs = [open(work / f"rank{r}.log", "w") for r in range(TP_WORKERS)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--tp-worker",
                               str(r), str(port), str(work)], stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(TP_WORKERS)]
    t0 = time.perf_counter()
    try:
        codes = [p.wait(timeout=TP_WORKER_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    workers_s = time.perf_counter() - t0
    if any(codes):
        tails = {r: (work / f"rank{r}.log").read_text()[-3000:] for r in range(TP_WORKERS)}
        raise AssertionError(f"12b-c: the two ranks exited {codes}:\n" + "\n".join(
            f"--- rank {r} ---\n{t}" for r, t in tails.items()))

    # 12b. the two-rank forward and step against one process
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(TP_WORKERS)]
    forward_err = check_close("12b two-rank forward vs one process", ranks[0]["forward"]["logits"],
                              one_logits, AGREE_TOL["bfloat16"])
    if not torch.equal(ranks[0]["forward"]["logits"], ranks[1]["forward"]["logits"]):
        raise AssertionError("12b: the two ranks' logits differ")

    def whole(key: str) -> dict:
        out = {}
        for path, (t, dim) in ranks[0][key].items():
            out[path] = t if dim is None else torch.cat([r[key][path][0] for r in ranks], dim)
        return out

    tp_result = {"loss": ranks[0]["loss"], "grads": whole("grads"), "params": whole("params")}
    step_errs = step_card_against_cpu(torch, opt, state_cpu, tp_result, one)
    a1 += ranks[0]["forward"]["launches"]
    if ranks[0]["forward"]["launches"] != TP_FORWARDS:
        raise AssertionError(f"12b: residual_stack launched {ranks[0]['forward']['launches']} "
                             f"times in {TP_FORWARDS} forwards")
    for r, rank in enumerate(ranks):   # the extractor is replicated: every rank runs it
        expect_extractor(rank["forward"]["extractor"], TP_FORWARDS, f"12b rank {r}",
                         pos_conv=0)
    emit({"phase": "path", "path": "tensor parallel, two gloo ranks on one card, mesh (1, 2), "
          "vs one process", "card": smi, "B": TP_B, "train_B": TRAIN_B,
          "seconds": CLIP_SAMPLES / SAMPLE_RATE, "text_tokens": TEXT_TOKENS,
          "forward": {"dtype": cfg.compute_dtype, "frontend_dsp": True,
                      "tol": AGREE_TOL["bfloat16"], "max_abs_diff": forward_err,
                      "ms": median(ranks[0]["forward"]["ms_all"]),
                      "one_process_ms": median(one_ms),
                      "ms_all": ranks[0]["forward"]["ms_all"], "one_process_ms_all": one_ms},
          "step": {"dtype": "float32", "frozen_backbones": True, "tol": TRAIN_TOL,
                   "max_abs_diff": step_errs, "ms": median(ranks[0]["step_ms_all"]),
                   "one_process_ms": median(one_step_ms),
                   "ms_all": ranks[0]["step_ms_all"], "one_process_ms_all": one_step_ms},
          "collectives": "gloo all-reduces through the host (a host cost, not NVLink's)",
          "launches": {"residual_stack": ranks[0]["forward"]["launches"],
                       "extractor": [rank["forward"]["extractor"] for rank in ranks]}})

    # 12c. the academic_eval CLI on two ranks against 10c's one process
    acad = [json.loads((work / f"rank{r}_academic.json").read_text())
            for r in range(TP_WORKERS)]
    one_json = json.loads((work / "academic_out" / "academic_evaluation.json").read_text())
    group_json = json.loads((work / TP_ACADEMIC_OUT / "academic_evaluation.json").read_text())
    bad = []
    # 10c's checkpoint predicts one class for nearly every clip, so equal
    # F1s alone would let a wrong noise draw, row order or gather through.
    # Every pass's gathered rows, row for row: labels and indices equal,
    # logits (and SNRs, features) within AGREE_TOL
    one_passes = PassRows.load(work / "academic_passes.npz")
    one_base = np.load(work / "academic_passes.npz")
    rank_passes = [PassRows.load(work / f"rank{r}_passes.npz") for r in range(TP_WORKERS)]
    logits_err, nonfinite = 0.0, {}
    for r, passes in enumerate(rank_passes):
        err, odd, out = check_passes(passes, one_passes, AGREE_TOL["bfloat16"])
        logits_err = max(logits_err, err)
        nonfinite.update({f"rank {r}: {k}": n for k, n in odd.items()})
        bad += [f"rank {r}: {b}" for b in out]
    # the JSON rank 0 wrote and each rank's results: 10c's F1s exactly, the
    # binned calibration fields from the run's own rows, the other numbers
    # (AUROC / AUPR, per-SNR, few-shot, ...) within AGREE_TOL
    bad += [f"10c: {k} is {one_json['calibration'][k.split('/')[1]]}, its rows give {v}"
           for k, v in calibration_of(one_passes[0]).items()
           if not same(one_json["calibration"][k.split("/")[1]], v)]
    fields_err = 0.0
    for name, got, passes in [("JSON", group_json, rank_passes[0])] + [
            (f"rank {r}", a["results"], rank_passes[r]) for r, a in enumerate(acad)]:
        err, out = check_results(got, one_json, passes[0], AGREE_TOL["bfloat16"])
        fields_err = max(fields_err, err)
        bad += [f"{name}: {b}" for b in out]
    if bad or nonfinite:
        raise AssertionError("12c: the two-rank battery's results differ from 10c's: "
                             + "; ".join(bad) + f" (non-finite entries: {nonfinite})")
    # each rank's batches hold 4 of the 8 rows: the benchmark runs B 1 and 4
    rows = 8 // TP_WORKERS
    bench_sizes = len({1, min(4, rows), min(8, rows), rows})
    want_a1 = ((2 + 3 * 2 + 2 * 5 + 3) * int(one_base["steps"]) + 7 * bench_sizes
               + int(one_base["few_shot_steps"]))
    if acad[0]["num_samples"] != MANIFEST_CLIPS or any(a["launches"] != want_a1 for a in acad):
        raise AssertionError(f"12c: {acad[0]['num_samples']} samples, residual_stack launched "
                             f"{[a['launches'] for a in acad]} times, not once in each of "
                             f"{want_a1} eval forwards a rank")
    a1 += acad[0]["launches"]
    for r, a in enumerate(acad):
        expect_extractor(a["extractor"], a["launches"] + a["adapt_steps"], f"12c rank {r}",
                         pos_conv=0)
    emit({"phase": "path", "path": "academic_eval CLI on two gloo ranks on one card, mesh "
          "(2, 1), vs 10c's one process", "card": smi, "clips": MANIFEST_CLIPS,
          "batch_size": 8, "args": " ".join(ACADEMIC_ARGS), "cli_s": acad[0]["seconds"],
          "cli_s_by_rank": [a["seconds"] for a in acad],
          "f1_fields": len([k for k in result_numbers(one_json) if "f1" in k]),
          "fields_held": len(result_numbers(one_json)), "f1_equal": True,
          "fields_tol": AGREE_TOL["bfloat16"], "fields_max_abs_diff": fields_err,
          "calibration": {"one_process": calibration_of(one_passes[0]),
                          "two_ranks": calibration_of(rank_passes[0][0])},
          "passes_held": len(one_passes), "nonfinite_entries": sum(nonfinite.values()),
          "logits_tol": AGREE_TOL["bfloat16"],
          "logits_max_abs_diff": logits_err,
          "launches": {"residual_stack": [a["launches"] for a in acad],
                       "extractor": [a["extractor"] for a in acad],
                       "adapt_steps": [a["adapt_steps"] for a in acad]}})
    emit({"phase": "path", "path": "tensor parallelism (phase 12)",
          "seconds": time.perf_counter() - t_start, "workers_s": workers_s,
          "residual_stack_launches": a1})
    return a1


# Each counted kernel's key in the port's launch table (utils/profiling.counters)
LAUNCH_KEYS = {"residual_stack": "residual_stack.launches", "conv_front": "conv_front.launches",
               "conv_tail": "conv_tail.launches", "pos_conv": "pos_conv.launches",
               "flash_attention": "flash_attention.launches",
               "attentive_pooling": "attentive_stats_pooling.launches",
               "int8_matmul": "int8_matmul.launches"}
COUNTED_FROM: dict = {}


def launch_table() -> dict:
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import profiling
    return profiling.counters()


def reset_counts() -> None:
    """Count the kernels' launches from here on (`counts`)."""
    COUNTED_FROM.update(launch_table())


def counts() -> dict:
    """Each kernel's launches since the last `reset_counts`."""
    table = launch_table()
    return {name: table.get(key, 0) - COUNTED_FROM.get(key, 0)
            for name, key in LAUNCH_KEYS.items()}


# The audio encoder's kernels' launches on the model paths: each of the
# group-mode extractor's front and A4 once in every forward of a
# wav2vec2-base extractor on the card in bf16 with no gradient recorded, and
# F2 (pos_conv) once in every such forward of a wav2vec2-family encoder
# (base, large, WavLM, the small student) without tensor parallelism; in no
# other. A path that counts otherwise is kept and raised at the end, so that
# one run names them all.
EXTRACTOR = {"conv_front": 0, "conv_tail": 0, "pos_conv": 0, "faults": []}


def expect_extractor(count: dict, want: int, what: str, pos_conv: Optional[int] = None) -> None:
    """`want` launches of the front and A4 in `count`, and `pos_conv` of F2
    (`want` where not given: every wav2vec2-base forward takes all three)."""
    got = (count["conv_front"], count["conv_tail"])
    if got != (want, want):
        EXTRACTOR["faults"].append(f"{what}: conv_front and conv_tail launched {got[0]} and "
                                   f"{got[1]} times, not {want} each")
    want_pos = want if pos_conv is None else pos_conv
    if count["pos_conv"] != want_pos:
        EXTRACTOR["faults"].append(f"{what}: pos_conv launched {count['pos_conv']} times, "
                                   f"not {want_pos}")
    EXTRACTOR["conv_front"] += got[0]
    EXTRACTOR["conv_tail"] += got[1]
    EXTRACTOR["pos_conv"] += count["pos_conv"]


def main() -> int:
    t_main = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch import frontend
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
        ModelConfig, to_json)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
        layers, model as mdl, wav2vec2 as w2v)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
        _build, attentive_pooling as ap, conv_front as cf, conv_tail as ct,
        flash_attention as fa, pos_conv as pc, residual_stack as rs)
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
    for module in (rs, cf, ct, pc, fa, ap):
        module.build()
    emit({"phase": "build", "kernels": list(KERNEL_NAMES),
          "seconds": time.perf_counter() - t0,
          "ptxas": {k: ptxas_report((_build.BUILD_DIR / f"{k}.log").read_text())
                    for k in KERNEL_NAMES if (_build.BUILD_DIR / f"{k}.log").exists()}})

    # 3a. A1: the residual stack, one cooperative grid over the card; B=300
    # has blocks that loop over several row groups
    L, D = 35, 512
    reset_counts()
    errs = {}
    batches = (1, 3, 4, 8, 11, 128, 300) + A1_TTA_BATCHES
    for B in batches:
        stacked, x = residual_stack_inputs(torch, B, L, D, seed=B)
        got = rs.residual_stack(stacked, x)
        want = rs.residual_stack_plain(stacked, x)
        torch.cuda.synchronize()
        errs[B] = check_close(f"residual_stack B={B}", got, want, KERNEL_TOL)
    if counts()["residual_stack"] != len(batches):
        raise AssertionError(f"residual_stack launched {counts()['residual_stack']} "
                             f"times for {len(batches)} calls")
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    timing, plans = {}, {}
    for B in (4, 128) + A1_TTA_BATCHES:
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
                x = layers.gelu(layers.conv1d(conv, x, 2))
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

    # 3b'. the group-mode extractor's two kernels at the benchmark's buckets
    extractor = extractor_phase(torch)
    emit({"phase": "kernel", "name": "conv_front + conv_tail", **extractor})

    # 3b''. F2: the positional conv at the benchmark's shapes
    pos = pos_conv_phase(torch)
    emit({"phase": "kernel", "name": "pos_conv", **pos})

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

    # 4c. the TTA step and its views, card against CPU, on the same rows
    emit({"phase": "agree", "path": "tta_step", "views": 5, "view_tol": VIEW_TOL,
          "tol": AGREE_TOL,
          "max_abs_diff": tta_card_against_cpu(torch, audio, audio_mask, ids, text_mask)})

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
        reset_counts()
        for _ in range(requests):
            t0 = time.perf_counter()
            out = mdl.model_forward(params, cfg, batch)
            logits = out.logits.cpu()
            times.append(time.perf_counter() - t0)
        count = counts()
        if count["residual_stack"] != requests:
            raise AssertionError(f"B={B}: residual_stack launched {count['residual_stack']} "
                                 f"times in {requests} forwards")
        launches["residual_stack"] += count["residual_stack"]
        expect_extractor(count, requests, f"model_forward B={B}")
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
            reset_counts()
            for _ in range(requests):
                t0 = time.perf_counter()
                out = mdl.model_forward(params, cfg, batch)
                logits = out.logits.cpu()
                times.append(time.perf_counter() - t0)
            count = counts()
            if count["residual_stack"] != requests:
                raise AssertionError(f"{kind} B={B}: residual_stack launched "
                                     f"{count['residual_stack']} times in {requests} forwards")
            launches["residual_stack"] += count["residual_stack"]
            expect_extractor(count, requests, f"model_forward with the DSP, {kind} B={B}")
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
    for B, calls in ((4, 5), (128, 3)):
        record = fused_extractor_path(torch, w2v_params, cfg.audio, B, calls,
                                      vocab=cfg.text.vocab_size)
        launches["conv_tail"] += record["launches"]["conv_tail"]
        launches["conv_front"] += record["launches"]["conv_front"]
        emit({"phase": "path", "path": "feature_encoder(allow_fused=True)", "B": B,
              "seconds": 4.0, "card": smi, **record})
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
        reset_counts()
        outs = {site: fa.flash_attention(*inputs[site], num_heads=ATTENTION_SITES[site][3])
                for site in ATTENTION_SITES}
        pooled = {site: ap.attentive_stats_pooling(*pool_inputs[site])
                  for site in POOLING_SITES}
        torch.cuda.synchronize()
        if ap.attentive_stats_pooling.last_route != "bf16":
            raise AssertionError(f"B={B}: pooling took route "
                                 f"{ap.attentive_stats_pooling.last_route}, not bf16")
        count = counts()
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

    # 5d. manifest eval through the port's CLI: 48 WAV clips, a checkpoint
    # of random full-width weights, 5-view TTA, calibrated temperature
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli import (
        eval as eval_cli)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.config import (
        Config, DataConfig)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
        manifest as manifest_lib, pipeline, prefetch, tokenizer)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
        evaluate as ev)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        checkpoint as ckpt)
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        manifest = write_manifest_clips(work, MANIFEST_CLIPS, seed=0)
        eval_cfg = Config(model=cfg, data=DataConfig(dataset_root=str(work / "datasets")))
        params = mdl.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        ckpt.save_checkpoint(work / "checkpoint", params=params, config_json=to_json(eval_cfg))
        del params
        torch.cuda.empty_cache()
        preds_path = work / "predictions.jsonl"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = eval_cli.main(["--manifest", manifest, "--checkpoint", str(work / "checkpoint"),
                             "--use_tta", "--num_tta", "5", "--calibrate",
                             "--val_manifest", manifest, "--batch_size", "8",
                             "--predictions_out", str(preds_path)])
        cli_seconds = time.perf_counter() - t0
        count = counts()
        peak = torch.cuda.max_memory_allocated()
        steps, cal_steps = len(res["step_seconds"]), len(res["calibration_step_seconds"])
        if count["residual_stack"] != steps + cal_steps:
            raise AssertionError(f"manifest eval: residual_stack launched "
                                 f"{count['residual_stack']} times in {steps} TTA and "
                                 f"{cal_steps} calibration steps")
        launches["residual_stack"] += count["residual_stack"]
        expect_extractor(count, steps + cal_steps, "manifest eval")
        logits = res["logits"]
        if logits.shape != (MANIFEST_CLIPS, cfg.num_labels) or not np.isfinite(logits).all():
            raise AssertionError(f"manifest eval: logits {logits.shape} not finite")
        items = manifest_lib.read_manifest(manifest)
        rows = [json.loads(line) for line in preds_path.read_text().splitlines()]
        if sorted(r["index"] for r in rows) != list(range(MANIFEST_CLIPS)) or any(
                r["audio"] != items[r["index"]]["audio"]
                or r["label"] != items[r["index"]]["label"] for r in rows):
            raise AssertionError(f"manifest eval: {len(rows)} prediction lines do not join "
                                 f"back to the {len(items)} manifest rows")
        # host reads of one TTA step and one plain step (logits read back
        # included), and of the prefetch alone, on the CLI's first batch
        params, _ = ckpt.restore_checkpoint(work / "checkpoint")
        loader = pipeline.BucketedLoader(
            pipeline.SERDataset(manifest, eval_cfg.data), batch_size=8,
            tokenizer=tokenizer.get_tokenizer(vocab_size=cfg.text.vocab_size), shuffle=False)
        n_batches, prefetch_reads = host_reads(torch, lambda: sum(
            1 for _ in prefetch.device_prefetch(loader.epoch(0), torch.device("cuda"),
                                                skip=pipeline.EVAL_HOST_KEYS)))
        batch, _ = next(prefetch.device_prefetch(loader.epoch(0), torch.device("cuda"),
                                                 skip=pipeline.EVAL_HOST_KEYS))
        tta_step = ev.make_tta_eval_step(eval_cfg, 5)
        generator = torch.Generator(device="cuda").manual_seed(0)
        _, tta_reads = host_reads(torch, lambda: tta_step(params, batch, generator).cpu())
        plain_step = ev.make_eval_step(cfg, use_openmax=False)
        _, plain_reads = host_reads(torch, lambda: plain_step(params, batch)[0].cpu())
        warm = sorted(res["step_seconds"][1:])
        emit({"phase": "path", "path": "manifest eval (cli.eval: 5-view TTA, calibrated)",
              "card": smi, "clips": MANIFEST_CLIPS, "batch_size": 8, "tta_rows": 40,
              "buckets_s": sorted({b["audio"].shape[1] / SAMPLE_RATE
                                   for b in loader.epoch(0)}),
              "tta_steps": steps, "calibration_steps": cal_steps,
              "clips_per_s": MANIFEST_CLIPS / res["pass_seconds"],
              "tta_pass_s": res["pass_seconds"],
              "tta_step_ms": {"first": 1e3 * res["step_seconds"][0],
                              "median_after_first": 1e3 * warm[len(warm) // 2],
                              "all": [1e3 * x for x in res["step_seconds"]]},
              "loader_wait_s": res["pass_seconds"] - float(res["step_seconds"].sum()),
              "calibration_step_ms": [1e3 * x for x in res["calibration_step_seconds"]],
              "cli_s": cli_seconds, "decoder": res["decoder"],
              "temperature": res["temperature"],
              "host_reads": {"tta_step": tta_reads, "plain_step": plain_reads,
                             "prefetch_pass": prefetch_reads, "prefetch_batches": n_batches},
              "max_memory_allocated": peak, "launches": count,
              "prediction_lines": len(rows)})
        del res, batch
        torch.cuda.empty_cache()

        # 5e. bench.py's TTA shape: 5 views, the DSP on, logits / 1.2
        bench_cfg = Config(model=cfg)
        tta_step = ev.make_tta_eval_step(bench_cfg, 5, use_openmax=True)
        for B, requests in ((4, REQUESTS_B4), (128, REQUESTS_B128)):
            batch = example_batch(B, T=CLIP_SAMPLES, S=TEXT_TOKENS, vocab=cfg.text.vocab_size)
            del batch["quality_feats"], batch["cond_feats"]
            batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
            generator = torch.Generator(device="cuda").manual_seed(1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            times = []
            for _ in range(requests):
                t0 = time.perf_counter()
                out = (tta_step(params, batch, generator) / 1.2).cpu()
                times.append(time.perf_counter() - t0)
            count = counts()
            peak = torch.cuda.max_memory_allocated()
            if count["residual_stack"] != requests:
                raise AssertionError(f"TTA B={B}: residual_stack launched "
                                     f"{count['residual_stack']} times in {requests} calls")
            launches["residual_stack"] += count["residual_stack"]
            expect_extractor(count, requests, f"TTA B={B}")
            if tuple(out.shape) != (B, cfg.num_labels) or not torch.isfinite(out).all():
                raise AssertionError(f"TTA B={B}: logits {tuple(out.shape)} not finite")
            _, reads = host_reads(torch, lambda: tta_step(params, batch, generator).cpu())
            ms = 1e3 * sorted(times[1:])[len(times[1:]) // 2]
            emit({"phase": "path", "path": "bench.py TTA shape (5 views, /1.2)", "B": B,
                  "rows": 5 * B, "seconds": 4.0, "text_tokens": TEXT_TOKENS, "card": smi,
                  "requests": requests, "first_ms": 1e3 * times[0], "ms": ms,
                  "utt_per_s": B / (ms / 1e3), "host_reads": reads,
                  "max_memory_allocated": peak, "launches": count})
            del batch, out
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
        launches["residual_stack"] += train_phases(torch, smi, cfg, small, work,
                                                   manifest)
        launches["residual_stack"] += serve_phases(torch, smi, cfg, work)
        large = large_backbone_phases(torch, smi, work, manifest)
        for kname, n in large["launches"].items():
            launches[kname] += n
        launches["residual_stack"] += int8_asr_phases(torch, smi, cfg, work,
                                                       manifest)
        launches["residual_stack"] += academic_phases(torch, smi, cfg, work)
        launches["residual_stack"] += parallel_phases(torch, smi, cfg, work, manifest)
        launches["residual_stack"] += tensor_parallel_phases(torch, smi, cfg, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    main_path = {k: EXTRACTOR[k] for k in ("conv_front", "conv_tail", "pos_conv")}
    for kname, n in main_path.items():
        launches[kname] += n
    for kname, n in launches.items():
        if n < 1:
            raise AssertionError(f"{kname} was launched no time on its path")
    emit({"phase": "total", "seconds": time.perf_counter() - t_main})
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
         "B": 4, "plan": plans[4], "at_B128": {**timing[128], "plan": plans[128]},
         "at_tta_rows": {B: {**timing[B], "plan": plans[B]} for B in A1_TTA_BATCHES}},
        {"name": "conv_tail", "route": "cuda", "source": SOURCE.format("conv_tail"),
         "replaces": REPLACES.format(467), "launches": launches["conv_tail"],
         "max_abs_err": max(*tail["max_abs_err"].values(),
                            *large["ln_route"]["max_abs_err"].values()),
         "tol": BF16_TOL["conv_tail"],
         "ms": tail128["ms"], "plain_ms": tail128["plain_ms"],
         "bound_ms": tail128["bound_ms"], "bound_by": tail128["bound_by"],
         "ms_over_bound": tail128["ms_over_bound"], "tflop_per_s": tail128["tflop_per_s"],
         "library_ms": None, "cudnn_path_ms": tail128["cudnn_path_ms"],
         "model_path_launches": main_path["conv_tail"],
         "B": 128, "at_B4": tail["timing"][4], "ln_route": large["ln_route"]},
        {"name": "conv_front", "route": "cuda", "source": SOURCE.format("conv_front"),
         "replaces": None, "launches": launches["conv_front"],
         "model_path_launches": main_path["conv_front"],
         "max_abs_err": max(b["front"]["max_abs_err"] for b in extractor["buckets"].values()),
         "tol": BF16_TOL["conv_tail"], "library_ms": None, "buckets": {
             k: {"front": b["front"], "tail": b["tail"], "feature_encoder": b["feature_encoder"]}
             for k, b in extractor["buckets"].items()}},
        {"name": "pos_conv", "route": "cuda", "source": SOURCE.format("pos_conv"),
         "replaces": None, "launches": launches["pos_conv"],
         "model_path_launches": main_path["pos_conv"],
         "max_abs_err": max(b["max_abs_err"] for b in pos["shapes"].values()),
         "flipped_share": max(b["flipped_share"] for b in pos["shapes"].values()),
         **{k: v for k, v in pos["shapes"]["flagship B=256 4s"].items()
            if k in ("ms", "bound_ms", "bound_by", "ms_over_bound", "plain_ms", "library_ms")},
         "shapes": pos["shapes"]},
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
         "library_ms": None, "B": 128, "site": "pool_a", "pool_route": "bf16",
         "plan": pool["plan"]["pool_a B=128"], "sites": pool["timing"]},
    ]})
    if EXTRACTOR["faults"]:
        raise AssertionError("the group-mode extractor's kernels on the model paths: "
                             + "; ".join(EXTRACTOR["faults"]))
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])))
    sys.exit(main())

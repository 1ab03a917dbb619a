"""A labelling pipeline's stream: a bucketed manifest of speech clips,
each with its transcript's token ids.

Parameters (a workload file's "params"):
  buckets      [{"seconds", "clip_seconds": [lo, hi], "batch", "share"}]:
               each bucket's padded length, the range its clips' lengths
               are drawn from, clips a batch, and its batches a cycle
  cycles       cycles of batches made; within each the order of the
               buckets' batches is shuffled by the seed
  noisy_share  share of clips with white noise added
  snr_db       [lo, hi]: a noisy clip's signal-to-noise ratio, drawn
               uniformly
  text_tokens  [lo, hi]: a transcript's length; text_pad its padded length

Clean clips are synthetic voiced speech: a glottal pulse train as a sum of
harmonics of a gliding pitch, shaped by a formant, under a syllable-rate
envelope with a silent lead-in, tail and mid-phrase pause, over a quiet
noise floor. A noisy clip adds white Gaussian noise at its drawn SNR
below the speech's power over the clip, as the reference repository's
`src/data/preprocess.py:add_noise_snr` does; the workload files take the
reference's own rate for it (`src/train.py:130-143`: probability 0.5,
SNR uniform in [10, 20) dB). Each clip is padded with zeros to its
bucket, its mask set over its samples.

The seed sets every draw: the same seed gives the same batches on one
kind of device. Every seed gives the same number of batches of each
bucket in each cycle, at the same sizes.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

SAMPLE_RATE = 16000
HARMONICS = 10
BOS, PAD, EOS, FIRST_WORD = 0, 1, 2, 5


def cycle_order(params: dict, rng: np.random.Generator) -> List[int]:
    """Bucket index of each batch, cycle after cycle, shuffled within each."""
    one = [i for i, b in enumerate(params["buckets"]) for _ in range(b["share"])]
    return [int(i) for _ in range(params["cycles"]) for i in rng.permutation(one)]


def _clip_params(rng: np.random.Generator, B: int, lo: float, hi: float,
                 params: dict) -> Dict[str, np.ndarray]:
    seconds = rng.uniform(lo, hi, B)
    noisy = rng.random(B) < params["noisy_share"]
    return {
        "length": np.floor(seconds * SAMPLE_RATE).astype(np.int64),
        "f0": rng.uniform(90.0, 280.0, B),
        "glide": rng.uniform(0.75, 1.3, B),
        "formant": rng.uniform(400.0, 900.0, B),
        "tilt": rng.uniform(0.8, 1.6, B),
        "phases": rng.uniform(0.0, 2 * math.pi, (B, HARMONICS)),
        "syllable_hz": rng.uniform(2.5, 5.5, B),
        "syllable_phase": rng.uniform(0.0, 2 * math.pi, B),
        "lead": rng.uniform(0.05, 0.2, B),
        "tail": rng.uniform(0.05, 0.2, B),
        "pause": rng.random(B) < 0.5,
        "pause_at": rng.uniform(0.3, 0.6, B),
        "pause_len": rng.uniform(0.15, 0.4, B),
        "peak": rng.uniform(0.05, 0.5, B),
        "floor_db": rng.uniform(50.0, 65.0, B),
        "noisy": noisy,
        "snr": rng.uniform(*params["snr_db"], B),
    }


def _synthesise(c: Dict[str, np.ndarray], T: int, generator: torch.Generator,
                device) -> torch.Tensor:
    """[B, T] float32 audio of the clips `c`, zero past each clip's length."""
    f64 = dict(dtype=torch.float64, device=device)
    col = lambda k: torch.as_tensor(c[k], **f64)[:, None]
    B = len(c["length"])
    t = torch.arange(T, **f64)[None, :] / SAMPLE_RATE
    dur = col("length") / SAMPLE_RATE
    valid = t < dur
    # gliding pitch: f(t) = f0 (1 + (glide - 1) t / dur), its phase in closed form
    phase = 2 * math.pi * col("f0") * (t + (col("glide") - 1.0) * t * t / (2.0 * dur))
    f0_mid = col("f0") * (1.0 + col("glide")) / 2.0
    phases = torch.as_tensor(c["phases"], **f64)
    voiced = torch.zeros(B, T, **f64)
    for k in range(1, HARMONICS + 1):
        formant = torch.exp(-((k * f0_mid - col("formant")) / 250.0) ** 2)
        amp = k ** -col("tilt") * (1.0 + 1.5 * formant)
        voiced += amp * torch.sin(k * phase + phases[:, k - 1:k])
    syllable = torch.sin(2 * math.pi * col("syllable_hz") * t + col("syllable_phase"))
    env = syllable.clamp(min=0.0) ** 2
    env = env * (t >= col("lead")) * (t < dur - col("tail"))
    pause_start = col("pause_at") * dur
    in_pause = (t >= pause_start) & (t < pause_start + col("pause_len"))
    env = env * ~(in_pause & torch.as_tensor(c["pause"], device=device)[:, None])
    speech = voiced * env
    speech = speech * col("peak") / speech.abs().amax(-1, keepdim=True).clamp(min=1e-9)

    m = valid.to(torch.float64)
    rms = torch.sqrt((speech * speech * m).sum(-1, keepdim=True) / m.sum(-1, keepdim=True))
    noise = torch.randn(B, T, generator=generator, **f64)
    floor = noise * 10.0 ** (-col("floor_db") / 20.0)
    dirt = noise.roll(1, -1) * 10.0 ** (-col("snr") / 20.0) * rms
    audio = speech + floor + dirt * torch.as_tensor(c["noisy"], device=device)[:, None]
    return (audio.clamp(-1.0, 1.0) * m).float()


def _text(rng: np.random.Generator, B: int, params: dict, vocab_size: int):
    S = params["text_pad"]
    n = rng.integers(params["text_tokens"][0], params["text_tokens"][1] + 1, B)
    ids = np.full((B, S), PAD, np.int64)
    words = rng.integers(FIRST_WORD, vocab_size, (B, S))
    pos = np.arange(S)[None, :]
    ids = np.where(pos < n[:, None] - 1, words, ids)
    ids[:, 0] = BOS
    ids[np.arange(B), n - 1] = EOS
    return ids, (pos < n[:, None]).astype(np.float32)


def generate(params: dict, seed: int, device, vocab_size: int) -> List[dict]:
    """The stream's distinct batches, in order: each a dict of `audio`
    [B, T] and `audio_mask` float32, `text_ids` int64 and `text_mask`
    float32 [B, text_pad] on `device`, with `bucket_seconds` and `clips`."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x4C42]))
    generator = torch.Generator(device=device)
    generator.manual_seed(int(np.random.SeedSequence([seed, 0x4E4F]).generate_state(
        1, np.uint64)[0]))
    out = []
    for b in cycle_order(params, rng):
        bucket = params["buckets"][b]
        B, T = bucket["batch"], int(bucket["seconds"] * SAMPLE_RATE)
        c = _clip_params(rng, B, *bucket["clip_seconds"], params)
        ids, text_mask = _text(rng, B, params, vocab_size)
        audio = _synthesise(c, T, generator, device)
        mask = (torch.arange(T, device=device)[None, :]
                < torch.as_tensor(c["length"], device=device)[:, None]).float()
        out.append({"audio": audio, "audio_mask": mask,
                    "text_ids": torch.as_tensor(ids, device=device),
                    "text_mask": torch.as_tensor(text_mask, device=device),
                    "bucket_seconds": bucket["seconds"], "clips": B})
    return out

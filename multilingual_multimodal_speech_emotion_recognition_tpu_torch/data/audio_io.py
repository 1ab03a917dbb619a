"""Host-side audio loading.

A copy of the JAX package's data/audio_io.py. Parity target: the
reference's load_audio (src/data/preprocess.py:5-47): `datasets/` path
prefixing, mono downmix, resample to 16 kHz, trim to 30 s, pad to >= 0.5 s,
and 1 s of zeros on any load error (a missing file included).

Implemented with the stdlib `wave` module + numpy (PCM16/24/32/8 and
float32 WAV); scipy's polyphase resampler handles non-16 kHz sources on
the host (resampling for TTA runs on the device, ops/audio_dsp.py). No
torchaudio/librosa dependency.
"""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Tuple

import numpy as np


def read_wav(path: str | Path) -> Tuple[np.ndarray, int]:
    """Returns (float32 samples [channels, T] scaled to [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        sr = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = val.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported sample width {sampwidth}")
    return data.reshape(-1, n_channels).T, sr


def read_audio(path: str | Path) -> Tuple[np.ndarray, int]:
    """Decode any supported format to (float32 [channels, T], sample_rate).
    WAV decodes via the stdlib; other containers (flac/ogg/mp3 — the
    reference loads them through torchaudio, preprocess.py:14) fall back to
    soundfile or torchaudio when those are importable, and raise otherwise
    so the caller's zeros-on-error path fires instead of mis-decoding."""
    try:
        return read_wav(path)
    except Exception:
        pass
    try:
        import soundfile as sf
        data, sr = sf.read(str(path), dtype="float32", always_2d=True)
        return data.T, int(sr)
    except ImportError:
        pass
    try:
        import torchaudio
        wav, sr = torchaudio.load(str(path))
        return wav.numpy().astype(np.float32), int(sr)
    except ImportError:
        pass
    raise ValueError(f"cannot decode {path}: not a readable WAV and no "
                     "soundfile/torchaudio backend available")


def resample_host(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    if orig_sr == new_sr:
        return x
    from scipy.signal import resample_poly
    import math
    # A corrupt WAV header can declare an arbitrary sample rate; a rate that
    # is coprime-ish with the target makes resample_poly build a polyphase
    # filter of ~20*max(up, down) taps (minutes of CPU at adversarial
    # values). Every real-world rate (8k/11.025k/16k/22.05k/44.1k/48k/96k/
    # 192k) reduces to tiny up/down vs 16 kHz, so reject implausible ratios
    # and let load_audio's zeros-on-error fallback handle the file.
    if not (1000 <= orig_sr <= 768_000):
        raise ValueError(f"implausible sample rate {orig_sr}")
    g = math.gcd(orig_sr, new_sr)
    up, down = new_sr // g, orig_sr // g
    if max(up, down) > 10_000:
        raise ValueError(f"implausible resample ratio {orig_sr}->{new_sr}")
    return resample_poly(x, up, down, axis=-1).astype(np.float32)


def resolve_path(path: str | Path, dataset_root: str = "datasets") -> Path:
    """The reference's `datasets/` path-prefix rule (preprocess.py:8-12)."""
    p = Path(path)
    if dataset_root and not str(p).startswith(dataset_root) and not p.is_absolute():
        p = Path(dataset_root) / p
    return p


def load_audio(path: str | Path, *, sr: int = 16000, max_length: float = 30.0,
               min_length: float = 0.5, dataset_root: str = "datasets") -> np.ndarray:
    """Load one clip as float32 [T] following the reference's semantics,
    including the zeros-on-error fallback (preprocess.py:44-47).

    Fast path: the native C++ decoder (native/wav_decoder.cc) handles
    target-rate WAV files end to end (decode, downmix, trim, pad); anything
    it can't (other containers, resampling, corrupt files) falls through to
    the Python/scipy path below with identical semantics."""
    p = resolve_path(path, dataset_root)
    from . import native
    if native.available():
        wav, st = native.decode_wav(
            p, target_sr=sr, max_samples=int(sr * max_length),
            min_samples=int(sr * min_length))
        if st == native.OK:
            return wav
        if st == native.OPEN_FAILED and not p.exists():
            print(f"Error loading {p}: file not found")
            return np.zeros(sr, dtype=np.float32)
    try:
        data, orig_sr = read_audio(p)
        if data.shape[0] > 1:
            data = data.mean(axis=0, keepdims=True)
        data = resample_host(data, orig_sr, sr)
        wavef = data[0]
        max_samples = int(sr * max_length)
        if wavef.shape[0] > max_samples:
            wavef = wavef[:max_samples]
        min_samples = int(sr * min_length)
        if wavef.shape[0] < min_samples:
            wavef = np.pad(wavef, (0, min_samples - wavef.shape[0]))
        return np.ascontiguousarray(wavef, dtype=np.float32)
    except Exception as e:  # corrupted/missing file -> 1 s of zeros
        print(f"Error loading {p}: {e}")
        return np.zeros(sr, dtype=np.float32)


def write_wav(path: str | Path, samples: np.ndarray, sr: int = 16000) -> None:
    """PCM16 writer (for tests and tooling)."""
    samples = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = np.round(samples * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())

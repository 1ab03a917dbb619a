"""ctypes bindings for the native WAV decoder (native/wav_decoder.cc).

A copy of the JAX package's data/native.py, except where the library goes:
g++ builds the repo's native/wav_decoder.cc on first use into
`build/native/wav_decoder-<hash>.so` at the root of the checkout (listed in
.gitignore), not next to the source; the hash covers the source and the
flags. The binding layer is a plain C ABI + ctypes. Every entry point
degrades gracefully: if the compiler or library is unavailable, callers
fall back to the pure-Python path in audio_io.py with identical semantics
— the JAX package's host semantics, not a device fallback. The loader
records which decoder it used (`BucketedLoader.decoder`).

Status codes mirror the enum in wav_decoder.cc: 0 ok, 1 open-failed
(-> zeros-on-error), 2/3/5 container/format problems and 4 needs-resample
(-> Python decoder + scipy polyphase resampler).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

OK = 0
OPEN_FAILED = 1
NEEDS_RESAMPLE = 4

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "wav_decoder.cc"
_BUILD_DIR = _ROOT / "build" / "native"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"wav_decoder-{digest[:16]}.so"


def _build() -> Optional[Path]:
    """The built library, compiling it first where it is missing; None
    where g++ fails or is absent. Written under a temporary name and
    renamed, so processes that build at once never load a partial file."""
    lib = _library_path()
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("SER_DISABLE_NATIVE_IO"):
            return None
        path = _build() if _SRC.exists() else None
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.ser_wav_info.restype = ctypes.c_int32
        lib.ser_wav_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32)]
        lib.ser_decode_wav.restype = ctypes.c_int32
        lib.ser_decode_wav.argtypes = [
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.ser_decode_batch.restype = None
        lib.ser_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def wav_info(path: str | Path) -> Optional[Tuple[int, int]]:
    """(n_frames_at_native_sr, sample_rate) from the header, or None when
    the file isn't a parseable WAV (caller falls back to a full decode)."""
    lib = _load()
    if lib is None:
        return None
    frames = ctypes.c_int64(0)
    sr = ctypes.c_int32(0)
    st = lib.ser_wav_info(str(path).encode(), ctypes.byref(frames),
                          ctypes.byref(sr))
    if st != OK:
        return None
    return int(frames.value), int(sr.value)


def decode_wav(path: str | Path, *, target_sr: int, max_samples: int,
               min_samples: int) -> Tuple[Optional[np.ndarray], int]:
    """Decode one clip to float32 [<=max_samples] (mono, trimmed, padded to
    min). Returns (samples, OK) on success or (None, status) for fallback."""
    lib = _load()
    if lib is None:
        return None, -1
    out = np.empty(max(max_samples, min_samples), np.float32)
    n = ctypes.c_int64(0)
    st = lib.ser_decode_wav(
        str(path).encode(), target_sr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_samples, min_samples, ctypes.byref(n))
    if st != OK:
        return None, int(st)
    wav = out[: int(n.value)].copy()
    if len(wav) < min_samples:
        # trim-then-pad ordering (preprocess.py:29-39): the min-length pad
        # applies AFTER the max-length trim, so it can exceed max_samples
        wav = np.pad(wav, (0, min_samples - len(wav)))
    return wav, OK


def decode_batch(paths: Sequence[str], out: np.ndarray, *, target_sr: int,
                 min_samples: int,
                 n_threads: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a batch of WAV paths directly into `out` [B, T] (float32,
    C-contiguous, pre-zeroed rows assumed). Returns (lengths [B] int64,
    statuses [B] int32); rows with status != OK are untouched and must be
    filled by the Python fallback."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    assert out.dtype == np.float32 and out.flags.c_contiguous
    B, T = out.shape
    assert len(paths) <= B
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lens = np.zeros(n, np.int64)
    sts = np.zeros(n, np.int32)
    lib.ser_decode_batch(
        arr, n, target_sr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        T, T, min_samples,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
    return lens, sts

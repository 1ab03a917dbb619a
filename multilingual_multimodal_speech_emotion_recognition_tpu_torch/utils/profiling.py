"""Profiling and step-timing harnesses.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
utils/profiling.py: a profiler trace (torch.profiler over the CPU and, where
there is one, the card, written as a Chrome trace that Perfetto reads), a
device sync, a step timer with the JAX package's percentile report and a
throughput meter, and the card's memory counters under JAX's key names.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .runtime import leaves_with_paths, resolve_device

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Union[str, Path]):
    """torch.profiler.profile over the CPU and CUDA (CUDA where a card is
    present); on exit the Chrome trace goes to log_dir/trace.json. Yields
    the profiler, whose `key_averages()` sums the events by name."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))


def sync(tree) -> None:
    """Wait for the work that produces the tree's CUDA tensors (a
    torch.cuda.synchronize on their card); nothing for CPU tensors."""
    for _, leaf in leaves_with_paths(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


@dataclass
class StepTimer:
    """Per-step host wall times with percentile stats. The host clock sees
    the card's work only where the step ends in a sync (`sync`)."""
    times: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {"mean_ms": float(t.mean() * 1e3),
                "std_ms": float(t.std() * 1e3),
                "p50_ms": float(np.percentile(t, 50) * 1e3),
                "p95_ms": float(np.percentile(t, 95) * 1e3),
                "p99_ms": float(np.percentile(t, 99) * 1e3),
                "steps": len(self.times)}


@dataclass
class ThroughputMeter:
    """Items per second (per card)."""
    items: int = 0
    seconds: float = 0.0

    def add(self, n_items: int, dt: float) -> None:
        self.items += n_items
        self.seconds += dt

    def per_sec(self, n_chips: int = 1) -> float:
        return self.items / self.seconds / n_chips if self.seconds else 0.0


def device_memory_stats(device: Optional[Union[str, torch.device]] = None) -> Dict[str, int]:
    """The card's allocator counters under the JAX package's keys:
    bytes_in_use (torch.cuda.memory_allocated), peak_bytes_in_use
    (max_memory_allocated) and bytes_limit (the card's total memory,
    mem_get_info), beside torch.cuda.memory_stats' own integer counters.
    The card unless `device` says otherwise; a CPU device has none ({})."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    stats = {k: int(v) for k, v in torch.cuda.memory_stats(dev).items()
             if isinstance(v, (int, np.integer))}
    stats.update(bytes_in_use=int(torch.cuda.memory_allocated(dev)),
                 peak_bytes_in_use=int(torch.cuda.max_memory_allocated(dev)),
                 bytes_limit=int(torch.cuda.mem_get_info(dev)[1]))
    return stats

"""Profiling and step-timing harnesses.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
utils/profiling.py: a profiler trace (torch.profiler over the CPU and, where
there is one, the card, written as a Chrome trace that Perfetto reads), a
device sync, a step timer with the JAX package's percentile report and a
throughput meter, and the card's memory counters under JAX's key names.

Beside them, the program's own spans and counters, off unless switched on
(`tracing()`, or `trace()` for its duration): `span(name)` is a
`record_function` range "ser.<name>" at a layer boundary, so a profiler
trace shows the program's layers on the kernels' timeline; `count(name, n)`
adds to a named counter; `counters()` snapshots them beside the launch
table. Off, a span is one shared no-op context and a count returns at once:
no device operation, host read or allocation. While torch.compile or
torch.export traces, spans are no-ops too, so exported programs are the
same either way. The launch table, always on, counts each hand-written
kernel's launching calls under `launch_key(name)`, there from its import.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .runtime import leaves_with_paths, resolve_device

TRACE_FILE = "trace.json"
SPAN_PREFIX = "ser."


class _Tracing:
    """Whether spans and counts record; the named counters; the launch table."""

    def __init__(self):
        self.on = False
        self.counts: Dict[str, int] = {}
        self.launch_table: Dict[str, int] = {}
        self.lock = threading.Lock()


_TRACING = _Tracing()
_NO_SPAN = contextlib.nullcontext()


def span(name: str) -> contextlib.AbstractContextManager:
    """A "ser.<name>" range around the program's work while tracing is on;
    otherwise, and while torch.compile or torch.export traces, one shared
    no-op context."""
    if not _TRACING.on or torch.compiler.is_compiling():   # torch.export's tracing too
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while tracing is on."""
    if not _TRACING.on:
        return
    with _TRACING.lock:
        _TRACING.counts[name] = _TRACING.counts.get(name, 0) + n


def launch_key(name: str) -> str:
    """Kernel `name`'s key in the launch table, `<name>.launches`, put there at 0."""
    key = f"{name}.launches"
    _TRACING.launch_table.setdefault(key, 0)
    return key


def launched(key: str) -> None:
    """Count one launching call under `key` (from `launch_key`)."""
    with _TRACING.lock:
        _TRACING.launch_table[key] += 1


@contextlib.contextmanager
def tracing():
    """Spans and counts on inside the block; the previous state after it."""
    before = _TRACING.on
    _TRACING.on = True
    try:
        yield
    finally:
        _TRACING.on = before


def counters() -> Dict[str, int]:
    """Named counters and launch table, a snapshot; callers take the difference of two."""
    with _TRACING.lock:
        return {**_TRACING.counts, **_TRACING.launch_table}


@contextlib.contextmanager
def trace(log_dir: Union[str, Path]):
    """torch.profiler.profile over the CPU and CUDA (CUDA where a card is
    present), with the program's spans on; on exit the Chrome trace goes to
    log_dir/trace.json. Yields the profiler, whose `key_averages()` sums the
    events by name."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with tracing(), profile(activities=activities) as prof:
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

"""The traced window: `torch.profiler` over the CPU and the card, ranges
around the port's stage functions, and the reduction of the profiler's
events to the numbers the per-layer metrics read.

Ranges come from the benchmark's own files: a metric names the port
functions it reads (`RANGES`, (module, attribute) pairs under the port's
package), and for the traced window only the harness replaces each such
module attribute by a wrapper that opens a `record_function` range named
"perfbench.<attribute>". The port calls these through module attributes
or module globals, so the wrapper is what runs. A function a later change
renames is not wrapped, and the metrics that read it find nothing.

Attribution: each device operation (kernel, copy, set) is matched to the
CUDA runtime call that issued it by the profiler's correlation id (CUPTI's,
which the operation and its launch share), and counts to every range open
on that call's thread at that moment (the innermost one, and each around
it). An operation without a runtime call in the trace falls back to the
operator kineto links it to (`linked_correlation_id`). The device's busy
time is the union of the operations' intervals inside the window; the idle
share's
arithmetic is a copy of `union_ms` in the repository's
`scripts/torch_profile_forward.py`.
"""

from __future__ import annotations

import contextlib
import importlib
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PREFIX = "perfbench."
WINDOW = PREFIX + "window"


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals (a copy of
    scripts/torch_profile_forward.py:union_ms, without its unit change)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def stacks_at(ranges: Sequence[Tuple[str, float, float]],
              points: Sequence[float]) -> List[Tuple[str, ...]]:
    """For each time in `points`, the names of the ranges (name, start,
    end) of one thread open at it, outermost first. Ranges of one thread
    nest."""
    marks = []
    for i, (name, a, b) in enumerate(ranges):
        marks.append((a, 0, i))
        marks.append((b, 2, i))
    for j, t in enumerate(points):
        marks.append((t, 1, j))
    marks.sort()
    open_: List[int] = []
    out: List[Tuple[str, ...]] = [()] * len(points)
    for _, kind, i in marks:
        if kind == 0:
            open_.append(i)
        elif kind == 2:
            if i in open_:
                open_.remove(i)
        else:
            out[i] = tuple(ranges[k][0] for k in open_)
    return out


def reduce(host: Sequence[dict], device: Sequence[dict], main_thread: int) -> Optional[dict]:
    """Numbers of the traced window from the profiler's events.

    host: CPU events {name, start, end, thread, corr} (times in seconds);
    ranges are those named "perfbench.*", CUDA runtime calls those whose
    name starts with "cu", the rest operators. device: operations {name,
    start, end, corr, link}: `corr` the correlation id of the runtime call
    that issued each, `link` that of the operator kineto links it to.
    Returns None where the window's range is missing."""
    window = [(e["start"], e["end"]) for e in host if e["name"] == WINDOW]
    if not window:
        return None
    lo, hi = window[0]
    by_thread: Dict[int, List[Tuple[str, float, float]]] = defaultdict(list)
    launches, operators = {}, {}
    for e in host:
        if e["name"].startswith(PREFIX):
            by_thread[e["thread"]].append((e["name"][len(PREFIX):], e["start"], e["end"]))
        elif e.get("corr"):
            (launches if e["name"].startswith("cu") else operators)[e["corr"]] = (
                e["thread"], e["start"])
    ops = [d for d in device if d["end"] > lo and d["start"] < hi]
    issued = [launches.get(d.get("corr")) or operators.get(d.get("link")) for d in ops]
    points: Dict[int, List[int]] = defaultdict(list)
    for j, at in enumerate(issued):
        if at is not None:
            points[at[0]].append(j)
    stack: List[Tuple[str, ...]] = [()] * len(ops)
    for th, js in points.items():
        found = stacks_at(by_thread.get(th, []), [issued[j][1] for j in js])
        for j, s in zip(js, found):
            stack[j] = s

    range_s: Dict[str, float] = defaultdict(float)
    self_s: Dict[str, float] = defaultdict(float)
    kernel_s: Dict[str, List[float]] = {}
    for d, s in zip(ops, stack):
        dur = min(d["end"], hi) - max(d["start"], lo)
        for name in set(s) - {"window"}:
            range_s[name] += dur
        self_s[s[-1] if s else "(no range)"] += dur
        k = kernel_s.setdefault(d["name"], [0, 0.0])
        k[0] += 1
        k[1] += dur
    intervals = [(max(d["start"], lo), min(d["end"], hi)) for d in ops]
    idle = gaps(intervals, lo, hi)
    host_at_gap = stacks_at(by_thread.get(main_thread, []), [a for a, _ in idle])
    idle_by: Dict[str, float] = defaultdict(float)
    for (a, b), s in zip(idle, host_at_gap):
        idle_by[s[-1] if s else "(no range)"] += b - a
    return {"window_s": hi - lo, "busy_s": union_length(intervals),
            "unattributed_s": sum(min(d["end"], hi) - max(d["start"], lo)
                                  for d, at in zip(ops, issued) if at is None),
            "range_s": dict(range_s), "self_s": dict(self_s),
            "kernel_s": {k: (v[0], v[1]) for k, v in kernel_s.items()},
            "idle_by_host_range": dict(idle_by)}


def breakdown(tr: dict, n: int = 10) -> dict:
    ops = sorted(tr["kernel_s"].items(), key=lambda kv: -kv[1][1])[:n]
    idle = sorted(tr["idle_by_host_range"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[name[:160], s] for name, (_, s) in ops],
            "idle_gaps": [[name, s] for name, s in idle]}


# --------------------------------------------------- the profiler's events

def _ns(e, what: str) -> float:
    if hasattr(e, f"{what}_ns"):
        return getattr(e, f"{what}_ns")()
    if what == "start":
        return e.start_us() * 1e3
    return (e.start_us() + e.duration_us()) * 1e3


def profiler_events(prof) -> Tuple[List[dict], List[dict]]:
    """(host events, device operations) of a finished torch.profiler run,
    times in seconds."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = _ns(e, "start") * 1e-9, _ns(e, "end") * 1e-9
        if e.device_type() == cuda:
            if e.name().startswith(PREFIX) or e.is_user_annotation():
                continue   # a range's shadow on the device timeline, not an operation
            device.append({"name": e.name(), "start": start, "end": end,
                           "corr": e.correlation_id(), "link": e.linked_correlation_id()})
        else:
            host.append({"name": e.name(), "start": start, "end": end,
                         "thread": e.start_thread_id(), "corr": e.correlation_id()})
    return host, device


@contextlib.contextmanager
def wrapped(package: str, targets: Iterable[Tuple[str, str]]):
    """Each (module, attribute) of `package` that exists, replaced by a
    wrapper in a "perfbench.<attribute>" range, restored on exit."""
    import torch
    saved = []
    for mod_name, attr in sorted(set(targets)):
        try:
            mod = importlib.import_module(f"{package}.{mod_name}")
        except ImportError:
            continue
        fn = getattr(mod, attr, None)
        if not callable(fn):
            continue

        def make(fn=fn, label=PREFIX + attr):
            def wrapper(*args, **kwargs):
                with torch.profiler.record_function(label):
                    return fn(*args, **kwargs)
            return wrapper
        setattr(mod, attr, make())
        saved.append((mod, attr, fn))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


class SyncCounter:
    """Counts the synchronising CUDA calls inside each `with counter:`
    block, by torch's sync debug mode ("warn"), which warns on each."""

    def __init__(self):
        self.count = 0

    @contextlib.contextmanager
    def __call__(self):
        import warnings
        import torch
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")
        self.count += sum("synchroniz" in str(w.message) for w in caught)

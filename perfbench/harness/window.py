"""The timed loop: batches from the port's `device_prefetch` (a host
thread that copies each pinned host batch to the card on a side stream,
two ahead), the cell's step, and its outputs copied to the host, as a
labelling pipeline writes its predictions."""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Callable, Dict, List, Optional


class Stream:
    """An endless prefetched cycle over the host batches. `host_batches`
    are dicts of arrays plus an int "index"; the device batch holds the
    arrays on the card."""

    def __init__(self, device_prefetch, host_batches: List[dict], device, depth: int = 2):
        self._it = device_prefetch(itertools.cycle(host_batches), device,
                                   skip=("index",), depth=depth)

    def next(self):
        return next(self._it)

    def close(self) -> None:
        self._it.close()


def _no_range(name: str):
    return contextlib.nullcontext()


def run(stream: Stream, step: Callable, extras: list, *, seconds: Optional[float] = None,
        batches: Optional[int] = None, around_step=contextlib.nullcontext,
        ranges: Callable[[str], contextlib.AbstractContextManager] = _no_range) -> Dict:
    """Run batches until `seconds` have passed (the batch that crosses the
    line completes and counts) or `batches` have completed. Each batch:
    wait for the stream, call `step(batch, extra)` inside `around_step()`,
    copy its output to the host. Returns the window's seconds, each
    completed batch's (index, latency s, wait s) and the last host output
    of each batch index."""
    done, outputs = [], {}
    start = time.perf_counter()
    while True:
        w0 = time.perf_counter()
        with ranges("prefetch_wait"):
            batch, host = stream.next()
        t0 = time.perf_counter()
        with ranges("step"), around_step():
            out = step(batch, extras[host["index"]])
        with ranges("to_host"):
            out = out.cpu()
        t1 = time.perf_counter()
        done.append({"index": host["index"], "latency_s": t1 - t0, "wait_s": t0 - w0})
        outputs[host["index"]] = out
        if (seconds is not None and t1 - start >= seconds) or \
                (batches is not None and len(done) >= batches):
            return {"window_s": t1 - start, "done": done, "outputs": outputs}

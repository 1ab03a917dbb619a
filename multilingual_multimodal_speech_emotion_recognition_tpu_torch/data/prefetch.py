"""Double-buffered device prefetch for the input pipeline.

Counterpart of the JAX package's data/prefetch.py. While the device runs
step N, a host thread assembles batch N+1, pins it and starts its copy to
the device, so the forward does not wait on the host for its inputs. The
bounded queue caps the batches in flight at `depth`.

On a CUDA device the copies run on a side stream of their own. Each batch
records an event there after its copies; the consumer makes its current
stream wait for that event (the per-batch form of `wait_stream`) and
marks every tensor with `record_stream`, so the copy cannot race the
forward and the caching allocator does not reuse a batch's memory while
the forward still reads it. Nothing here reads a value back from the
device: the worker thread pins on the host and queues copies and events.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Sequence, Tuple

import numpy as np
import torch

from ..utils import profiling

_END = object()


def _to_device(host_batch: dict, device: torch.device, skip: Sequence[str],
               stream) -> Tuple[dict, object]:
    """The batch's arrays, less `skip`, as tensors on `device`, and the
    event that marks the end of their copies (None off the card)."""
    out = {}
    for k, v in host_batch.items():
        if k in skip:
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            with torch.cuda.stream(stream):
                t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    if device.type != "cuda":
        return out, None
    event = torch.cuda.Event()
    event.record(stream)
    return out, event


def device_prefetch(host_batches: Iterable[dict], device: torch.device, *,
                    skip: Sequence[str] = (), depth: int = 2
                    ) -> Iterator[Tuple[dict, dict]]:
    """Yields (device_batch, host_batch) pairs, staying `depth` ahead.

    device_batch holds the host batch's arrays, less the keys in `skip`
    (the host keys: labels, example_mask, indices), as tensors on `device`;
    host_batch is the batch as the loader gave it, numpy throughout.
    Exceptions from the iterator or the copies re-raise at the consumer. If
    the consumer abandons the iterator early, the worker notices `stop` on
    its next bounded put and exits."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device=device) if device.type == "cuda" else None
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    failure = []
    stop = threading.Event()

    def try_put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for hb in host_batches:
                if stop.is_set() or not try_put((_to_device(hb, device, skip, stream), hb)):
                    return
        except BaseException as e:  # re-raised at the consumer below
            failure.append(e)
        finally:
            close = getattr(host_batches, "close", None)
            if close is not None:  # a generator: release its decode threads
                close()
            try_put(_END)

    threading.Thread(target=worker, daemon=True, name="device-prefetch").start()
    try:
        while True:
            profiling.count("prefetch.gets")
            profiling.count("prefetch.ready", q.qsize())
            with profiling.span("prefetch.wait"):
                item = q.get()
            if item is _END:
                if failure:
                    raise failure[0]
                return
            (batch, event), hb = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for t in batch.values():
                    t.record_stream(current)
            yield batch, hb
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break

"""One run of one cell: set-up from the seed, the timed window, the traced
window where asked, the check against the reference, and the result."""

from __future__ import annotations

import contextlib
import importlib
import json
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import registry, trace as trace_lib, weights as weights_lib, window as window_lib

PORT = "multilingual_multimodal_speech_emotion_recognition_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "multilingual_multimodal_speech_emotion_recognition_tpu")
TRACED_BATCHES = 16   # four cycles of the 1:2:1 bucket mix


def import_port() -> SimpleNamespace:
    mods = {name: importlib.import_module(f"{PORT}.{path}") for name, path in (
        ("config", "config"), ("model", "models.model"), ("evaluate", "eval.evaluate"),
        ("prefetch", "data.prefetch"), ("residual_stack", "ops.residual_stack"),
        ("quant", "ops.quant"))}
    return SimpleNamespace(**mods)


def model_config(port, cfg: dict):
    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    return port.config.ModelConfig(**tup(cfg["model"]),
                                   audio=port.config.Wav2Vec2Config(**tup(cfg["audio"])),
                                   text=port.config.XLMRConfig(**tup(cfg["text"])))


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that no run may load, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _pinned(batch: dict, index: int, device) -> dict:
    """The batch's arrays as numpy views of page-locked host memory (plain
    host memory off the card), and its index."""
    out = {"index": index}
    for k in ("audio", "audio_mask", "text_ids", "text_mask"):
        t = batch[k].cpu()
        out[k] = (t.pin_memory() if torch.device(device).type == "cuda" else t).numpy()
    return out


def _on_device(host: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in host.items() if k != "index"}


def sample_batches(done: List[dict], meta: List[dict], count: int, seed: int) -> List[int]:
    """Distinct completed batch indices to check, drawn from the seed: one
    of each bucket first (the longest included), the rest at random."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x4348]))
    eligible = sorted({d["index"] for d in done})
    picked: List[int] = []
    for seconds in sorted({meta[i]["bucket_seconds"] for i in eligible}):
        of = [i for i in eligible if meta[i]["bucket_seconds"] == seconds]
        picked.append(int(rng.choice(of)))
    rest = [i for i in eligible if i not in picked]
    extra = max(0, min(count - len(picked), len(rest)))
    picked += [int(i) for i in rng.choice(rest, extra, replace=False)] if extra else []
    return sorted(picked)


def card_line(device) -> dict:
    import subprocess
    info = {"card": torch.cuda.get_device_name(device) if torch.device(device).type == "cuda"
            else "cpu"}
    if torch.device(device).type == "cuda":
        try:
            out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60).stdout.strip().splitlines()
            info["nvidia_smi"] = out[0] if out else "unread"
        except (OSError, subprocess.TimeoutExpired):
            info["nvidia_smi"] = "unread"
    return info


class Cell(SimpleNamespace):
    """A cell set up from its seed: the port, its config, the weights, the
    stream's pinned host batches and their per-batch inputs, the entry."""


def set_up(name: str, seed: int, *, device="cuda", bench: Optional[dict] = None,
           cfg: Optional[dict] = None, workload: Optional[dict] = None) -> Cell:
    """Everything a run of cell `name` needs before its program is built.
    `cfg` and `workload` replace the cell's files (the tests' small sizes)."""
    bench = bench or registry.load_benchmark()
    cfg = cfg or registry.config_file(bench, registry.cell_entry(bench, name)["config"])
    workload = workload or registry.workload_file(name)
    entry = registry.load_module("entries", workload["entry"])
    generator = registry.load_module("traffic", workload["generator"])
    args = workload.get("args", {})
    device = torch.device(device)
    port = import_port()
    mcfg = model_config(port, cfg)
    if device.type == "cuda":
        port.residual_stack.build()
    weights = weights_lib.make_weights(port.model.init_model(mcfg, device="meta"), seed, device)
    made = generator.generate(workload["params"], seed, device, cfg["text"]["vocab_size"])
    extras = entry.prepare(made, seed, device, args)
    meta = []
    for b in made:
        audio_rows, text_rows = entry.rows(b, args)
        meta.append({"bucket_seconds": b["bucket_seconds"], "clips": b["clips"],
                     "audio_rows": audio_rows, "text_rows": text_rows,
                     "samples": b["audio"].shape[1], "text_tokens": b["text_ids"].shape[1]})
    host = [_pinned(b, i, device) for i, b in enumerate(made)]
    return Cell(name=name, seed=seed, device=device, bench=bench, cfg=cfg, workload=workload,
                entry=entry, args=args, port=port, mcfg=mcfg, weights=weights, host=host,
                extras=extras, meta=meta)


def program_of(cell: Cell, control: bool = False):
    """The timed step: the port's entry on the cell's weights, or with
    `control` on its int8 path (ops/quant.quantize_backbones)."""
    params = cell.port.quant.quantize_backbones(cell.weights) if control else cell.weights
    return cell.entry.build(cell.port, cell.mcfg, params, cell.args, cell.device)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             started: Optional[float] = None, bench: Optional[dict] = None,
             cfg: Optional[dict] = None, workload: Optional[dict] = None,
             fault: Optional[Callable] = None, out=sys.stdout, err=sys.stderr) -> dict:
    """Run cell `name` once and return its result object.

    `started` is the process's start on the time.perf_counter clock
    (set-up counts from it). `cfg` and `workload` replace the cell's files
    (the tests' small sizes); `fault(program)` wraps the timed step (the
    tests' planted faults)."""
    started = time.perf_counter() if started is None else started
    bench = bench or registry.load_benchmark()
    metric_entries = registry.metrics_for(bench, name, trace)
    readers = {m: registry.load_module("metrics", m) for m in metric_entries}
    c = set_up(name, seed, device=device, bench=bench, cfg=cfg, workload=workload)
    device, cuda, host, extras, meta = c.device, c.device.type == "cuda", c.host, c.extras, c.meta
    program = program_of(c)
    if fault is not None:
        program = fault(program)
    warmed = set()
    for i, m in enumerate(meta):       # one pass of each bucket's shape
        if m["bucket_seconds"] not in warmed:
            program(_on_device(host[i], device), extras[i]).cpu()
            warmed.add(m["bucket_seconds"])
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - started

    stream = window_lib.Stream(c.port.prefetch.device_prefetch, host, device)
    try:
        win = window_lib.run(stream, program, extras, seconds=seconds)
        traced = None
        if trace:
            traced = _traced_window(stream, program, extras, meta, readers, cuda)
    finally:
        stream.close()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    done = [{**d, **meta[d["index"]]} for d in win["done"]]
    record = {"setup_s": setup_s, "window_s": win["window_s"], "batches": done,
              "config": c.cfg, "args": c.args, "trace": traced}
    metrics = {}
    for mname, m in metric_entries.items():
        value = readers[mname].read(record)
        if value is not None:
            metrics[mname] = {"value": value, "unit": m["unit"]}

    outputs = win["outputs"]
    attempted = sum(d["clips"] for d in done)
    failed = sum(int((~torch.isfinite(outputs[d["index"]]).all(1)).sum()) for d in done)
    del program
    if cuda:
        torch.cuda.empty_cache()
    picked = sample_batches(done, meta, c.workload["check_batches"], seed)
    numbers = judge(c, outputs, references(c, picked), err)
    missing = set(numbers) - set(c.workload["limits"])
    if missing:
        raise KeyError(f"the workload file has no limit for {sorted(missing)}")
    checks = {k: {"value": v, "limit": c.workload["limits"][k]} for k, v in numbers.items()}
    checks["failed_rows"] = {"value": failed, "limit": 0}
    correct = all(x["value"] <= x["limit"] for x in checks.values())

    per_bucket: Dict[str, int] = {}
    for d in done:
        key = f"{d['bucket_seconds']:g}s"
        per_bucket[key] = per_bucket.get(key, 0) + 1
    print(json.dumps({**card_line(device), "seed": seed, "cell": name,
                      "setup_s": setup_s, "window_s": win["window_s"],
                      "batches_per_bucket": per_bucket, "latency_samples": len(done),
                      "memory_peak_bytes": peak}), file=out)
    if traced is not None:
        print(json.dumps({"traced_batches": len(traced["batches"]),
                          "unattributed_s": traced["unattributed_s"],
                          "a1_launches": sum(n for k, (n, _) in traced["kernel_s"].items()
                                             if "residual_stack" in k),
                          "device_s_by_innermost_range": traced["self_s"],
                          "device_s_by_range": traced["range_s"],
                          "host_syncs": traced["host_syncs"]}), file=out)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                         "count": 1, "memory_peak_bytes": peak}}
    if traced is not None:
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = trace_lib.breakdown(traced)
    result["checks"] = checks
    for cname, x in checks.items():
        print(f"check {cname} {x['value']!r} limit {x['limit']!r}", file=err)
    err.flush()
    return result


def _traced_window(stream, program, extras, meta, readers, cuda: bool) -> Optional[dict]:
    """TRACED_BATCHES more batches under torch.profiler, with the metrics'
    ranges around the port's functions and the step's syncs counted (on
    the card; off it the trace holds host events alone)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    targets = [t for r in readers.values() for t in getattr(r, "RANGES", ())]
    counter = trace_lib.SyncCounter() if cuda else None
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with trace_lib.wrapped(PORT, targets):
        with profile(activities=activities) as prof:
            with record_function(trace_lib.WINDOW):
                tw = window_lib.run(stream, program, extras, batches=TRACED_BATCHES,
                                    around_step=counter or contextlib.nullcontext,
                                    ranges=lambda n: record_function(trace_lib.PREFIX + n))
    host, device = trace_lib.profiler_events(prof)
    main = next((e["thread"] for e in host if e["name"] == trace_lib.WINDOW), None)
    reduced = trace_lib.reduce(host, device, main)
    if reduced is None:
        return None
    reduced["batches"] = [{**d, **meta[d["index"]]} for d in tw["done"]]
    reduced["host_syncs"] = counter.count if counter else None
    return reduced


def references(c: Cell, picked: List[int]) -> Dict[int, torch.Tensor]:
    """The reference's outputs for the picked batches, on the host."""
    from .. import reference as ref
    with torch.inference_mode(), ref.plain_fp32():
        return {i: c.entry.reference(ref, c.cfg, c.weights, _on_device(c.host[i], c.device),
                                     c.extras[i], c.args).cpu() for i in picked}


def judge(c: Cell, outputs: Dict[int, torch.Tensor], expected: Dict[int, torch.Tensor],
          err) -> Dict[str, float]:
    """Each batch of `expected` compared with what the program produced for
    it (`outputs`, host tensors by batch index); the worst of each number
    over the batches."""
    worst: Dict[str, float] = {}
    for i, want in expected.items():
        numbers = c.entry.compare(outputs[i], want)
        print(f"check batch {i} ({c.meta[i]['bucket_seconds']:g} s, "
              f"{c.meta[i]['clips']} clips): "
              + ", ".join(f"{k} {v!r}" for k, v in numbers.items()), file=err)
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, float("-inf")), v)
    return worst

"""HTTP serving over export artifacts.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
serving.py, over the port's artifacts (export.py: torch.export programs).
A long-lived process loads each bucket's program once, then answers HTTP
requests with no tracing and none of the model code's Python on the hot
path.

Shape discipline: the programs are fixed-shape (one per audio bucket,
mirroring the data pipeline's bucketing), so the server routes each
request to the smallest bucket that fits, micro-batches concurrent
requests up to the bucket's batch size (or a deadline), and pads the tail:
every device step runs the same program.

Layers:
  ArtifactRouter  single artifact dir OR bucketed dir with index.json ->
                  lazily-loaded ServingModel per bucket + length routing
  BatchingServer  tokenizer + host LID + per-bucket micro-batch queues +
                  worker threads; `submit()` blocks until the answer
  CascadeServer   a student tier that escalates unsure rows to a teacher
  serve()         stdlib ThreadingHTTPServer JSON API:
                    POST /predict   {"audio": [f32...] | "audio_b64":
                                     base64 int16 PCM, "sample_rate": N,
                                     "text": "..."}
                    GET  /healthz   buckets, uptime
                    GET  /stats     request counts + latency quantiles
The programs run on the card unless the router is given another device.
"""

from __future__ import annotations

import base64
import collections
import json
import math
import queue
import socket
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from . import export as ex
from .data.manifest import SIX_CLASS_NAMES as EMOTION_LABELS_6
from .frontend import lid as lid_mod


# ------------------------------------------------------------------ routing

@dataclass
class Bucket:
    dir: Path
    audio_samples: int
    batch_size: int
    device: Optional[Union[str, torch.device]] = None
    _model: Optional[ex.ServingModel] = None
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @property
    def model(self) -> ex.ServingModel:
        with self._lock:
            if self._model is None:
                self._model = ex.ServingModel(self.dir, self.device)
            return self._model


class ArtifactRouter:
    """Length-routes requests over one or many fixed-shape artifacts.

    Accepts either a single-artifact directory (spec.json present) or a
    bucketed export directory (index.json from `export_buckets`). The
    programs run on `device`, the card unless told otherwise."""

    def __init__(self, art_dir: str | Path, *, preload: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        art = Path(art_dir)
        if (art / "index.json").exists():
            idx = json.loads((art / "index.json").read_text())
            self.buckets = [Bucket(art / e["dir"], e["audio_samples"],
                                   e["batch_size"], device)
                            for e in idx["buckets"]]
            self.text_tokens = int(idx["text_tokens"])
            self.sample_rate = int(idx["sample_rate"])
        elif (art / "spec.json").exists():
            spec = json.loads((art / "spec.json").read_text())
            shapes = spec["batch_spec"]
            (b, t), _ = shapes["audio"]
            self.buckets = [Bucket(art, int(t), int(b), device)]
            self.text_tokens = int(shapes["text_ids"][0][1])
            # pre-sample_rate artifacts were all exported at 16 kHz
            self.sample_rate = int(spec.get("sample_rate", 16000))
        else:
            raise FileNotFoundError(
                f"{art}: neither index.json (bucketed export) nor "
                f"spec.json (single artifact) found")
        self.buckets.sort(key=lambda b: b.audio_samples)
        # temperature calibration persisted by the eval CLI (`--calibrate
        # --save_temperature`) and shipped into the artifact dir by the
        # export CLI; logits are divided by it before softmax so served
        # probabilities are calibrated
        self.temperature = 1.0
        cal = art / "calibration.json"
        if cal.exists():
            t = float(json.loads(cal.read_text()).get("temperature", 1.0))
            # T<=0 or NaN would silently corrupt every served prediction
            # (T<0 flips argmax; T=0 yields inf/NaN softmax) — refuse to
            # start rather than serve garbage.
            if not (math.isfinite(t) and t > 0.0):
                raise ValueError(
                    f"{cal}: temperature must be a positive finite "
                    f"number, got {t}")
            self.temperature = t
        if preload:
            for b in self.buckets:
                b.model  # noqa: B018 — force deserialization now

    def route(self, num_samples: int) -> Bucket:
        """Smallest bucket that fits; clips longer than every bucket get
        the largest (the batch is cut to it, like the data pipeline's
        max-duration cut)."""
        for b in self.buckets:
            if num_samples <= b.audio_samples:
                return b
        return self.buckets[-1]

    def spec_summary(self) -> List[Dict]:
        return [{"audio_samples": b.audio_samples,
                 "audio_seconds": b.audio_samples / self.sample_rate,
                 "batch_size": b.batch_size,
                 "loaded": b._model is not None} for b in self.buckets]


# ------------------------------------------------------------- micro-batch

@dataclass
class _Pending:
    audio: np.ndarray            # f32 [T], already resampled to 16 kHz
    text: str
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict] = None
    error: Optional[str] = None
    t_enqueue: float = field(default_factory=time.perf_counter)


class BatchingServer:
    """Micro-batching inference core (HTTP-free, directly testable).

    One worker thread per bucket: it blocks for the first request, then
    drains the queue until the bucket's batch size is reached or
    `max_wait_ms` has passed since the first request, pads the tail rows
    with silence, runs the fixed-shape program once, and distributes the
    per-row results. Under load every device step is a full batch; a lone
    request pays at most max_wait_ms extra latency."""

    def __init__(self, router: ArtifactRouter, *, tokenizer=None,
                 max_wait_ms: float = 15.0, num_labels: Optional[int] = None,
                 labels: Optional[Sequence[str]] = None):
        self.router = router
        self.max_wait_ms = float(max_wait_ms)
        if tokenizer is None:
            from .data.tokenizer import get_tokenizer
            tokenizer = get_tokenizer()
        self.tokenizer = tokenizer
        spec0 = self.router.buckets[0]
        cfg_json, spec_meta = None, {}
        try:
            spec_meta = json.loads((spec0.dir / "spec.json").read_text())
            cfg_json = spec_meta.get("config_json")
        except (OSError, ValueError):
            pass
        # Fail fast on tokenizer/artifact mismatch: an id beyond the
        # artifact's embedding table is a device-side assert on the card.
        self.text_vocab = spec_meta.get("text_vocab_size")
        tok_vocab = getattr(tokenizer, "vocab_size", None)
        if (self.text_vocab is not None and tok_vocab is not None
                and int(tok_vocab) > int(self.text_vocab)):
            raise ValueError(
                f"tokenizer vocab ({tok_vocab}) exceeds the artifact's "
                f"embedding table ({self.text_vocab}) — the artifact was "
                f"exported from a model with a different tokenizer")
        if labels is not None:
            self.labels = list(labels)
        else:
            n = num_labels or spec_meta.get("num_labels")
            if n is None and cfg_json:
                try:
                    n = json.loads(cfg_json)["model"]["num_labels"]
                except (ValueError, KeyError, TypeError):
                    n = None
            self.labels = EMOTION_LABELS_6[:n] if n else None  # lazy infer
        self._queues: Dict[int, queue.Queue] = {
            id(b): queue.Queue() for b in self.router.buckets}
        self._stop = threading.Event()
        self._workers = [
            threading.Thread(target=self._worker, args=(b,), daemon=True,
                             name=f"ser-batch-{b.audio_samples}")
            for b in self.router.buckets]
        self.stats = collections.Counter()
        self._stats_lock = threading.Lock()  # Counter += is not atomic
        self._lat_ms: collections.deque = collections.deque(maxlen=2048)
        self._batch_fill: collections.deque = collections.deque(maxlen=2048)
        self._started = time.time()
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------- submit

    def submit(self, audio: np.ndarray, text: str = "",
               timeout: float = 60.0) -> Dict:
        if self._stop.is_set():
            raise RuntimeError("server shutting down")
        audio = np.asarray(audio, np.float32).reshape(-1)
        if audio.size == 0:
            raise ValueError("empty audio")
        req = _Pending(audio=audio, text=text or "")
        bucket = self.router.route(audio.size)
        with self._stats_lock:   # count on entry so errors/timeouts show too
            self.stats["requests"] += 1
        self._queues[id(bucket)].put(req)
        if self._stop.is_set():
            # close() may have drained the queues before our put landed
            # (stop is set before the drain, so seeing it here is enough);
            # re-drain so this request fails fast instead of waiting out
            # its full timeout in a workerless queue.
            self._fail_stragglers()
        if not req.done.wait(timeout):
            raise TimeoutError("inference timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        self._lat_ms.append(     # deque.append is atomic under the GIL
            (time.perf_counter() - req.t_enqueue) * 1e3)
        return req.result

    def close(self):
        self._stop.set()
        for b in self.router.buckets:
            self._queues[id(b)].put(None)  # wake workers
        for w in self._workers:
            w.join(timeout=5.0)
        self._fail_stragglers()

    def _fail_stragglers(self):
        """Fail-fast any requests that were queued but never picked up, so
        their submit() callers get an immediate error instead of hanging
        until their timeout during shutdown. Idempotent — also re-run from
        submit() when a put races close()'s drain."""
        for b in self.router.buckets:
            q = self._queues[id(b)]
            while True:
                try:
                    r = q.get_nowait()
                except queue.Empty:
                    break
                if r is not None:
                    r.error = "server shutting down"
                    r.done.set()

    # ------------------------------------------------------------- worker

    def _worker(self, bucket: Bucket):
        q = self._queues[id(bucket)]
        while not self._stop.is_set():
            first = q.get()
            if first is None:
                return
            reqs = [first]
            deadline = time.perf_counter() + self.max_wait_ms / 1e3
            while len(reqs) < bucket.batch_size:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    r = q.get(timeout=remaining)
                except queue.Empty:
                    break
                if r is None:
                    self._run_batch(bucket, reqs)
                    return
                reqs.append(r)
            self._run_batch(bucket, reqs)

    def _run_batch(self, bucket: Bucket, reqs: List[_Pending]):
        try:
            out = self._predict(bucket, reqs)
            for i, r in enumerate(reqs):
                r.result = out[i]
        except Exception as e:  # surface to every waiter, keep serving
            for r in reqs:
                r.error = f"{type(e).__name__}: {e}"
            with self._stats_lock:
                self.stats["batch_errors"] += 1
        finally:
            with self._stats_lock:
                self.stats["batches"] += 1
            self._batch_fill.append(len(reqs) / bucket.batch_size)
            for r in reqs:
                r.done.set()

    def _predict(self, bucket: Bucket, reqs: List[_Pending]) -> List[Dict]:
        B, T = bucket.batch_size, bucket.audio_samples
        spec = bucket.model.spec["batch_spec"]
        int16_wire = spec["audio"][1] == "int16"
        # Tail-pad rows keep ONE valid sample of silence, mirroring
        # data/pipeline.py's padded-batch rule. One sample gives zero frames
        # from the conv extractor, so those rows' logits are NaN; the
        # forward couples no rows and only the requests' rows are answered.
        if int16_wire:
            # wire-compact artifact: raw PCM + lengths, ~4x fewer bytes
            # to device; exact round-trip for b64-int16 request payloads
            audio = np.zeros((B, T), np.int16)
            lens = np.ones((B,), np.int32)
            for i, r in enumerate(reqs):
                w = r.audio[:T]
                audio[i, :w.size] = np.clip(
                    np.rint(w * 32768.0), -32768, 32767).astype(np.int16)
                lens[i] = w.size
        else:
            audio = np.zeros((B, T), np.float32)
            mask = np.zeros((B, T), np.float32)
            mask[:, 0] = 1.0
            for i, r in enumerate(reqs):
                w = r.audio[:T]                  # trim over-length (route
                audio[i, :w.size] = w            # already picked max bucket)
                mask[i, :w.size] = 1.0
        texts = [r.text for r in reqs] + [""] * (B - len(reqs))
        ids, tmask = self.tokenizer.encode_batch(texts,
                                                 self.router.text_tokens)
        ids = np.asarray(ids)
        # ahead of the program: on the card an id past the embedding table
        # is a device-side assert that poisons the process's CUDA context
        if self.text_vocab is not None and (ids.max() >= self.text_vocab
                                            or ids.min() < 0):
            bad = int(ids.max()) if ids.max() >= self.text_vocab else int(ids.min())
            raise ValueError(
                f"token id {bad} out of range for the "
                f"artifact's vocab ({self.text_vocab}) — tokenizer/"
                f"artifact mismatch")
        batch = {"audio": audio,
                 "text_ids": np.asarray(ids, np.int32),
                 "text_mask": np.asarray(tmask, np.float32)}
        if int16_wire:
            batch["audio_len"] = lens
        else:
            batch["audio_mask"] = mask
        if "lid_entropy" in spec:                # with_dsp artifact
            ents, _, confs = lid_mod.batch_lid(texts)
            batch["lid_entropy"] = np.asarray(ents, np.float32)
            batch["lid_conf"] = np.asarray(confs, np.float32)
        else:                                    # no-dsp artifact: neutral
            batch["quality_feats"] = np.zeros(
                tuple(spec["quality_feats"][0]), np.float32)
            batch["cond_feats"] = np.zeros(
                tuple(spec["cond_feats"][0]), np.float32)
        out = bucket.model.predict(batch)
        raw_logits = out["logits"].astype(np.float64)
        logits = raw_logits / self.router.temperature
        if self.labels is None:
            self.labels = EMOTION_LABELS_6[:logits.shape[1]]
        mx = logits.max(axis=1, keepdims=True)
        e = np.exp(logits - mx)
        se = e.sum(axis=1, keepdims=True)
        probs = e / se
        # energy OOD score E(x) = -logsumexp(RAW logits) (ops/openmax.py
        # energy_score's semantics): more negative
        # = more in-distribution; production filter threshold lives client-
        # side. Deliberately computed pre-temperature so shipping a new
        # calibration.json never rescales previously-fitted OOD thresholds
        # (temperature calibrates probabilities, not the energy scale).
        rmx = raw_logits.max(axis=1, keepdims=True)
        energies = -(np.log(np.exp(raw_logits - rmx).sum(axis=1)) +
                     rmx.reshape(-1))
        preds = logits.argmax(axis=1)
        unc = out["uncertainty"].reshape(-1)
        results = []
        for i in range(len(reqs)):
            p = probs[i]
            results.append({
                "emotion": self.labels[preds[i]]
                if preds[i] < len(self.labels) else str(int(preds[i])),
                "prediction": int(preds[i]),
                "probabilities": {
                    (self.labels[j] if j < len(self.labels) else str(j)):
                        round(float(p[j]), 6)
                    for j in range(len(p))},
                "confidence": round(float(p.max()), 6),
                "uncertainty": round(float(unc[i]), 6),
                "energy": round(float(energies[i]), 6),
                "bucket_seconds": T / self.router.sample_rate,
            })
        return results

    # -------------------------------------------------------------- stats

    def stats_summary(self) -> Dict:
        lat = np.asarray(self._lat_ms, np.float64)
        fill = np.asarray(self._batch_fill, np.float64)
        q = (lambda a, p: float(np.percentile(a, p)) if a.size else None)
        return {
            "requests": int(self.stats["requests"]),
            "batches": int(self.stats["batches"]),
            "batch_errors": int(self.stats["batch_errors"]),
            "latency_ms": {"p50": q(lat, 50), "p95": q(lat, 95),
                           "p99": q(lat, 99)},
            "mean_batch_fill": float(fill.mean()) if fill.size else None,
            "temperature": self.router.temperature,
            "uptime_s": round(time.time() - self._started, 1),
        }


# ------------------------------------------------------------ cascade tier

class CascadeServer:
    """Two-tier serving: the small (distilled) STUDENT answers every
    request; rows the student is unsure about escalate to the TEACHER.

    The student is a smaller (distilled) model: at a typical ~10-20%
    escalation rate the average device cost per request approaches the
    student's, while hard/out-of-distribution clips still get flagship
    answers. Escalation happens in the caller's thread, so concurrent
    escalations micro-batch on the teacher exactly like first-tier traffic
    — both tiers keep their fixed-shape programs (no per-row routing
    inside one batch).

    Escalates when student confidence (calibrated max-prob) is below
    `confidence_threshold`, or — with `energy_threshold` set — when the
    raw-logit energy OOD score is ABOVE it (less negative = more
    OOD-like; thresholds fitted on the eval CLI's `--predictions_out`
    output transfer unchanged, since both surfaces report raw-logit
    energy).

    Duck-types the BatchingServer protocol (`submit`/`close`/
    `stats_summary`/`router`), so `make_http_server`/`serve` run it
    unmodified."""

    def __init__(self, student: BatchingServer, teacher: BatchingServer, *,
                 confidence_threshold: float = 0.8,
                 energy_threshold: Optional[float] = None):
        self.student = student
        self.teacher = teacher
        self.confidence_threshold = float(confidence_threshold)
        self.energy_threshold = (None if energy_threshold is None
                                 else float(energy_threshold))
        self.router = student.router       # decode SR + /healthz spec
        self._started = time.time()
        self.stats = collections.Counter()
        self._stats_lock = threading.Lock()

    def _should_escalate(self, res: Dict) -> bool:
        if res["confidence"] < self.confidence_threshold:
            return True
        return (self.energy_threshold is not None
                and res["energy"] > self.energy_threshold)

    def submit(self, audio: np.ndarray, text: str = "",
               timeout: float = 60.0) -> Dict:
        res = self.student.submit(audio, text, timeout)
        with self._stats_lock:
            self.stats["requests"] += 1
        if self._should_escalate(res):
            out = self.teacher.submit(audio, text, timeout)
            out = dict(out)
            out["escalated"] = True
            out["student_confidence"] = res["confidence"]
            with self._stats_lock:
                self.stats["escalations"] += 1
            return out
        res = dict(res)
        res["escalated"] = False
        return res

    def close(self):
        self.student.close()
        self.teacher.close()

    def stats_summary(self) -> Dict:
        with self._stats_lock:
            n = int(self.stats["requests"])
            esc = int(self.stats["escalations"])
        return {
            "requests": n,
            "escalations": esc,
            "escalation_rate": round(esc / n, 4) if n else None,
            "confidence_threshold": self.confidence_threshold,
            "energy_threshold": self.energy_threshold,
            "student": self.student.stats_summary(),
            "teacher": self.teacher.stats_summary(),
            "uptime_s": round(time.time() - self._started, 1),
        }


# ---------------------------------------------------------------- HTTP API

def _decode_audio(payload: Dict, target_sr: int) -> np.ndarray:
    if "audio_b64" in payload:
        raw = base64.b64decode(payload["audio_b64"])
        wave = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif "audio" in payload:
        wave = np.asarray(payload["audio"], np.float32)
    else:
        raise ValueError("request needs 'audio' (float list) or "
                         "'audio_b64' (base64 little-endian int16 PCM)")
    sr = int(payload.get("sample_rate", target_sr))
    if sr != target_sr:
        from .data.audio_io import resample_host
        wave = resample_host(wave, sr, target_sr)
    return wave


def make_http_server(core: BatchingServer, host: str = "127.0.0.1",
                     port: int = 8080):
    """Build (but don't start) the ThreadingHTTPServer bound to the core.

    ThreadingHTTPServer sets daemon_threads=True, which makes socketserver
    skip tracking handler threads entirely — server_close() joins NOTHING.
    The subclass counts in-flight handlers itself so serve() can actually
    wait for them (bounded) before tearing down the batching core."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class DrainableServer(ThreadingHTTPServer):
        # keep daemon_threads=True so a handler wedged on a dead client
        # socket can never block process exit; drain via wait_inflight.
        # socketserver's listen backlog is 5: when more clients than that
        # connect at once (urllib opens a connection a request), the ones
        # over it are reset before accept() takes them
        request_queue_size = socket.SOMAXCONN
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._inflight = 0
            self._inflight_cv = threading.Condition()

        def process_request_thread(self, request, client_address):
            with self._inflight_cv:
                self._inflight += 1
            try:
                super().process_request_thread(request, client_address)
            finally:
                with self._inflight_cv:
                    self._inflight -= 1
                    self._inflight_cv.notify_all()

        def wait_inflight(self, timeout: float) -> bool:
            """Block until every in-flight handler finished (True) or the
            timeout elapsed with handlers still running (False)."""
            deadline = time.monotonic() + timeout
            with self._inflight_cv:
                while self._inflight:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    self._inflight_cv.wait(remaining)
            return True

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; stats endpoint replaces it
            pass

        def _send(self, code: int, obj: Dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "buckets": core.router.spec_summary(),
                    "uptime_s": round(time.time() - core._started, 1)})
            elif self.path == "/stats":
                self._send(200, core.stats_summary())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                wave = _decode_audio(payload, core.router.sample_rate)
                res = core.submit(wave, payload.get("text", ""),
                                  timeout=float(payload.get("timeout", 60)))
                self._send(200, res)
            except (ValueError, KeyError) as e:
                self._send(400, {"error": str(e)})
            except TimeoutError as e:
                self._send(503, {"error": str(e)})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return DrainableServer((host, port), Handler)


def serve(art_dir: str, *, host: str = "127.0.0.1", port: int = 8080,
          max_wait_ms: float = 15.0, preload: bool = True,
          tokenizer=None, drain_timeout: float = 30.0,
          cascade_teacher_dir: Optional[str] = None,
          confidence_threshold: float = 0.8,
          energy_threshold: Optional[float] = None,
          device: Optional[Union[str, torch.device]] = None) -> None:
    """Blocking entry point of the port's cli/serve.py; the programs run on
    `device`, the card unless told otherwise.

    With `cascade_teacher_dir` set, `art_dir` is the STUDENT artifact and
    low-confidence requests escalate to the teacher (CascadeServer).

    Graceful drain on SIGTERM (the signal schedulers/orchestrators send
    before reclaiming the pod): stop accepting connections, wait (bounded
    by drain_timeout) for in-flight handler threads to finish, run the
    workers' final partial batches, then fail any never-picked-up queue
    stragglers fast. Mirrors the train loop's PreemptionGuard
    (train/loop.py)."""
    import signal

    router = ArtifactRouter(art_dir, preload=preload, device=device)
    core = BatchingServer(router, tokenizer=tokenizer,
                          max_wait_ms=max_wait_ms)
    if cascade_teacher_dir:
        t_router = ArtifactRouter(cascade_teacher_dir, preload=preload,
                                  device=device)
        teacher = BatchingServer(t_router, tokenizer=tokenizer,
                                 max_wait_ms=max_wait_ms)
        core = CascadeServer(core, teacher,
                             confidence_threshold=confidence_threshold,
                             energy_threshold=energy_threshold)
    httpd = make_http_server(core, host, port)

    def _term(signum, frame):
        # shutdown() blocks until serve_forever exits, and we're IN
        # serve_forever on this thread — hand it to a helper thread
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    prev = None
    try:
        prev = signal.signal(signal.SIGTERM, _term)
    except ValueError:          # not the main thread (tests): no handler
        pass
    print(f"serving {art_dir} on http://{host}:{port} "
          f"({len(router.buckets)} bucket(s))", flush=True)
    try:
        httpd.serve_forever()
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        httpd.server_close()    # closes the listening socket only
        drained = httpd.wait_inflight(drain_timeout)
        core.close()
        print("drained, exiting" if drained else
              f"drain timeout ({drain_timeout}s) with handlers still "
              f"in flight, exiting", flush=True)

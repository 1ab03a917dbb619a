"""The port's HTTP serving (serving.py) over its export artifacts, on the
CPU: the cases of tests/test_serving.py on port artifacts (length routing,
micro-batching, errors, shutdown, the HTTP API, calibration, the cascade
tier), and the same requests to the JAX package's BatchingServer over its
artifacts of the same parameters: the same emotion, probabilities and
energy within 1e-4 (f32 summation order only).

As in tests/test_serving.py, the tiny model here has the front-end DSP off
in its config; the artifacts take the DSP's batch (LID scalars, no
features) and run the model on zero features."""

import base64
import functools
import json
import threading
import time
import urllib.request

import numpy as np
import jax
import pytest

from multilingual_multimodal_speech_emotion_recognition_tpu import (
    config as jcfg, export as jex, serving as jserving)
from multilingual_multimodal_speech_emotion_recognition_tpu.data import (
    tokenizer as jtok)
from multilingual_multimodal_speech_emotion_recognition_tpu.models import model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
    config as tcfg, export as ex, serving, weights)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data.tokenizer import (
    HashTokenizer)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.frontend import (
    lid as lid_mod)

from test_model import tiny_config

# the server is on the loopback: no proxy
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))
RNG = np.random.default_rng(11)
BUCKETS = [(0.2, 2), (0.4, 2)]
TOL = 1e-4


def port_export(seed, out, **kw):
    cfg = tiny_config()
    params = jax.tree.map(np.asarray, jm.init_model(jax.random.key(seed), cfg))
    port_cfg = tcfg.from_json(jcfg.to_json(cfg))
    ex.export_buckets(weights.params_from_jax(params, port_cfg, device="cpu"), port_cfg, out,
                      text_tokens=8, with_dsp=True, device="cpu", **kw)
    return cfg, params


@pytest.fixture(scope="module")
def bucketed_artifact(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve") / "export"
    cfg, params = port_export(0, out, buckets=BUCKETS)
    return out, cfg, params


@pytest.fixture(scope="module")
def teacher_artifact(tmp_path_factory):
    """A second ('teacher') artifact from another seed, so that cascade
    answers are told apart from the student's."""
    out = tmp_path_factory.mktemp("serve_teacher") / "export"
    cfg, params = port_export(99, out, buckets=BUCKETS)
    return out, cfg, params


@functools.lru_cache(maxsize=None)
def _router(art):
    """One router per artifact for the module: each bucket's program loads
    once (its own calibration test makes a fresh one)."""
    return serving.ArtifactRouter(art, device="cpu")


def _core(art, max_wait_ms=5.0, tokenizer=None, router=None):
    return serving.BatchingServer(router or _router(art),
                                  tokenizer=tokenizer or HashTokenizer(vocab_size=100),
                                  max_wait_ms=max_wait_ms)


# ------------------------------------------------------------------ routing

def test_router_routes_by_length_and_trims(tmp_path):
    # routing needs only index.json: models load lazily
    (tmp_path / "index.json").write_text(json.dumps({
        "buckets": [
            {"dir": "a", "audio_seconds": 0.2, "audio_samples": 3200, "batch_size": 4},
            {"dir": "b", "audio_seconds": 0.4, "audio_samples": 6400, "batch_size": 2},
        ], "text_tokens": 8, "sample_rate": 16000}))
    router = serving.ArtifactRouter(tmp_path, device="cpu")
    assert router.route(100).audio_samples == 3200
    assert router.route(3200).audio_samples == 3200
    assert router.route(3201).audio_samples == 6400
    # longer than every bucket -> the largest (the batch is cut to it)
    assert router.route(100_000).audio_samples == 6400
    assert router.text_tokens == 8


def test_router_rejects_non_artifact_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        serving.ArtifactRouter(tmp_path, device="cpu")


# ------------------------------------------------------------- micro-batch

def test_submit_matches_direct_serving_model(bucketed_artifact):
    art, _, _ = bucketed_artifact
    core = _core(art)
    try:
        wave = RNG.standard_normal(2500).astype(np.float32) * 0.1
        text = "I am so happy today"
        res = core.submit(wave, text, timeout=300)

        # rebuild the exact padded batch the server ran and compare
        bucket = core.router.route(wave.size)
        B, T = bucket.batch_size, bucket.audio_samples
        audio = np.zeros((B, T), np.float32)
        mask = np.zeros((B, T), np.float32)
        mask[:, 0] = 1.0
        audio[0, :wave.size] = wave
        mask[0, :wave.size] = 1.0
        texts = [text] + [""] * (B - 1)
        ids, tmask = core.tokenizer.encode_batch(texts, 8)
        ents, _, confs = lid_mod.batch_lid(texts)
        out = bucket.model.predict({
            "audio": audio, "audio_mask": mask,
            "text_ids": np.asarray(ids, np.int32),
            "text_mask": np.asarray(tmask, np.float32),
            "lid_entropy": np.asarray(ents, np.float32),
            "lid_conf": np.asarray(confs, np.float32)})
        logits = out["logits"][0].astype(np.float64)
        e = np.exp(logits - logits.max())
        want_probs = e / e.sum()

        assert res["prediction"] == int(logits.argmax())
        assert res["emotion"] == serving.EMOTION_LABELS_6[logits.argmax()]
        want_energy = -(np.log(np.exp(logits - logits.max()).sum()) + logits.max())
        assert res["energy"] == pytest.approx(want_energy, abs=1e-5)
        got_probs = np.asarray([res["probabilities"][k] for k in serving.EMOTION_LABELS_6[:4]])
        np.testing.assert_allclose(got_probs, want_probs, atol=1e-5)
        assert abs(sum(res["probabilities"].values()) - 1.0) < 1e-4
        assert res["bucket_seconds"] == pytest.approx(0.2)
    finally:
        core.close()


def test_same_requests_as_the_jax_server(bucketed_artifact, tmp_path):
    """JAX's BatchingServer over its artifacts of the same parameters:
    requests one at a time (one row a batch) over both buckets, the same
    answers."""
    art, cfg, params = bucketed_artifact
    jex.export_buckets(params, cfg, tmp_path / "jax", buckets=BUCKETS, text_tokens=8,
                       with_dsp=True)
    jcore = jserving.BatchingServer(jserving.ArtifactRouter(tmp_path / "jax"),
                                    tokenizer=jtok.HashTokenizer(vocab_size=100),
                                    max_wait_ms=5.0)
    core = _core(art)
    try:
        for n, text in ((2500, "so happy today"), (6000, "angry words"), (900, ""),
                        (9000, "a long clip trimmed to the largest bucket")):
            wave = RNG.standard_normal(n).astype(np.float32) * 0.1
            got, want = core.submit(wave, text, timeout=300), jcore.submit(wave, text,
                                                                           timeout=300)
            assert got["emotion"] == want["emotion"] and got["prediction"] == want["prediction"]
            assert got["bucket_seconds"] == want["bucket_seconds"]
            assert set(got["probabilities"]) == set(want["probabilities"])
            for k, p in want["probabilities"].items():
                assert got["probabilities"][k] == pytest.approx(p, abs=TOL)
            for k in ("energy", "confidence", "uncertainty"):
                assert got[k] == pytest.approx(want[k], abs=TOL), k
    finally:
        core.close()
        jcore.close()


def test_concurrent_requests_coalesce_into_one_batch(bucketed_artifact):
    art, _, _ = bucketed_artifact
    core = _core(art, max_wait_ms=500.0)
    try:
        waves = [RNG.standard_normal(2000).astype(np.float32) * 0.1 for _ in range(2)]
        results = [None, None]

        def run(i):
            results[i] = core.submit(waves[i], f"text {i}", timeout=300)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(r is not None for r in results)
        s = core.stats_summary()
        # both rode the same device step: one batch, fill 2/2
        assert s["batches"] == 1
        assert s["mean_batch_fill"] == pytest.approx(1.0)
        assert s["requests"] == 2
    finally:
        core.close()


def test_batch_error_propagates_and_server_survives(bucketed_artifact):
    art, _, _ = bucketed_artifact
    core = _core(art)
    try:
        bucket = core.router.buckets[0]
        orig = bucket.model.predict
        bucket.model.predict = lambda b: (_ for _ in ()).throw(RuntimeError("injected"))
        with pytest.raises(RuntimeError, match="injected"):
            core.submit(np.ones(1000, np.float32), "x", timeout=300)
        bucket.model.predict = orig
        res = core.submit(np.ones(1000, np.float32) * 0.01, "x", timeout=300)
        assert "emotion" in res
        assert core.stats_summary()["batch_errors"] == 1
    finally:
        core.close()


def test_empty_audio_rejected(bucketed_artifact):
    art, _, _ = bucketed_artifact
    core = _core(art)
    try:
        with pytest.raises(ValueError):
            core.submit(np.zeros(0, np.float32))
    finally:
        core.close()


# ---------------------------------------------------------------- HTTP API

@pytest.fixture()
def http_server(bucketed_artifact):
    art, _, _ = bucketed_artifact
    core = _core(art)
    httpd = serving.make_http_server(core, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    core.close()
    thread.join(timeout=10)


def _post(url, payload):
    payload = dict(payload)
    payload.setdefault("timeout", 300)
    req = urllib.request.Request(url + "/predict", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with OPENER.open(req, timeout=360) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_predict_float_and_b64_agree(http_server):
    wave = (RNG.standard_normal(2000) * 0.1).astype(np.float32)
    code, res = _post(http_server, {"audio": wave.tolist(), "text": "hello there"})
    assert code == 200 and "emotion" in res
    pcm = np.clip(wave * 32768.0, -32768, 32767).astype("<i2")
    code2, res2 = _post(http_server, {"audio_b64": base64.b64encode(pcm.tobytes()).decode(),
                                      "text": "hello there"})
    assert code2 == 200
    # int16 quantization of the wave is ~1e-5; predictions agree
    assert res2["prediction"] == res["prediction"]
    assert res2["confidence"] == pytest.approx(res["confidence"], abs=1e-2)


def test_http_resamples_other_rates(http_server):
    wave = (RNG.standard_normal(1000) * 0.1).astype(np.float32)
    code, res = _post(http_server, {"audio": wave.tolist(), "sample_rate": 8000, "text": ""})
    assert code == 200 and "emotion" in res


def test_http_bad_request_and_unknown_path(http_server):
    code, res = _post(http_server, {"text": "no audio key"})
    assert code == 400 and "error" in res
    with OPENER.open(http_server + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok"
    assert len(health["buckets"]) == 2
    with OPENER.open(http_server + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert {"requests", "batches", "latency_ms"} <= set(stats)
    with pytest.raises(urllib.error.HTTPError) as err:
        OPENER.open(http_server + "/nowhere", timeout=30)
    assert err.value.code == 404


def test_http_burst_of_new_connections_is_not_reset(http_server):
    """64 clients at once, each POST on a new connection (as urllib makes
    them; a request without audio, answered 400 at once): with
    socketserver's default listen backlog of 5 some of them are reset
    before the server accepts them."""
    failures = []

    def client():
        for _ in range(40):
            try:
                code, _ = _post(http_server, {"text": "no audio key"})
                assert code == 400
            except OSError as e:
                failures.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client) for _ in range(64)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert failures == []


# ------------------------------------------------------- vocab mismatch

def test_mismatched_tokenizer_rejected_at_startup(bucketed_artifact):
    # the artifact's table has 100 rows; a full-vocab tokenizer's ids past
    # it would be a device-side assert on the card: refuse to start
    art, _, _ = bucketed_artifact
    with pytest.raises(ValueError, match="vocab"):
        _core(art, tokenizer=HashTokenizer(vocab_size=250002))


@pytest.mark.parametrize("shift", [1000, -1000], ids=["past_the_table", "negative"])
def test_out_of_range_token_ids_rejected_per_batch(bucketed_artifact, shift):
    """A tokenizer that under-reports its vocab passes the startup check;
    the per-batch id-range guard, ahead of the program, is the backstop."""
    art, _, _ = bucketed_artifact

    class LyingTokenizer(HashTokenizer):
        def __init__(self):
            super().__init__(vocab_size=50)

        def encode_batch(self, texts, max_len):
            ids, mask = super().encode_batch(texts, max_len)
            return np.asarray(ids) + shift, mask

    core = _core(art, tokenizer=LyingTokenizer())
    try:
        with pytest.raises(RuntimeError, match="out of range"):
            core.submit(np.ones(1000, np.float32) * 0.01, "definitely out of range",
                        timeout=300)
    finally:
        core.close()


def test_server_drives_int16_wire_artifact(tmp_path):
    # the server reads the wire from the spec and ships PCM + lengths; a
    # b64-int16 request round-trips exactly through the quantisation
    port_export(0, tmp_path / "i16", buckets=[(0.2, 2)], wire="int16")
    core = _core(tmp_path / "i16")
    try:
        pcm = RNG.integers(-3000, 3000, 2500).astype(np.int16)
        wave = pcm.astype(np.float32) / 32768.0
        res = core.submit(wave, "hello", timeout=300)
        assert "emotion" in res and np.isfinite(res["confidence"])

        bucket = core.router.buckets[0]
        ids, tmask = core.tokenizer.encode_batch(["hello", ""], 8)
        ents, _, confs = lid_mod.batch_lid(["hello", ""])
        audio = np.zeros((2, bucket.audio_samples), np.int16)
        audio[0, :pcm.size] = pcm
        out = bucket.model.predict({
            "audio": audio, "audio_len": np.array([pcm.size, 1], np.int32),
            "text_ids": np.asarray(ids, np.int32),
            "text_mask": np.asarray(tmask, np.float32),
            "lid_entropy": np.asarray(ents, np.float32),
            "lid_conf": np.asarray(confs, np.float32)})
        assert res["prediction"] == int(out["logits"][0].argmax())
        logits = out["logits"][0].astype(np.float64)
        want_energy = -(np.log(np.exp(logits - logits.max()).sum()) + logits.max())
        assert res["energy"] == pytest.approx(want_energy, abs=1e-5)
    finally:
        core.close()


# ---------------------------------------------------------------- shutdown

def test_close_fails_queued_stragglers_fast(bucketed_artifact):
    """Requests still queued after the workers exit fail at once."""
    art, _, _ = bucketed_artifact
    core = _core(art)
    core.close()
    bucket = core.router.buckets[0]
    req = serving._Pending(audio=np.zeros(10, np.float32), text="")
    core._queues[id(bucket)].put(req)
    core.close()                      # idempotent; drains the straggler
    assert req.done.is_set()
    assert req.error == "server shutting down"


@pytest.mark.parametrize("race", [False, True], ids=["after_close", "racing_close"])
def test_submit_fails_fast_once_closed(bucketed_artifact, monkeypatch, race):
    """submit() refuses work once close() ran, also when close() lands
    between submit's entry check and its enqueue."""
    art, _, _ = bucketed_artifact
    core = _core(art)
    if race:
        orig_route = core.router.route

        def route_then_close(n):
            b = orig_route(n)
            core.close()
            return b

        monkeypatch.setattr(core.router, "route", route_then_close)
    else:
        core.close()
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="shutting down"):
        core.submit(np.zeros(100, np.float32), timeout=30.0)
    assert time.perf_counter() - t0 < 10.0


def test_http_server_waits_for_inflight_handlers(bucketed_artifact):
    """The server counts its in-flight handlers, so that serve()'s drain
    waits for them."""
    art, _, _ = bucketed_artifact
    core = _core(art, max_wait_ms=300.0)  # hold batches open: a slow handler
    httpd = serving.make_http_server(core, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert httpd.wait_inflight(0.1)
        wave = (RNG.standard_normal(1000) * 0.1).astype(np.float32)
        t = threading.Thread(target=_post, args=(url, {"audio": wave.tolist()}), daemon=True)
        t.start()
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline:
            with httpd._inflight_cv:
                if httpd._inflight:
                    break
            time.sleep(0.005)
        else:
            pytest.fail("request never became in-flight")
        assert not httpd.wait_inflight(0.05)
        assert httpd.wait_inflight(30.0)
        t.join(timeout=10.0)
        assert not t.is_alive()
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.close()


# ------------------------------------------------------------- calibration

def test_calibration_temperature_applied(bucketed_artifact):
    """calibration.json in the artifact dir scales the served logits:
    probabilities flatten at T > 1, the argmax stays, the energy (raw
    logits) does not move, and /stats reports the temperature."""
    art, _, _ = bucketed_artifact
    wave = RNG.standard_normal(2500).astype(np.float32) * 0.1
    text = "calibration check"
    core = _core(art)
    try:
        base = core.submit(wave, text, timeout=300)
        assert core.stats_summary()["temperature"] == 1.0
    finally:
        core.close()

    T = 4.0
    (art / "calibration.json").write_text(json.dumps({"temperature": T}))
    try:
        core = _core(art, router=serving.ArtifactRouter(art, device="cpu"))
        try:
            calib = core.submit(wave, text, timeout=300)
            assert core.stats_summary()["temperature"] == T
        finally:
            core.close()
    finally:
        (art / "calibration.json").unlink()

    assert calib["prediction"] == base["prediction"]
    base_p = np.asarray([base["probabilities"][k] for k in serving.EMOTION_LABELS_6[:4]])
    logits = np.log(base_p)
    e = np.exp(logits / T - (logits / T).max())
    got = np.asarray([calib["probabilities"][k] for k in serving.EMOTION_LABELS_6[:4]])
    np.testing.assert_allclose(got, e / e.sum(), atol=2e-4)
    assert calib["energy"] == pytest.approx(base["energy"], abs=1e-5)
    assert calib["confidence"] < base["confidence"]


@pytest.mark.parametrize("bad", [0.0, -2.0, float("nan")])
def test_bad_calibration_temperature_refused(bucketed_artifact, tmp_path, bad):
    art, _, _ = bucketed_artifact
    (tmp_path / "index.json").write_text((art / "index.json").read_text())
    (tmp_path / "calibration.json").write_text(json.dumps({"temperature": bad}))
    with pytest.raises(ValueError, match="temperature"):
        serving.ArtifactRouter(tmp_path, device="cpu")


# ----------------------------------------------------------------- cascade

@pytest.mark.parametrize("threshold,escalated", [(0.0, False), (1.01, True)])
def test_cascade_escalates_on_low_confidence(bucketed_artifact, teacher_artifact,
                                             threshold, escalated):
    """Below the bar the student answers; above it every request escalates
    and the answer is the teacher tier's own."""
    s_art, t_art = bucketed_artifact[0], teacher_artifact[0]
    wave = RNG.standard_normal(2500).astype(np.float32) * 0.1
    text = "cascade check"
    answers = {}
    for tier, art in (("student", s_art), ("teacher", t_art)):
        direct = _core(art)
        try:
            answers[tier] = direct.submit(wave, text, timeout=300)
        finally:
            direct.close()
    assert answers["student"]["probabilities"] != answers["teacher"]["probabilities"]

    cas = serving.CascadeServer(_core(s_art), _core(t_art), confidence_threshold=threshold)
    try:
        res = cas.submit(wave, text, timeout=300)
        assert res["escalated"] is escalated
        want = answers["teacher" if escalated else "student"]
        assert res["probabilities"] == want["probabilities"]
        st = cas.stats_summary()
        assert st["requests"] == 1 and st["escalations"] == int(escalated)
        assert st["escalation_rate"] == float(escalated)
        assert st["student"]["requests"] == 1
        assert st["teacher"]["requests"] == int(escalated)
        if escalated:
            assert res["student_confidence"] == answers["student"]["confidence"]
    finally:
        cas.close()


@pytest.mark.parametrize("offset,escalated", [(1.0, False), (-1.0, True)])
def test_cascade_energy_threshold(bucketed_artifact, teacher_artifact, offset, escalated):
    """The energy gate escalates OOD-looking clips even when the student
    is confident: with the bar just above / below the observed energy the
    same request flips between tiers."""
    s_art, t_art = bucketed_artifact[0], teacher_artifact[0]
    wave = RNG.standard_normal(2500).astype(np.float32) * 0.1
    probe = _core(s_art)
    try:
        energy = probe.submit(wave, "x", timeout=300)["energy"]
    finally:
        probe.close()
    cas = serving.CascadeServer(_core(s_art), _core(t_art), confidence_threshold=0.0,
                                energy_threshold=energy + offset)
    try:
        assert cas.submit(wave, "x", timeout=300)["escalated"] is escalated
    finally:
        cas.close()


def test_cascade_serves_http(bucketed_artifact, teacher_artifact):
    """The cascade duck-types the core: the HTTP server runs it as it is
    and /stats reports both tiers."""
    import http.client

    cas = serving.CascadeServer(_core(bucketed_artifact[0]), _core(teacher_artifact[0]),
                                confidence_threshold=1.01)
    httpd = serving.make_http_server(cas, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=300)
        wave = (RNG.standard_normal(2000) * 0.1).astype(np.float32)
        conn.request("POST", "/predict", json.dumps(
            {"audio": wave.tolist(), "sample_rate": 16000, "text": "hi"}))
        res = json.loads(conn.getresponse().read())
        assert res["escalated"] is True
        conn.request("GET", "/stats")
        st = json.loads(conn.getresponse().read())
        assert st["escalations"] == 1
        assert st["teacher"]["requests"] == 1
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        cas.close()

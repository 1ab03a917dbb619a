"""The port's confidence fusion, cross-lingual and loss-integration modules
(research/), its legacy classifier heads (models/classifier.py) and its
utils/debug.py and utils/profiling.py, against the JAX package's on the
CPU: the same numpy inputs from a seed and JAX's parameters carried across
by the weight bridge, f32, rtol = atol = 1e-5 (exact where the arithmetic
is host numpy or comparisons). gradient_reversal's gradient through the
language head is held against jax.grad. Also the four entry points that
used to default to the CPU, which now resolve to the card."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.models import classifier as jcls
from multilingual_multimodal_speech_emotion_recognition_tpu.research import (
    confidence_fusion as jcf, cross_lingual as jcl, loss_integration as jli)
from multilingual_multimodal_speech_emotion_recognition_tpu.utils import (
    debug as jdebug, profiling as jprof)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import robustness as trob
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import classifier as tcls
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.research import (
    confidence_fusion as tcf, cross_lingual as tcl, dual_gate_ood as tdg,
    loss_integration as tli, temporal as ttm)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train.loop import step_seed
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import (
    debug as tdebug, profiling as tprof)

from torch_port_helpers import META, assert_close, bridge, j, one_torch_thread, perturb, t

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
RNG = np.random.default_rng(17)
B = 6


def _features():
    """Raw confidence scalars that trip every clamp on some row."""
    r = RNG.random((14, B)).astype(np.float32)
    cols = dict(snr_db=r[0] * 30.0, speech_prob=r[1], clipping_percent=r[2] * 50,
                denoise_gain_db=r[3] * 20, asr_conf_segment=r[4], lid_entropy=r[5] * 2.5,
                text_reliability_score=r[6], conditioning_applied=(r[7] > 0.5),
                quality_gates_passed=(r[8] > 0.3), audio_text_similarity=r[9],
                boundary_confidence=r[10], segment_emotion_consistency=r[11],
                previous_segment_confidence=r[12], emotion_transition_probability=r[13])
    # row 0: both unreliable (rule 5)
    cols["snr_db"][0], cols["speech_prob"][0] = 2.0, 0.3
    cols["asr_conf_segment"][0], cols["lid_entropy"][0] = 0.1, 2.2
    return (jcf.ConfidenceFeatures(**{k: jnp.asarray(v) for k, v in cols.items()}),
            tcf.ConfidenceFeatures(**{k: torch.from_numpy(np.array(v)) for k, v in cols.items()}))


def test_confidence_vector_and_defaults_match_jax():
    jf, tf = _features()
    assert_close(tf.to_array(), jf.to_array(), 0)
    want = jcf.default_confidence_features(4).to_array()
    assert_close(tcf.default_confidence_features(4, device="cpu").to_array(), want, 0)


def test_gating_and_policy_clamps_match_jax():
    jf, tf = _features()
    jp = perturb(jcf.init_dynamic_gating(jax.random.key(0)), RNG)
    tp = bridge(jp, tcf.init_dynamic_gating(device="meta"))
    conf = RNG.standard_normal((B, 14)).astype(np.float32)
    ja, jt = jcf.dynamic_gating(jax.tree.map(jnp.asarray, jp), j(conf))
    ta, tt = tcf.dynamic_gating(tp, t(conf))
    assert_close(ta, ja, TOL)
    assert_close(tt, jt, TOL)
    a, b = jcf.policy_clamps(ja, jt, jf)
    c, d = tcf.policy_clamps(ta, tt, tf)
    assert_close(c, a, TOL)
    assert_close(d, b, TOL)
    # a fresh gate starts at equal weights, as JAX's
    fresh = tcf.init_dynamic_gating(device="cpu")
    assert torch.equal(tcf.dynamic_gating(fresh, t(conf))[0], torch.full((B, 1), 0.5))


def test_adaptive_fusion_matches_jax():
    jf, tf = _features()
    jp = perturb(jcf.init_adaptive_fusion(jax.random.key(1), audio_dim=24, text_dim=40,
                                          proj_dim=32), RNG)
    tp = bridge(jp, tcf.init_adaptive_fusion(24, 40, 32, device="meta"))
    a = RNG.standard_normal((B, 24)).astype(np.float32)
    x = RNG.standard_normal((B, 40)).astype(np.float32)
    want = jcf.adaptive_fusion(jax.tree.map(jnp.asarray, jp), j(a), j(x), jf)
    got = tcf.adaptive_fusion(tp, t(a), t(x), tf)
    assert_close(got[0], want[0], TOL)
    assert_close(got[1], want[1], TOL)
    for k in ("audio_weight", "text_weight"):
        assert_close(got[2][k], want[2][k], TOL)


def test_gradient_reversal_and_language_head_match_jax():
    jp = perturb(jcl.init_language_head(jax.random.key(0), feature_dim=16), RNG)
    tp = bridge(jp, tcl.init_language_head(16, device="meta"))
    feats = RNG.standard_normal((B, 16)).astype(np.float32)
    emo = RNG.integers(0, 4, B)
    lang = RNG.integers(0, tcl.NUM_LANGUAGES, B)
    emo_logits = RNG.standard_normal((B, 4)).astype(np.float32)

    def jloss(f):
        logits = jcl.language_adversarial_head(jax.tree.map(jnp.asarray, jp), f, alpha=0.7)
        cons = jcl.consistency_loss(f, jnp.asarray(emo), jnp.asarray(lang))
        return jcl.cross_lingual_losses(j(emo_logits), jnp.asarray(emo), logits,
                                        jnp.asarray(lang), cons)

    want = jloss(j(feats))
    want_grad = jax.grad(lambda f: jloss(f)["total_loss"])(j(feats))
    f = t(feats).requires_grad_(True)
    logits = tcl.language_adversarial_head(tp, f, alpha=0.7)
    cons = tcl.consistency_loss(f, t(emo), t(lang))
    got = tcl.cross_lingual_losses(t(emo_logits), t(emo), logits, t(lang), cons)
    for k in want:
        assert_close(got[k].detach(), want[k], TOL)
    (grad,) = torch.autograd.grad(got["total_loss"], f)
    assert_close(grad, want_grad, TOL)
    # the reversal alone: identity forward, -alpha * gradient backward
    x = t(feats).requires_grad_(True)
    y = tcl.gradient_reversal(x, 0.5)
    assert torch.equal(y, x)
    (gx,) = torch.autograd.grad((y ** 2).sum(), x)
    assert_close(gx, jax.grad(lambda v: (jcl.gradient_reversal(v, 0.5) ** 2).sum())(j(feats)),
                 TOL)


def test_adapter_and_consistency_edge_cases_match_jax():
    jp = perturb(jcl.init_adapter(jax.random.key(0), hidden_dim=16), RNG)
    tp = bridge(jp, tcl.init_adapter(16, device="meta"))
    x = RNG.standard_normal((3, 5, 16)).astype(np.float32)
    assert_close(tcl.adapter(tp, t(x)), jcl.adapter(jax.tree.map(jnp.asarray, jp), j(x)), TOL)
    # no same-emotion cross-language pair: 0
    f = RNG.standard_normal((4, 8)).astype(np.float32)
    got = tcl.consistency_loss(t(f), t(np.array([0, 1, 2, 3])), t(np.array([0, 1, 0, 1])))
    assert float(got) == 0.0


def test_loss_integration_matches_jax():
    for e in (0, 49, 50, 99, 100, 150):
        assert tli.phase_for_epoch(e) == jli.phase_for_epoch(e)
    for phase in tli.PHASES:
        assert tli.LossWeights().phase_weights(phase) == jli.LossWeights().phase_weights(phase)
    with pytest.raises(ValueError):
        tli.LossWeights().phase_weights("bogus")
    logits = (RNG.standard_normal((8, 4)) * 4).astype(np.float32)
    is_ood = np.array([0, 1, 0, 0, 1, 0, 1, 0], bool)
    assert_close(tli.energy_margin_loss(t(logits), t(is_ood)),
                 jli.energy_margin_loss(j(logits), j(is_ood)), TOL)
    assert_close(tli.energy_margin_loss(t(logits), t(np.zeros(8, bool)), margin=3.0),
                 jli.energy_margin_loss(j(logits), j(np.zeros(8, bool)), margin=3.0), TOL)
    prev = RNG.standard_normal((8, 4)).astype(np.float32)
    c1, c2 = RNG.random(8).astype(np.float32), RNG.random(8).astype(np.float32)
    assert_close(tli.temporal_consistency_loss(t(logits), t(prev), t(c1), t(c2)),
                 jli.temporal_consistency_loss(j(logits), j(prev), j(c1), j(c2)), TOL)
    conf = RNG.random(32).astype(np.float32)
    correct = RNG.random(32) > 0.4
    assert_close(tli.confidence_calibration_loss(t(conf), t(correct)),
                 jli.confidence_calibration_loss(j(conf), j(correct)), TOL)
    for args in ([np.array([0] * 10)], [np.arange(40) % 4, np.arange(40) % 3,
                                         np.arange(40) % 5 == 0]):
        assert tli.validate_batch_composition(*args) == jli.validate_batch_composition(*args)
    comps = {"ce_loss": 1.5, "supcon_loss": 0.4, "energy_margin_loss": 2.0,
             "temporal_consistency_loss": 0.3}
    for epoch in (0, 60, 120):
        want = jli.compute_total_loss({k: jnp.float32(v) for k, v in comps.items()}, epoch)
        got = tli.compute_total_loss({k: torch.tensor(v) for k, v in comps.items()}, epoch)
        assert got.pop("phase") == want.pop("phase")
        assert got.keys() == want.keys()
        for k in want:
            assert_close(got[k], want[k], TOL)


def test_legacy_heads_match_jax():
    jp = perturb(jcls.init_legacy_mlp(jax.random.key(0), 24, 4, hidden=16), RNG)
    tp = bridge(jp, tcls.init_legacy_mlp(META, 24, 4, hidden=16))
    x = RNG.standard_normal((10, 24)).astype(np.float32)
    labels = np.arange(10) % 3           # class 3 absent: the fit's defaults
    jpp = jax.tree.map(jnp.asarray, jp)
    ja, jl = jcls.legacy_mlp_forward(jpp, j(x))
    ta, tl = tcls.legacy_mlp_forward(tp, t(x))
    assert_close(ta, ja, TOL)
    assert_close(tl, jl, TOL)
    assert_close(tcls.legacy_classifier_forward(tp, t(x)),
                 jcls.legacy_classifier_forward(jpp, j(x)), TOL)
    want_fit = jcls.legacy_fit_weibull(ja, jnp.asarray(labels), 4)
    got_fit = tcls.legacy_fit_weibull(ta, t(labels), 4)
    for k in want_fit:
        assert_close(got_fit[k], want_fit[k], TOL)
    # the fit's Weibull in the head: JAX's 0.5 threshold and 1.0 scale
    jpp["weibull"], tp["weibull"] = want_fit, got_fit
    want = jcls.legacy_openmax_forward(jpp, j(x))
    got = tcls.legacy_openmax_forward(tp, t(x))
    assert_close(got, want, TOL)
    assert not torch.allclose(got, tl)   # some rows are scaled
    assert_close(tcls.legacy_openmax_forward(tp, t(x), use_openmax=False), jl, TOL)


def test_checked_assert_finite_and_report():
    def step(x):
        return {"loss": x.sum(), "grads": [x * 2, x / x.sum() * 0 + torch.log(x)]}

    ok = torch.tensor([1.0, 2.0])
    out = tdebug.checked(step)(ok)
    assert torch.equal(out["grads"][0], ok * 2)
    with pytest.raises(FloatingPointError, match=r"step: grads/\[1\] contains NaN/Inf"):
        tdebug.checked(step)(torch.tensor([1.0, 0.0]))
    assert tdebug.assert_finite(ok, "w") is ok
    with pytest.raises(FloatingPointError, match="w contains NaN/Inf"):
        tdebug.assert_finite(torch.tensor([float("nan")]), "w")
    tree = {"a": np.array([1.0, -3.0], np.float32), "b": [np.array([np.inf, 0.0], np.float32),
                                                         np.array([2, 5], np.int32)],
            "c": np.zeros((0,), np.float32)}
    want = jdebug.tree_finite_report(jax.tree.map(jnp.asarray, tree))
    got = tdebug.tree_finite_report(jax.tree.map(torch.from_numpy, tree))
    assert got == want


def test_step_keys_follow_the_loop_rule():
    g = tdebug.step_keys(7, 3, device="cpu")
    want = torch.Generator().manual_seed(step_seed(7, 3))
    assert torch.equal(torch.rand(4, generator=g), torch.rand(4, generator=want))
    gs = tdebug.step_keys(7, 3, 3, device="cpu")
    draws = [torch.rand(4, generator=k) for k in gs]
    again = [torch.rand(4, generator=k) for k in tdebug.step_keys(7, 3, 3, device="cpu")]
    assert all(torch.equal(a, b) for a, b in zip(draws, again))
    assert not torch.equal(draws[0], draws[1])
    assert torch.equal(draws[2], torch.rand(4, generator=torch.Generator().manual_seed(
        step_seed(step_seed(7, 3), 2))))


def test_step_timer_and_throughput_match_jax(monkeypatch, tmp_path):
    durations = [0.010, 0.013, 0.011, 0.030, 0.012]
    timers = []
    for mod in (jprof, tprof):
        clock = iter(np.cumsum([0.0] + [d for d in durations for d in (d, 1.0)]).tolist())
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer()
        for _ in durations:
            with timer:
                pass
        timers.append(timer.stats())
        monkeypatch.undo()
    assert timers[1] == timers[0]
    assert tprof.StepTimer().stats() == jprof.StepTimer().stats() == {}
    jm, tm_ = jprof.ThroughputMeter(), tprof.ThroughputMeter()
    for n, dt in ((16, 0.5), (16, 0.25), (8, 0.125)):
        jm.add(n, dt)
        tm_.add(n, dt)
    assert tm_.per_sec() == jm.per_sec() and tm_.per_sec(4) == jm.per_sec(4)
    assert tprof.ThroughputMeter().per_sec() == 0.0
    # the trace writes a Chrome trace; a CPU device has no allocator counters
    with tprof.trace(tmp_path / "tr") as prof:
        (torch.ones(8) * 2).sum()
    assert (tmp_path / "tr" / tprof.TRACE_FILE).stat().st_size > 0
    assert len(prof.key_averages()) > 0
    assert tprof.device_memory_stats("cpu") == {}
    tprof.sync({"x": torch.ones(2)})


def test_entry_points_resolve_to_the_card(monkeypatch):
    """The four functions that defaulted to the CPU take the card unless
    told otherwise, and raise as resolve_device does without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: tdg.init_threshold_manager(),
             lambda: ttm.init_buffer(2, 16),
             lambda: ttm.init_temporal_module(16, 4),
             lambda: trob.evaluate_noise_robustness(lambda *a: {}, []),
             lambda: tdebug.step_keys(0, 0),
             lambda: tprof.device_memory_stats(),
             lambda: tcf.init_adaptive_fusion(8, 8, 8),
             lambda: tcl.init_language_head(8)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            call()
    assert tdg.init_threshold_manager(device="cpu")["thresholds"].device.type == "cpu"
    assert ttm.init_buffer(2, 16, device="cpu").features.device.type == "cpu"

"""The port's training losses, prototype loss, Weibull fit and metrics log
against the JAX package's on the CPU: values and gradients (jax.grad
against torch autograd), on random inputs from a seed, with non-finite
logits and a class with no sample. Tolerance 1e-5 (f32, summation order)."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.models import (
    prototypes as jprotos)
from multilingual_multimodal_speech_emotion_recognition_tpu.ops import (
    losses as jlosses, openmax as jom)
from multilingual_multimodal_speech_emotion_recognition_tpu.utils import metrics as jmetrics
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    prototypes as tprotos)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
    losses as tlosses, openmax as tom)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import (
    metrics as tmetrics)

TOL = 1e-5
C = 4


def _inputs(case: str, seed: int = 0):
    """logits [8, C] and labels [8] for a case: all classes present, one
    class with no sample, large logits past the clamp, a NaN logit."""
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((8, C))).astype(np.float32)
    labels = rng.permutation(np.arange(8) % C).astype(np.int32)
    if case == "empty_class":
        labels = (labels % 2).astype(np.int32)          # classes 2 and 3 absent
    elif case == "clamped":
        logits *= 8.0
    elif case == "nan":
        logits[3, 1] = np.nan
    return logits, labels


def _value_and_grad_jax(fn, x):
    v, g = jax.value_and_grad(fn)(jnp.asarray(x))
    return np.asarray(v), np.asarray(g)


def _value_and_grad_torch(fn, x):
    t = torch.from_numpy(np.array(x)).requires_grad_(True)
    v = fn(t)
    (g,) = torch.autograd.grad(v, [t])
    return v.detach().numpy(), g.numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, equal_nan=True)


def _close_grad(got, want):
    """Gradients equal where JAX's are finite, and non-finite in the same
    rows (both trip the train step's guard): at a NaN input torch's clamp
    passes no gradient where JAX's clip passes NaN."""
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(np.isfinite(got).all(-1), finite.all(-1))


LOSS_CASES = ["plain", "empty_class", "clamped", "nan"]


@pytest.mark.parametrize("case", LOSS_CASES)
@pytest.mark.parametrize("smoothing", [0.1, 0.0])
def test_label_smoothing_cross_entropy_matches_jax(case, smoothing):
    logits, labels = _inputs(case)
    jv, jg = _value_and_grad_jax(lambda x: jlosses.label_smoothing_cross_entropy(
        x, jnp.asarray(labels), smoothing=smoothing), logits)
    tv, tg = _value_and_grad_torch(lambda x: tlosses.label_smoothing_cross_entropy(
        x, torch.from_numpy(labels), smoothing=smoothing), logits)
    assert np.isfinite(tv)
    _close(tv, jv)
    _close_grad(tg, jg)


@pytest.mark.parametrize("case", LOSS_CASES)
@pytest.mark.parametrize("beta,gamma", [(0.9999, 2.0), (0.99, 1.0)])
def test_class_balanced_focal_loss_matches_jax(case, beta, gamma):
    logits, labels = _inputs(case, seed=1)
    kw = dict(num_classes=C, beta=beta, gamma=gamma)
    jv, jg = _value_and_grad_jax(lambda x: jlosses.class_balanced_focal_loss(
        x, jnp.asarray(labels), **kw), logits)
    tv, tg = _value_and_grad_torch(lambda x: tlosses.class_balanced_focal_loss(
        x, torch.from_numpy(labels), **kw), logits)
    _close(tv, jv)
    _close_grad(tg, jg)


@pytest.mark.parametrize("case", ["plain", "empty_class"])
def test_supcon_and_uncertainty_regularizer_match_jax(case):
    logits, labels = _inputs(case, seed=2)
    feats = np.random.default_rng(3).standard_normal((8, 16)).astype(np.float32)
    jv, jg = _value_and_grad_jax(lambda f: jlosses.supcon_loss(f, jnp.asarray(labels)), feats)
    tv, tg = _value_and_grad_torch(lambda f: tlosses.supcon_loss(f, torch.from_numpy(labels)),
                                   feats)
    _close(tv, jv)
    _close(tg, jg)
    unc = np.random.default_rng(4).uniform(size=(8, 1)).astype(np.float32)
    jv, jg = _value_and_grad_jax(lambda u: jlosses.uncertainty_regularizer(
        u, jnp.asarray(logits), jnp.asarray(labels)), unc)
    tv, tg = _value_and_grad_torch(lambda u: tlosses.uncertainty_regularizer(
        u, torch.from_numpy(logits), torch.from_numpy(labels)), unc)
    _close(tv, jv)
    _close(tg, jg)


@pytest.mark.parametrize("case", ["plain", "empty_class", "clamped", "nan"])
def test_prototype_loss_matches_jax(case):
    _, labels = _inputs(case, seed=5)
    rng = np.random.default_rng(6)
    protos = (0.02 * rng.standard_normal((C, 16))).astype(np.float32)
    emb = rng.standard_normal((8, 16)).astype(np.float32)
    if case == "clamped":
        emb *= 30.0          # past the [-10, 10] clamp, distances past the cap of 10
    elif case == "nan":
        emb[2, 5] = np.nan   # a non-finite loss is taken as 0

    def jfn(p, e):
        return jprotos.prototype_loss({"prototypes": p}, e, jnp.asarray(labels))

    jv, (jgp, jge) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(protos), jnp.asarray(emb))
    p = torch.from_numpy(protos).requires_grad_(True)
    e = torch.from_numpy(emb).requires_grad_(True)
    tv = tprotos.prototype_loss({"prototypes": p}, e, torch.from_numpy(labels))
    tgp, tge = torch.autograd.grad(tv, [p, e])
    _close(tv.detach().numpy(), np.asarray(jv))
    _close_grad(tgp.numpy(), np.asarray(jgp))
    _close_grad(tge.numpy(), np.asarray(jge))


@pytest.mark.parametrize("labels", [
    np.array([0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 0], np.int32),
    np.array([0, 0, 2, 2, 2, 0, 0, 2, 2, 2, 0, 2], np.int32),     # classes 1 and 3 empty
    np.array([1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 3], np.int32),     # class 3 a single sample
], ids=["all_classes", "two_empty", "singleton"])
@pytest.mark.parametrize("scales", [(2.5, 1.5, 0.8), (2.0, 1.0, 1.0)], ids=["advanced", "legacy"])
def test_fit_weibull_matches_jax(labels, scales):
    alpha, beta_scale, tau_scale = scales
    feats = np.abs(np.random.default_rng(7).standard_normal((len(labels), 6))).astype(np.float32)
    kw = dict(alpha=alpha, beta_scale=beta_scale, tau_scale=tau_scale)
    want = jom.fit_weibull(jnp.asarray(feats), jnp.asarray(labels), C, **kw)
    got = tom.fit_weibull(torch.from_numpy(feats), torch.from_numpy(labels), C, **kw)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        _close(got[k].numpy(), np.asarray(want[k]))
    # and the fit feeds the OpenMax adjustment as the JAX one does
    logits = np.random.default_rng(8).standard_normal((len(labels), C)).astype(np.float32)
    _close(tom.openmax_adjust(got, torch.from_numpy(feats), torch.from_numpy(logits)).numpy(),
           np.asarray(jom.openmax_adjust(want, jnp.asarray(feats), jnp.asarray(logits))))


def test_metrics_writer_matches_jax(tmp_path):
    records = [{"kind": "step", "step": 50, "epoch": 0, "loss": 1.25, "ce": np.float32(0.5),
                "accuracy": 0.75, "utt_per_sec": 123.4, "time": 1000.0},
               {"kind": "epoch", "epoch": 0, "train_loss": 1.5, "val_f1": 0.25,
                "seconds": 3.5, "step": 64, "time": 1001.0},
               {"kind": "preempt", "step": 70, "epoch": 1, "checkpoint": "ck/preempt_step_70",
                "time": 1002.0}]
    jw = jmetrics.MetricsWriter(tmp_path / "jax" / "metrics.jsonl")
    tw = tmetrics.MetricsWriter(tmp_path / "port" / "metrics.jsonl")
    for r in records:
        jw.write(r)
        tw.write(r)
    assert tw.path.read_text() == jw.path.read_text()
    tw.write({"kind": "step", "loss": torch.tensor(2.0)})
    last = json.loads(tw.path.read_text().splitlines()[-1])
    assert last["loss"] == 2.0 and last["time"] > 0

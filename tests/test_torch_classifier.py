"""The port's classifier head, its residual stack's plain version and the
OpenMax ops against the JAX package (CPU, f32)."""

import numpy as np
import pytest
import jax
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.models import (
    classifier as jclf)
from multilingual_multimodal_speech_emotion_recognition_tpu.ops import (
    openmax as jom, pallas_kernels as pk)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    classifier as tclf)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
    openmax as tom, residual_stack as rs)

from torch_port_helpers import META, assert_close, bridge, j, perturb, t

RNG = np.random.default_rng(13)
STACK_TOL = 2e-5   # the JAX package's own bound for the Pallas stack
HEAD_TOL = 1e-5


def _stack(seed, num_layers=5, base_dim=128):
    jp = jclf.init_classifier(jax.random.key(seed), input_dim=64, num_labels=4,
                              num_layers=num_layers, base_dim=base_dim)
    return perturb(jp["layers"], np.random.default_rng(seed))


@pytest.mark.parametrize("B", [1, 3, 8, 11])
def test_residual_stack_plain_matches_scan_and_pallas(B):
    jlayers = _stack(B)
    tlayers = bridge(jlayers, tclf.init_classifier(META, 64, 4, 5, 128)["layers"])
    x = RNG.standard_normal((B, 128)).astype(np.float32)
    got = rs.residual_stack_plain(tlayers, t(x))
    jtree = jax.tree.map(j, jlayers)
    scan = jax.jit(lambda p, x: jclf._residual_stack(
        p, x, dropout_rate=0.0, dropout_key=None, deterministic=True))(jtree, j(x))
    pallas = pk.residual_stack_pallas(jtree, j(x))  # interpret mode off-TPU
    assert got.shape == (B, 128)
    assert_close(got, scan, STACK_TOL)
    assert_close(got, pallas, STACK_TOL)


def test_residual_stack_takes_the_plain_version_on_cpu_only():
    tlayers = bridge(_stack(0, 2, 8), tclf.init_classifier(META, 64, 4, 2, 8)["layers"])
    x = t(RNG.standard_normal((3, 8)).astype(np.float32))
    before = rs.residual_stack.launches
    assert torch.equal(rs.residual_stack(tlayers, x), rs.residual_stack_plain(tlayers, x))
    assert rs.residual_stack.launches == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rs.residual_stack(tlayers, x.to("meta"))


def _weibull(C, D, rng):
    return {"alpha": (1.5 + rng.random(C)).astype(np.float32),
            "beta": (0.5 + rng.random(C)).astype(np.float32),
            "tau": (0.1 * rng.random(C)).astype(np.float32),
            "activation_vectors": rng.standard_normal((C, D)).astype(np.float32)}


@pytest.mark.parametrize("use_openmax", [False, True], ids=["plain", "openmax"])
def test_classifier_forward(use_openmax):
    jp = jclf.init_classifier(jax.random.key(3), input_dim=32, num_labels=4,
                              num_layers=3, base_dim=32)
    jp = perturb(jp, np.random.default_rng(3))
    # non-trivial Weibull state so the adjustment fires on some rows
    jp["weibull"] = _weibull(4, 16, np.random.default_rng(4))
    tp = bridge(jp, tclf.init_classifier(META, 32, 4, 3, 32))
    x = RNG.standard_normal((6, 32)).astype(np.float32)
    want = jax.jit(lambda p, x: jclf.classifier_forward(p, x, use_openmax=use_openmax))(
        jax.tree.map(j, jp), j(x))
    got = tclf.classifier_forward(tp, t(x), use_openmax=use_openmax)
    for field in want._fields:
        assert_close(getattr(got, field), getattr(want, field), HEAD_TOL)
    if use_openmax:
        plain = tclf.classifier_forward(tp, t(x), use_openmax=False)
        assert not torch.allclose(plain.logits, got.logits)


def test_openmax_ops():
    rng = np.random.default_rng(5)
    wb = _weibull(5, 12, rng)
    feats = (2.0 * rng.standard_normal((7, 12))).astype(np.float32)
    logits = rng.standard_normal((7, 5)).astype(np.float32)
    twb = {k: t(v) for k, v in wb.items()}
    jwb = {k: j(v) for k, v in wb.items()}
    assert_close(tom.weibull_unknown_prob(twb, t(feats)),
                 jom.weibull_unknown_prob(jwb, j(feats)), HEAD_TOL)
    assert_close(tom.openmax_adjust(twb, t(feats), t(logits)),
                 jom.openmax_adjust(jwb, j(feats), j(logits)), HEAD_TOL)

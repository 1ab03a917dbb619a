"""The port's attentive-stats pooling, gated fusion and cross-modal
attention against the JAX package (CPU). f32 within 1e-5; bf16 pooling
within 3e-2, the JAX package's own bf16 pooling bound."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.models import (
    cross_attention as jcma, fusion as jfu)
from multilingual_multimodal_speech_emotion_recognition_tpu.ops import pooling as jpo
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    cross_attention as tcma, fusion as tfu)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
    pooling as tpo)

from torch_port_helpers import META, assert_close, bridge, j, perturb, t

RNG = np.random.default_rng(17)
F32_TOL = 1e-5
BF16_TOL = 3e-2


def _mask(B, S):
    m = np.ones((B, S), np.float32)
    m[1, S // 2:] = 0
    m[B - 1, 3:] = 0
    return m


@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float32, torch.float32, F32_TOL),
                                         (jnp.bfloat16, torch.bfloat16, BF16_TOL)],
                         ids=["f32", "bf16"])
def test_attentive_stats_pooling(jdt, tdt, tol):
    jp = perturb(jpo.init_attentive_stats_pooling(jax.random.key(0), 24), RNG)
    tp = bridge(jp, tpo.init_attentive_stats_pooling(META, 24))
    x = RNG.standard_normal((4, 13, 24)).astype(np.float32)
    mask = _mask(4, 13)
    want = jax.jit(jpo.attentive_stats_pooling)(
        jax.tree.map(lambda a: j(a, jdt), jp), j(x, jdt), j(mask))
    got = tpo.attentive_stats_pooling(
        {k: {kk: vv.to(tdt) for kk, vv in v.items()} for k, v in tp.items()},
        t(x, tdt), t(mask))
    assert got.shape == (4, 48) and got.dtype == tdt
    assert_close(got, want, tol)


def test_fusion():
    jp = perturb(jfu.init_fusion(jax.random.key(1), 20, 12, 16), RNG)
    tp = bridge(jp, tfu.init_fusion(META, 20, 12, 16))
    a = RNG.standard_normal((5, 20)).astype(np.float32)
    b = RNG.standard_normal((5, 12)).astype(np.float32)
    want = jax.jit(jfu.fusion)(jax.tree.map(j, jp), j(a), j(b))
    assert_close(tfu.fusion(tp, t(a), t(b)), want, F32_TOL)


def test_cross_modal_attention():
    jp = perturb(jcma.init_cross_modal_attention(jax.random.key(2), 24, 20, 16, 4), RNG)
    tp = bridge(jp, tcma.init_cross_modal_attention(META, 24, 20, 16))
    audio = RNG.standard_normal((3, 11, 24)).astype(np.float32)
    text = RNG.standard_normal((3, 7, 20)).astype(np.float32)
    a_mask, t_mask = _mask(3, 11), _mask(3, 7)
    want = jax.jit(lambda p, *xs: jcma.cross_modal_attention(
        p, *xs, num_heads=4, deterministic=True))(
            jax.tree.map(j, jp), j(audio), j(text), j(a_mask), j(t_mask))
    got = tcma.cross_modal_attention(tp, t(audio), t(text), t(a_mask), t(t_mask),
                                     num_heads=4)
    for g, w in zip(got, want):
        assert_close(g, w, F32_TOL)

"""The port's streaming attentive-statistics pooling
(ops/attentive_pooling.py) against the JAX package's
`attentive_stats_pooling_pallas`, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs it. f32 within 2e-5 (summation order
only); bf16 within 3e-2, the JAX package's own bf16 bound for this kernel
(test_pallas_kernels.py:64)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.ops import (
    pallas_kernels as pk, pooling as jpool)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
    attentive_pooling as ap)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import profiling

from torch_port_helpers import assert_close, j, perturb, t

RNG = np.random.default_rng(31)


@pytest.mark.parametrize("dtype,B,S,D,tol", [
    (torch.float32, 5, 40, 64, 2e-5),
    (torch.float32, 3, 150, 32, 2e-5),   # two of the JAX kernel's 128-frame tiles
    (torch.bfloat16, 4, 40, 64, 3e-2),
], ids=["f32", "f32-two-tiles", "bf16"])
def test_pooling_matches_pallas(dtype, B, S, D, tol):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    params = perturb(jpool.init_attentive_stats_pooling(jax.random.key(B), D), RNG)
    x = RNG.standard_normal((B, S, D)).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    mask[1, S // 2:] = 0
    mask[-1, 3:] = 0
    want = pk.attentive_stats_pooling_pallas(jax.tree.map(lambda a: j(a, jdt), params),
                                             j(x, jdt), j(mask))
    before = profiling.counters()["attentive_stats_pooling.launches"]
    got = ap.attentive_stats_pooling(jax.tree.map(lambda a: t(a, dtype), params),
                                     t(x, dtype), t(mask))
    # CPU: the plain version
    assert profiling.counters()["attentive_stats_pooling.launches"] == before
    assert got.dtype == dtype and tuple(got.shape) == (B, 2 * D)
    assert_close(got, want, tol)


def test_pooling_fully_masked_row_matches_pallas():
    """A row with no valid frame: weights 0, l clamped, mean 0, std 1e-3."""
    params = jpool.init_attentive_stats_pooling(jax.random.key(0), 16)
    x = RNG.standard_normal((2, 12, 16)).astype(np.float32)
    mask = np.ones((2, 12), np.float32)
    mask[0] = 0
    want = pk.attentive_stats_pooling_pallas(params, j(x), j(mask))
    got = ap.attentive_stats_pooling(jax.tree.map(t, jax.tree.map(np.asarray, params)),
                                     t(x), t(mask))
    assert_close(got, want, 2e-5)
    assert torch.equal(got[0], torch.cat([torch.zeros(16), torch.full((16,), 1e-3)]))


def test_pooling_rejects_mismatched_parameters():
    params = {"w1": {"kernel": torch.zeros(8, 4), "bias": torch.zeros(4)},
              "w2": {"kernel": torch.zeros(4, 1), "bias": torch.zeros(1)}}
    with pytest.raises(ValueError, match="do not fit"):
        ap.attentive_stats_pooling(params, torch.zeros(2, 3, 6), torch.ones(2, 3))

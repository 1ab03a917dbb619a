"""The port's TTA DSP (ops/audio_dsp.py) and energy score against the JAX
package's on the CPU. Resampled and noised views within 1e-5 (f32
summation order; the JAX side runs at matmul precision "highest"); lengths
and masks equal. The noise views take JAX's own standard-normal draws,
made from the keys tta_expand splits, through the port's `noise=`."""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.ops import (
    audio_dsp as jdsp, openmax as jom)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
    audio_dsp as tdsp, openmax as tom)

from torch_port_helpers import assert_close, t

TOL = 1e-5
SR = 16000


def waves(B, T, seed):
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.standard_normal((B, T))).astype(np.float32)
    m = np.ones((B, T), np.float32)
    m[0, T * 2 // 3:] = 0
    w *= m
    return w, m


@pytest.mark.parametrize("orig,new", [(16000, 15200), (15200, 16000),
                                      (16000, 16800), (16800, 16000), (16000, 8000)])
@pytest.mark.parametrize("T", [1, 19, 1000, 4001])
def test_sinc_resample_matches_jax(orig, new, T):
    w, _ = waves(2, T, seed=T)
    want = jdsp.sinc_resample(jnp.asarray(w), orig, new)
    got = tdsp.sinc_resample(t(w), orig, new)
    assert tuple(got.shape) == want.shape == (2, tdsp.resampled_length(T, orig, new))
    assert tdsp.resampled_length(T, orig, new) == jdsp.resampled_length(T, orig, new)
    assert_close(got, want, TOL)


@pytest.mark.parametrize("factor", [0.95, 1.05, 0.9, 1.1, 1.0])
def test_speed_perturb_matches_jax(factor):
    w, _ = waves(3, 3000, seed=1)
    assert_close(tdsp.speed_perturb(t(w), factor), jdsp.speed_perturb(jnp.asarray(w), factor),
                 TOL)


def boundary_lengths(T):
    out = {1, 2, T - 1, T}
    for q in (19, 20, 21):
        for k in (1, 2, 50, T // q):
            out.update({k * q - 1, k * q, k * q + 1})
    return sorted(x for x in out if 1 <= x <= T)


@pytest.mark.parametrize("factor", [0.95, 1.05, 0.9, 1.1])
def test_speed_perturb_length_matches_jax(factor):
    for T in (4000, 30 * SR):
        lengths = np.asarray(boundary_lengths(T), np.int32)
        want = np.asarray(jdsp.speed_perturb_length(jnp.asarray(lengths), factor))
        got = tdsp.speed_perturb_length(t(lengths), factor)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def exact_speed_perturb_length(length, factor, sample_rate=SR):
    """The valid-sample count after speed_perturb in integer arithmetic:
    what the JAX package's speed_perturb_length computes op by op, and what
    the port computes. Under jit, XLA turns its f32 division by a constant
    into a product with the reciprocal, and the ceil then gains one sample
    at about 2.7 % of lengths for factor 0.95 (ROADMAP Queue C). JAX tests
    that hold the port to a jitted TTA step patch this in, so that both
    sides keep the same samples. Works on jnp and numpy int arrays."""
    new_sr = int(sample_rate * factor)
    g = math.gcd(sample_rate, new_sr)
    up, down = new_sr // g, sample_rate // g
    mid = -((-length * up) // down)
    return (-((-mid * down) // up)).astype(np.int32)


@pytest.mark.parametrize("factor", [0.95, 1.05])
def test_speed_perturb_length_is_exact_at_every_length(factor):
    """Every length up to 30 s: the port and JAX's eager code give the
    integer result; JAX's jitted code is the one that differs."""
    lengths = np.arange(1, 30 * SR + 1, dtype=np.int32)
    exact = exact_speed_perturb_length(lengths.astype(np.int64), factor)
    np.testing.assert_array_equal(tdsp.speed_perturb_length(t(lengths), factor).numpy(), exact)
    np.testing.assert_array_equal(
        np.asarray(jdsp.speed_perturb_length(jnp.asarray(lengths), factor)), exact)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(exact_speed_perturb_length, static_argnums=1)(
            jnp.asarray(lengths), factor)), exact)


@pytest.mark.parametrize("snr", [15.0, 20.0, "per_row"])
def test_add_noise_snr_matches_jax_on_its_draw(snr):
    w, m = waves(3, 2000, seed=2)
    w[2] = 0.0                                   # silent row: the power floor
    key = jax.random.key(4)
    snr = np.asarray([5.0, 10.0, 20.0], np.float32) if snr == "per_row" else snr
    want = jdsp.add_noise_snr(key, jnp.asarray(w), jnp.asarray(m), jnp.asarray(snr))
    draw = jax.random.normal(key, w.shape, jnp.float32)
    got = tdsp.add_noise_snr(t(w), t(m), t(np.asarray(snr)), noise=t(draw))
    assert_close(got, want, TOL)
    # without a draw: one from the generator, reproducible by its seed
    a = tdsp.add_noise_snr(t(w), t(m), 15.0, generator=torch.Generator().manual_seed(0))
    b = tdsp.add_noise_snr(t(w), t(m), 15.0, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, t(w))


@pytest.mark.parametrize("num_tta", [1, 2, 3, 4, 5])
def test_tta_expand_matches_jax(num_tta):
    B, T = 3, 3000
    w, m = waves(B, T, seed=3)
    m[1, 1900:] = 0                               # a second short row
    w *= m
    key = jax.random.key(7)
    want_w, want_m = jdsp.tta_expand(key, jnp.asarray(w), jnp.asarray(m), num_tta=num_tta)
    k1, k2 = jax.random.split(key)
    draws = [t(jax.random.normal(k, (B, T), jnp.float32)) for k in (k1, k2)]
    got_w, got_m = tdsp.tta_expand(t(w), t(m), num_tta=num_tta, noise=draws)
    assert tuple(got_w.shape) == (num_tta * B, T)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert_close(got_w, want_w, TOL)
    assert torch.equal(got_w[:B], t(w))           # view 0 is the clip itself


def test_tta_views_are_view_major_and_noise_from_the_generator():
    B, T = 2, 1500
    w, m = waves(B, T, seed=5)
    got_w, _ = tdsp.tta_expand(t(w), t(m), num_tta=5, generator=torch.Generator().manual_seed(1))
    again, _ = tdsp.tta_expand(t(w), t(m), num_tta=5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(got_w, again)
    slow = tdsp.speed_perturb(t(w), 0.95)
    lengths = tdsp.speed_perturb_length(t(m).to(torch.int32).sum(-1), 0.95).clamp(max=T)
    keep = (torch.arange(T)[None, :] < lengths[:, None]).float()
    assert torch.equal(got_w[B:2 * B], slow * keep)


def test_energy_score_matches_jax():
    rng = np.random.default_rng(6)
    logits = (5 * rng.standard_normal((64, 6))).astype(np.float64)
    logits[0] = 80.0                              # logsumexp must not overflow
    want = jom.energy_score(jnp.asarray(logits))
    got = tom.energy_score(t(logits))
    assert got.dtype == torch.float32
    assert_close(got, want, TOL)

"""Shared helpers of the tests that hold the PyTorch port against the JAX
package on the CPU: parameters are made by the JAX init functions and cross
to the port through its weight bridge; inputs are numpy arrays from a seed."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu_torch import weights
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    layers as tl)

META = tl.Init(None, "meta")


def bridge(jax_tree, template):
    """The port's copy of a JAX parameter subtree, on the CPU."""
    return weights.tree_from_jax(jax.tree.map(np.asarray, jax_tree), template,
                                 device="cpu")


def t(x, dtype=None):
    """numpy -> CPU tensor, optionally cast (bf16 goes through f32)."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def j(x, dtype=None):
    out = jnp.asarray(np.array(x))
    return out if dtype is None else out.astype(dtype)


def assert_close(got, want, tol):
    """Port tensor against JAX array, compared in f32."""
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want).astype(jnp.float32)),
                               rtol=tol, atol=tol)


def perturb(tree, rng, scale=0.1):
    """A numpy copy of a JAX tree with noise on every leaf, so that LN
    scales/biases and zero-initialised biases are not trivial."""
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))
                   ).astype(np.asarray(a).dtype), tree)


@pytest.fixture
def offline_hub(monkeypatch):
    """Hugging Face hub lookups fail at once (HF_HUB_OFFLINE, also where the
    hub's constants were read before this test), and any attempt to
    resolve or reach a host fails the test instead of leaving."""
    import socket

    import huggingface_hub.constants

    attempts = []

    def refuse(*args, **kw):
        attempts.append(args[:2])
        raise OSError("network access refused by the test")

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    for name in ("getaddrinfo", "create_connection"):
        monkeypatch.setattr(socket, name, refuse)
    monkeypatch.setattr(socket.socket, "connect", refuse)
    yield
    assert attempts == [], f"network access attempted: {attempts}"

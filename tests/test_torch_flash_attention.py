"""The port's masked flash attention (ops/flash_attention.py) against the
JAX package's `flash_attention`, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs it, with small KV tiles so that the
online softmax crosses tiles. f32 within 2e-5 (summation order only); bf16
within 3e-2: both compute in f32 from the same bf16 inputs and round the
output once, so they differ by at most an output rounding."""

import pathlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.ops import (
    pallas_kernels as pk)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
    flash_attention as fa)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import profiling

from torch_port_helpers import assert_close, j, t

RNG = np.random.default_rng(29)
PORT = pathlib.Path(fa.__file__).resolve().parents[1]


@pytest.mark.parametrize("dtype,B,Sq,Skv,D,H,tol", [
    (torch.float32, 2, 40, 56, 32, 4, 2e-5),     # Dh 8
    (torch.float32, 2, 24, 37, 64, 2, 2e-5),     # Dh 32
    (torch.float32, 3, 33, 20, 128, 2, 2e-5),    # Dh 64, Sq > Skv
    (torch.bfloat16, 2, 40, 23, 64, 2, 3e-2),
    (torch.bfloat16, 2, 17, 45, 128, 2, 3e-2),
], ids=["f32-dh8", "f32-dh32", "f32-dh64", "bf16-dh32", "bf16-dh64"])
def test_flash_attention_matches_pallas(dtype, B, Sq, Skv, D, H, tol):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    q, k, v = (RNG.standard_normal((B, S, D)).astype(np.float32)
               for S in (Sq, Skv, Skv))
    mask = np.ones((B, Skv), np.float32)
    mask[0, Skv * 2 // 3:] = 0      # a padded tail
    mask[-1, 1:Skv:3] = 0           # scattered padded keys
    want = pk.flash_attention(j(q, jdt), j(k, jdt), j(v, jdt), j(mask),
                              num_heads=H, block_q=16, block_k=16)
    before = profiling.counters()["flash_attention.launches"]
    got = fa.flash_attention(t(q, dtype), t(k, dtype), t(v, dtype), t(mask),
                             num_heads=H)
    # the CPU takes the plain version
    assert profiling.counters()["flash_attention.launches"] == before
    assert got.dtype == dtype and tuple(got.shape) == (B, Sq, D)
    assert_close(got, want, tol)


def test_flash_attention_rejects_mismatched_shapes():
    q = torch.zeros(2, 5, 16)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(q, torch.zeros(2, 6, 16), torch.zeros(2, 6, 16),
                           torch.ones(2, 5), num_heads=2)
    with pytest.raises(ValueError, match="num_heads"):
        fa.flash_attention(q, q, q, torch.ones(2, 5), num_heads=3)


def test_a2_and_a3_are_not_wired_into_models():
    """As in the JAX package, no model module calls the streaming pooling
    or the flash-attention kernel."""
    for src in sorted((PORT / "models").glob("*.py")):
        text = src.read_text()
        assert "flash_attention" not in text, src
        assert "attentive_pooling" not in text, src


def test_flash_attention_routes_by_dtype():
    """bf16 goes to the tensor-core kernel, f32 to the CUDA-core one;
    nothing else has a route."""
    assert fa.ROUTES == {torch.bfloat16: "flash_attention_bf16",
                         torch.float32: "flash_attention_f32"}

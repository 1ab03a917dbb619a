"""The port's primitive layers against the JAX package's models/layers.py
(CPU, small shapes). f32 within 1e-5; bf16 within 2e-2, a few bf16 ulps
at these magnitudes, since the two frameworks round at other places."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.models import layers as jl
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    layers as tl)

from torch_port_helpers import META, assert_close, bridge, j, perturb, t

RNG = np.random.default_rng(11)
F32_TOL = 1e-5
BF16_TOL = 2e-2
DTYPES = [(jnp.float32, torch.float32, F32_TOL),
          (jnp.bfloat16, torch.bfloat16, BF16_TOL)]


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_linear(jdt, tdt, tol):
    jp = jl.init_linear(jax.random.key(0), 24, 16)
    tp = bridge(jp, tl.init_linear(META, 24, 16))
    x = RNG.standard_normal((3, 5, 24)).astype(np.float32)
    want = jl.linear(jax.tree.map(lambda a: a.astype(jdt), jp), j(x, jdt))
    got = tl.linear({k: v.to(tdt) for k, v in tp.items()}, t(x, tdt))
    assert got.dtype == tdt
    assert_close(got, want, tol)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_layer_norm(jdt, tdt, tol):
    jp = perturb(jl.init_layer_norm(32), RNG)
    tp = bridge(jp, tl.init_layer_norm(META, 32))
    x = (3.0 + 2.0 * RNG.standard_normal((4, 7, 32))).astype(np.float32)
    want = jl.layer_norm(jax.tree.map(j, jp), j(x, jdt), eps=1e-5)
    got = tl.layer_norm(tp, t(x, tdt), eps=1e-5)
    assert got.dtype == tdt
    assert_close(got, want, tol)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f32-erf", "bf16-tanh"])
def test_gelu(jdt, tdt, tol):
    x = (3.0 * RNG.standard_normal((64, 33))).astype(np.float32)
    assert_close(tl.gelu(t(x, tdt)), jl.gelu(j(x, jdt)), tol)


def test_gelu_is_exact_in_f32_and_tanh_in_bf16():
    x = torch.tensor([-2.0, -0.5, 0.7, 1.9])
    exact = torch.nn.functional.gelu(x)
    tanh = torch.nn.functional.gelu(x, approximate="tanh")
    xb = x.to(torch.bfloat16)
    assert torch.equal(tl.gelu(x), exact)
    assert torch.equal(tl.gelu(xb),
                       torch.nn.functional.gelu(xb, approximate="tanh"))
    assert not torch.equal(exact, tanh)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_mha_with_key_padding(jdt, tdt, tol):
    E, H = 16, 4
    jp = perturb(jl.init_mha(jax.random.key(1), E, H), RNG)
    tp = bridge(jp, tl.init_mha(META, E))
    q = RNG.standard_normal((3, 6, E)).astype(np.float32)
    kv = RNG.standard_normal((3, 9, E)).astype(np.float32)
    mask = np.ones((3, 9), np.float32)
    mask[1, 4:] = 0
    mask[2, 1:] = 0
    want = jl.mha(jax.tree.map(lambda a: j(a, jdt), jp), j(q, jdt), j(kv, jdt),
                  j(kv, jdt), num_heads=H, key_padding_mask=j(mask))
    got = tl.mha({k: {kk: vv.to(tdt) for kk, vv in v.items()} for k, v in tp.items()},
                 t(q, tdt), t(kv, tdt), t(kv, tdt), num_heads=H,
                 key_padding_mask=t(mask))
    assert got.dtype == tdt
    assert_close(got, want, tol)


def test_int8_linear_is_not_ported():
    """`linear` on an int8 slot {kernel_q, w_scale, bias} is
    ops/quant.linear_int8, and equals JAX's `linear` on the same slot (the
    int32 product exact, the dequantisation the same f32 products)."""
    from multilingual_multimodal_speech_emotion_recognition_tpu.ops import quant as jq
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import quant as tq
    jp = jq.quantize_linear(jl.init_linear(jax.random.key(0), 24, 16))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = RNG.standard_normal((3, 5, 24)).astype(np.float32)
    got = tl.linear(tp, t(x))
    torch.testing.assert_close(got, tq.linear_int8(tp, t(x)), rtol=0, atol=0)
    assert_close(got, jl.linear(jp, j(x)), F32_TOL)

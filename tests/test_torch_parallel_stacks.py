"""The port's ring attention stack (parallel/sequence.py) and GPipe stack
(parallel/pipeline.py) on two gloo ranks on the CPU, against the JAX
package's on a 2-device CPU mesh from the same numpy inputs and
parameters: vanilla and WavLM, S divisible by the ring and padded to it,
M = 2 and 4 microbatches, the pipeline's gradients against the dense
stack's under jax.grad, and JAX's argument checks. Tolerances: the stacks
rtol 2e-4, atol 2e-5 (JAX's ring test), the gradients 5e-4 / 5e-5 (JAX's
pipeline-gradient test). One RankPool for the module
(tests/torch_port_helpers.py)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import multilingual_multimodal_speech_emotion_recognition_tpu.models.wav2vec2 as jw
from multilingual_multimodal_speech_emotion_recognition_tpu.parallel import mesh as jmesh
from multilingual_multimodal_speech_emotion_recognition_tpu.parallel.pipeline import (
    encoder_stack_pipeline as j_pipeline)
from multilingual_multimodal_speech_emotion_recognition_tpu.parallel.sequence import (
    encoder_stack_sequence_parallel as j_ring)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    wav2vec2 as tw)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.parallel import (
    mesh as tmesh, pipeline as tpipe, sequence as tseq)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
    leaves_with_paths)

from torch_port_helpers import META, bridge, one_torch_thread, perturb, two_ranks

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(11)
SEQ_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


def _jax_mesh(data, model):
    return jmesh.make_mesh(jax.devices()[:data * model], data=data, model=model)


# ------------------------------------------------------------ rank side

def rank_ring(stacked, cfg, h, mask, rel, shape):
    mesh = tmesh.make_mesh(data=shape[0], model=shape[1], device="cpu")
    with torch.no_grad():
        out = tseq.encoder_stack_sequence_parallel(stacked, cfg, h, mask, mesh,
                                                   rel_attn_embed=rel)
    return out.numpy()


def rank_pipeline(stacked, cfg, h, mask, rel, microbatches, cot=None):
    mesh = tmesh.make_mesh(data=1, model=2, device="cpu")
    leaves = dict(leaves_with_paths(stacked))
    for t in leaves.values():
        t.requires_grad_(True)
    h = h.clone().requires_grad_(True)
    out = tpipe.encoder_stack_pipeline(stacked, cfg, h, mask, mesh,
                                       num_microbatches=microbatches, rel_attn_embed=rel)
    cot = torch.ones_like(out) if cot is None else cot
    grads = torch.autograd.grad((out * cot).sum(), [h, *leaves.values()])
    return out.detach().numpy(), {p: g.numpy() for p, g in zip(["h", *leaves], grads)}



# ------------------------------------------------------------ tests

def _tiny_w2v(stable_ln=False, layers=2, wavlm=False):
    cfg = jw.Wav2Vec2Config(
        conv_dim=(8,), conv_stride=(5,), conv_kernel=(10,), hidden_size=32,
        num_hidden_layers=layers, num_attention_heads=4, intermediate_size=64,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        do_stable_layer_norm=stable_ln or wavlm, apply_spec_augment=False,
        gated_relpos_bias=wavlm, num_buckets=16, max_bucket_distance=20)
    return cfg, tcfg.Wav2Vec2Config(**dataclasses.asdict(cfg))


def _stack_inputs(jc, tc, B, S, lengths, seed):
    jp = jax.tree.map(jnp.asarray, perturb(jw.init_wav2vec2(jax.random.key(seed), jc), RNG))
    if jc.gated_relpos_bias:
        jp["rel_attn_embed"] = jax.random.normal(jax.random.key(seed + 1),
                                                 jp["rel_attn_embed"].shape) * 0.1
    tp = bridge(jp, tw.init_wav2vec2(META, tc))
    h = RNG.standard_normal((B, S, jc.hidden_size)).astype(np.float32)
    mask = (np.arange(S)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return jp, tp, h, mask


@pytest.mark.parametrize("variant", ["vanilla", "wavlm"])
@pytest.mark.parametrize("S", [32, 29])
def test_ring_stack_matches_jax_on_two_ranks(two_ranks, variant, S):
    wavlm = variant == "wavlm"
    jc, tc = _tiny_w2v(wavlm=wavlm)
    jp, tp, h, mask = _stack_inputs(jc, tc, 4, S, [S, S - 3, S // 2, 5], seed=2)
    rel = jp.get("rel_attn_embed")
    want = np.asarray(j_ring(jp["layers"], jc, jnp.asarray(h), jnp.asarray(mask),
                             _jax_mesh(1, 2), rel_attn_embed=rel))
    outs = two_ranks.run(rank_ring, tp["layers"], tc, torch.from_numpy(h),
                         torch.from_numpy(mask), tp.get("rel_attn_embed"), (1, 2))
    valid = mask.astype(bool)
    for got in outs:
        np.testing.assert_allclose(got[valid], want[valid], **SEQ_TOL)
    if not wavlm:
        # rows over 'data' and the sequence on one rank each: mesh (2, 1)
        got = two_ranks.run(rank_ring, tp["layers"], tc, torch.from_numpy(h),
                            torch.from_numpy(mask), None, (2, 1))[0]
        np.testing.assert_allclose(got[valid], want[valid], **SEQ_TOL)


@pytest.mark.parametrize("microbatches", [2, 4])
@pytest.mark.parametrize("variant", ["vanilla", "wavlm"])
def test_pipeline_stack_and_its_gradients_match_jax_on_two_ranks(two_ranks, microbatches,
                                                                  variant):
    jc, tc = _tiny_w2v(layers=4, wavlm=variant == "wavlm")
    B, S = 8, 20
    jp, tp, h, mask = _stack_inputs(jc, tc, B, S, [S, S - 7, S // 2, 3, S - 1, 11, 9, 5],
                                    seed=6)
    rel = jp.get("rel_attn_embed")
    mesh = _jax_mesh(1, 2)
    want = np.asarray(j_pipeline(jp["layers"], jc, jnp.asarray(h), jnp.asarray(mask),
                                 mesh, num_microbatches=microbatches, rel_attn_embed=rel))

    def loss_dense(p, x):
        bias = jnp.where(jnp.asarray(mask)[:, None, None, :] == 0, -jnp.inf, 0.0)
        pos = (jw.relative_position_bias({"rel_attn_embed": rel}, jc, S)
               if rel is not None else None)
        out = jw._encoder_stack(p, jc, x, bias, dropout_key=None, deterministic=True,
                                remat=False, pos_bias=pos)
        return (out * cot).sum()

    # a random cotangent: sum(out ** 2) of a post-LN stack is nearly
    # constant in its inputs (the last LN fixes each frame's norm)
    cot = RNG.standard_normal(h.shape).astype(np.float32)
    gp, gx = jax.jit(jax.grad(loss_dense, argnums=(0, 1)))(jp["layers"], jnp.asarray(h))
    want_grads = {"h": np.asarray(gx)}
    for path, g in jax.tree_util.tree_flatten_with_path(gp)[0]:
        want_grads["/".join(str(k.key) for k in path)] = np.asarray(g)

    results = two_ranks.run(rank_pipeline, tp["layers"], tc, torch.from_numpy(h),
                            torch.from_numpy(mask), tp.get("rel_attn_embed"), microbatches,
                            torch.from_numpy(cot))
    valid = mask.astype(bool)
    for out, grads in results:
        np.testing.assert_allclose(out[valid], want[valid], **SEQ_TOL)
        assert grads.keys() == want_grads.keys()
        for path, g in grads.items():
            np.testing.assert_allclose(g, want_grads[path], err_msg=path, **GRAD_TOL)


def test_pipeline_keeps_jax_checks(two_ranks):
    jc, tc = _tiny_w2v(layers=3)
    _, tp, h, mask = _stack_inputs(jc, tc, 8, 12, [12] * 8, seed=1)
    with pytest.raises(AssertionError, match="not divisible by 2 pipeline stages"):
        two_ranks.run(rank_pipeline, tp["layers"], tc, torch.from_numpy(h),
                      torch.from_numpy(mask), None, 2)
    with pytest.raises(AssertionError, match="not divisible by microbatches"):
        two_ranks.run(rank_pipeline, tp["layers"], tc, torch.from_numpy(h),
                      torch.from_numpy(mask), None, 3)

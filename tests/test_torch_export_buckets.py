"""The port's bucketed serving artifacts without the DSP (export.py:
export_buckets, precomputed front-end features) against the JAX package's
on the CPU, on the same bridged parameters of one tiny model, and the
parameter skeleton both packages persist.

Tolerance: f32 within 1e-4 (summation order only)."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import (
    config as jcfg, export as jex)
from multilingual_multimodal_speech_emotion_recognition_tpu.models import model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
    config as tcfg, export as tex, weights)

from test_model import tiny_config

TOL = 1e-4
BUCKETS = [(0.2, 2), (0.4, 2)]


def nodsp_batch(B, T, seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T), np.float32)
    mask[0, T // 2:] = 0
    ids = rng.integers(2, 100, (B, 8)).astype(np.int32)
    text_mask = np.ones((B, 8), np.float32)
    ids[1, 5:] = 1
    text_mask[1, 5:] = 0
    return {"audio": (0.1 * rng.standard_normal((B, T))).astype(np.float32),
            "audio_mask": mask, "text_ids": ids, "text_mask": text_mask,
            "quality_feats": rng.standard_normal((B, 8)).astype(np.float32),
            "cond_feats": rng.standard_normal((B, 12)).astype(np.float32)}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    cfg = tiny_config()
    params = jax.tree.map(np.asarray, jm.init_model(jax.random.key(3), cfg))
    port_cfg = tcfg.from_json(jcfg.to_json(cfg))
    port_params = weights.params_from_jax(params, port_cfg, device="cpu")
    root = tmp_path_factory.mktemp("buckets")
    tex.export_buckets(port_params, port_cfg, root / "port", buckets=BUCKETS, text_tokens=8,
                       with_dsp=False, device="cpu")
    jex.export_forward(params, cfg, root / "jax_b0.2", batch_size=2, audio_seconds=0.2,
                       text_tokens=8, with_dsp=False)
    index = json.loads((root / "port" / "index.json").read_text())
    served = {e["dir"]: tex.ServingModel(root / "port" / e["dir"], device="cpu")
              for e in index["buckets"]}
    return cfg, params, root, index, served


def test_no_dsp_artifact_matches_jax_artifact(exported):
    _, _, root, _, served = exported
    batch = nodsp_batch(2, 3200, seed=2)
    got = served["b0.2s_bs2"].predict(batch)
    want = jex.ServingModel(root / "jax_b0.2").predict(batch)
    for name in tex.OUTPUTS:
        assert got[name].shape == want[name].shape and got[name].dtype == np.float32
        np.testing.assert_allclose(got[name], want[name], rtol=TOL, atol=TOL, err_msg=name)


def test_export_buckets_writes_jax_index(exported, tmp_path, monkeypatch):
    cfg, params, _, index, _ = exported
    # JAX's index.json with its per-bucket exports stubbed out: the index
    # depends only on the buckets
    monkeypatch.setattr(jex, "export_forward", lambda *a, **k: None)
    jex.export_buckets(params, cfg, tmp_path / "jax", buckets=BUCKETS, text_tokens=8,
                       with_dsp=False)
    assert index == json.loads((tmp_path / "jax" / "index.json").read_text())
    assert [b["audio_seconds"] for b in index["buckets"]] == [0.2, 0.4]


@pytest.mark.parametrize("bucket", [0, 1])
def test_each_bucket_matches_the_jax_forward(exported, bucket):
    cfg, params, _, index, served = exported
    entry = index["buckets"][bucket]
    batch = nodsp_batch(entry["batch_size"], entry["audio_samples"], seed=4 + bucket)
    out = served[entry["dir"]].predict(batch)
    want = jax.jit(lambda p, b: jm.model_forward(p, cfg, b, use_openmax=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    for name, w in (("logits", want.logits), ("uncertainty", want.uncertainty),
                    ("features", want.features)):
        np.testing.assert_allclose(out[name], np.asarray(w, np.float32), rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_no_dsp_program_holds_the_registered_stack_and_no_cond(exported):
    for model in exported[4].values():
        targets = [str(n.target) for n in model.program.graph.nodes
                   if n.op == "call_function"]
        assert targets.count("ser_torch.residual_stack.default") == 1
        assert "cond" not in targets


def test_param_tree_skeleton_roundtrip_hostile_keys():
    """The skeleton rebuilds the exact tree for keys with brackets and
    quotes and for list / tuple nesting, under JAX's own npz keys."""
    tree = {
        "weird['key]": {"kernel": np.arange(4.0)},
        "convs": [{"w": np.ones((2, 2))}, {"w": np.zeros((2, 2))}],
        "pair": ({"a": np.full(3, 7.0)}, {"b": np.full(2, 8.0)}),
        "plain": np.asarray(5.0),
    }
    port_tree = jax.tree.map(torch.from_numpy, tree)
    flat = tex._flatten_params(port_tree)
    assert set(flat) == set(jex._flatten_params(tree))
    skel = tex._skeletonize(port_tree)
    assert skel == jex._skeletonize(tree)
    rebuilt = tex._rebuild_from_skeleton(skel, flat)
    assert isinstance(rebuilt["convs"], list) and isinstance(rebuilt["pair"], tuple)
    leaves = jax.tree.leaves(rebuilt, is_leaf=torch.is_tensor)
    assert jax.tree.structure(jax.tree.map(lambda t: t.numpy(), rebuilt,
                                           is_leaf=torch.is_tensor)) == jax.tree.structure(tree)
    for a, b in zip(leaves, jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)

"""The port's train/distill.py against the JAX package's on the CPU.

Student presets give the JAX package's configs (the whole Config's JSON,
whose `mesh` section the port does not have); the KD loss is held at
1e-6; one distillation step of a dropout-free student under a tiny
teacher, with and without feature matching, at 1e-5 for the loss terms
and the train-step parity tolerance (1e-4) for the updated leaves
(leaves whose gradient is zero but for rounding, the attention key
biases, at 2 lr, as tests/test_torch_train_step.py holds them).
`distill` end to end and the CLIs are in test_torch_distill_cli.py."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import config as jconfig
from multilingual_multimodal_speech_emotion_recognition_tpu.config import TrainConfig as JTrain
from multilingual_multimodal_speech_emotion_recognition_tpu.models import (
    layers as jl)
from multilingual_multimodal_speech_emotion_recognition_tpu.train import (
    distill as jdst, optimizer as jopt)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
    distill as tdst, optimizer as topt)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import runtime

from test_model import tiny_config
from test_torch_train_step import (clone, dropout_free, jax_in_port_layout, labelled_batch,
                                   params_for, port_config, port_leaves, port_train)
from torch_port_helpers import one_torch_thread, perturb

TERM_TOL = 1e-5
STEP_TOL = 1e-4
KD_TOL = 1e-6
LR = 1e-3

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("preset", ["small", "tiny"])
@pytest.mark.parametrize("teacher", ["flagship", "tiny"])
def test_student_model_config_matches_jax(preset, teacher):
    jteacher = jconfig.ModelConfig() if teacher == "flagship" else tiny_config()
    want = json.loads(jconfig.to_json(jconfig.Config(
        model=jdst.student_model_config(jteacher, preset))))
    student = tdst.student_model_config(port_config(jteacher), preset)
    got = json.loads(tcfg.to_json(tcfg.Config(model=student)))
    assert "mesh" in want and "mesh" not in got
    del want["mesh"]
    assert got == want
    with pytest.raises(ValueError, match="preset"):
        tdst.student_model_config(port_config(jteacher), "huge")


@pytest.mark.parametrize("tau", [1.0, 4.0])
def test_kd_loss_matches_jax(tau):
    rng = np.random.default_rng(int(tau))
    s, t = (rng.standard_normal((6, 4)).astype(np.float32) * 3 for _ in range(2))
    want = float(jdst._kd_loss(jnp.asarray(s), jnp.asarray(t), tau))
    got = tdst._kd_loss(torch.from_numpy(s).to(torch.bfloat16), torch.from_numpy(t), tau)
    assert got.dtype == torch.float32
    want_bf16 = float(jdst._kd_loss(jnp.asarray(s).astype(jnp.bfloat16), jnp.asarray(t), tau))
    np.testing.assert_allclose(float(got), want_bf16, rtol=KD_TOL, atol=KD_TOL)
    got32 = tdst._kd_loss(torch.from_numpy(s), torch.from_numpy(t), tau)
    np.testing.assert_allclose(float(got32), want, rtol=KD_TOL, atol=KD_TOL)


def distill_setup(feature_match):
    """(JAX and port trees of a dropout-free tiny teacher and a 'tiny'
    student, configs), the student with its feature-matching projection."""
    jteacher_cfg = dropout_free(tiny_config())
    jstudent_cfg = dropout_free(jdst.student_model_config(jteacher_cfg, "tiny"))
    jt, tt = params_for(jteacher_cfg, seed=3)
    js, ts_ = params_for(jstudent_cfg, seed=4)
    if feature_match:
        proj = perturb(jl.init_linear(jax.random.key(5), jstudent_cfg.proj_dim,
                                      jteacher_cfg.proj_dim), np.random.default_rng(5))
        js = {**js, "distill_proj": jax.tree.map(jnp.asarray, proj)}
        ts_ = {**ts_, "distill_proj": {k: torch.from_numpy(np.array(v)) for k, v in proj.items()}}
    return jteacher_cfg, jstudent_cfg, jt, tt, js, ts_


@pytest.mark.parametrize("feature_match", [0.0, 0.5], ids=["kd_ce", "feature_match"])
def test_distill_step_matches_jax(feature_match):
    jteacher_cfg, jstudent_cfg, jt, tt, js, ts_ = distill_setup(feature_match > 0)
    train = JTrain(grad_clip=1.0)
    dcfg_kw = dict(temperature=2.0, alpha=0.7, feature_match_weight=feature_match,
                   student_preset="tiny")
    opt_kw = dict(lr=LR, total_steps=10, freeze_backbones=False, grad_clip=1.0)
    tx = jopt.make_train_optimizer(js, **opt_kw)
    jstep = jdst.make_distill_step(jteacher_cfg, jstudent_cfg, train,
                                   jdst.DistillConfig(**dcfg_kw), tx)
    batch = labelled_batch(seed=7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    js_new, _, jaux = jstep(jax.tree.map(jnp.copy, js), jt, tx.init(js), jbatch,
                            jax.random.key(0))

    student_cfg, teacher_cfg = port_config(jstudent_cfg), port_config(jteacher_cfg)
    dcfg = tdst.DistillConfig(**dcfg_kw)
    opt = topt.make_train_optimizer(ts_, **opt_kw)
    cfgs = dict(teacher_cfg=teacher_cfg, student_cfg=student_cfg, tcfg=port_train(train),
                dcfg=dcfg)
    # the gradients, to find the leaves whose gradient is rounding only
    paths = [p for p, _ in opt.trainable(ts_)]
    alias = {p: t.detach().requires_grad_(True) for p, t in opt.trainable(ts_)}
    loss, _ = tdst.distill_loss(runtime.map_leaves(ts_, lambda p, t: alias.get(p, t)), tt,
                                {k: torch.from_numpy(v) for k, v in batch.items()},
                                torch.Generator(), **cfgs)
    grads = torch.autograd.grad(loss, [alias[p] for p in paths], allow_unused=True,
                                materialize_grads=True)
    scale = max(float(g.abs().max()) for g in grads)
    degenerate = {p for p, g in zip(paths, grads) if float(g.abs().max()) < 1e-5 * scale}

    start = clone(ts_)
    teacher_before = clone(tt)
    state = opt.init(ts_)
    step = tdst.make_distill_step(teacher_cfg, student_cfg, port_train(train), dcfg, opt,
                                  device="cpu")
    aux = step(ts_, tt, state, batch, 0)
    assert set(aux) == set(jaux)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=TERM_TOL, atol=TERM_TOL,
                                   err_msg=k)
    assert (float(aux["feature_match"]) > 0) == (feature_match > 0)
    want = jax_in_port_layout({k: v for k, v in js_new.items() if k != "distill_proj"},
                              jstudent_cfg)
    if feature_match:
        for k in ("kernel", "bias"):
            want[f"distill_proj/{k}"] = torch.from_numpy(np.asarray(js_new["distill_proj"][k]))
    got = port_leaves(ts_)
    assert set(got) == set(want)
    before = port_leaves(start)
    for path, t in got.items():
        tol = 2 * LR if path in degenerate else STEP_TOL
        np.testing.assert_allclose(t.numpy(), want[path].numpy(), rtol=tol, atol=tol,
                                   err_msg=path)
        if opt.labels[path] == topt.FROZEN:
            assert torch.equal(t, before[path]), path
    assert int(state["count"]) == 1
    # the teacher is never written
    for path, t in port_leaves(tt).items():
        assert torch.equal(t, port_leaves(teacher_before)[path]), path

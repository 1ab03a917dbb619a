"""The port's per-group AdamW and schedules (train/optimizer.py) against the
JAX package's optax optimizer on the CPU: the group labels of every leaf,
both schedules at every step up to twice total_steps (1e-6), and three
AdamW steps with clipping and a bf16 first moment on the backbone groups:
parameters and f32 moments 1e-6, bf16 moments 1e-3. Where the f32 sum
before a bf16 moment's rounding differs in its last bit (the norms sum in
another order), the stored moment moves by one bf16 step (2^-8 of it), and
its parameter by at most lr * 2^-8 a step: those groups' parameters are
held to lr * 1e-3."""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.config import ModelConfig
from multilingual_multimodal_speech_emotion_recognition_tpu.models import model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu.train import optimizer as jopt
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg, weights
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import model as tm
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import optimizer as topt

from test_model import tiny_config
from torch_port_helpers import perturb

TOL = 1e-6
BF16_MU_TOL = 1e-3


def _port_config(jcfg):
    return tcfg.from_json(json.dumps(dataclasses.asdict(jcfg)))


def _plain(tree):
    """A labels tree as nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


@pytest.mark.parametrize("freeze", [True, False])
@pytest.mark.parametrize("size", ["tiny", "flagship"])
def test_param_labels_match_jax(size, freeze):
    jcfg = tiny_config() if size == "tiny" else ModelConfig()
    shapes = jax.eval_shape(lambda: jm.init_model(jax.random.key(0), jcfg))
    want = _plain(jopt.param_labels(shapes, freeze_backbones=freeze))
    got = topt.param_labels(tm.init_model(_port_config(jcfg), device="meta"),
                            freeze_backbones=freeze)
    assert got == want
    assert {v for _, v in topt.leaves_with_paths(got)} <= set(topt.GROUPS) | {topt.FROZEN}
    backbone = {v for _, v in topt.leaves_with_paths(got["audio_backbone"])}
    assert backbone == ({topt.FROZEN} if freeze else {"audio"})


@pytest.mark.parametrize("ratio", [0.1, 0.0, 0.3])
def test_warmup_cosine_schedule_matches_jax(ratio):
    total = 50
    want = jopt.warmup_cosine_schedule(1.0, total, ratio)
    got = topt.warmup_cosine_schedule(1.0, total, ratio)
    steps = np.arange(2 * total + 1)
    np.testing.assert_allclose(np.array([float(got(int(s))) for s in steps]),
                               np.asarray(jax.vmap(want)(jnp.asarray(steps))), rtol=TOL, atol=TOL)
    # a step count tensor, as the optimizer keeps it, gives the same values
    np.testing.assert_array_equal(got(torch.tensor(steps, dtype=torch.int32)).numpy(),
                                  np.array([float(got(int(s))) for s in steps], np.float32))


@pytest.mark.parametrize("cycle,warmup,min_ratio,gamma", [
    (20, 0, 0.0, 1.0), (20, 4, 0.0, 1.0), (15, 3, 0.1, 0.5)])
def test_warmup_cosine_restarts_schedule_matches_jax(cycle, warmup, min_ratio, gamma):
    kw = dict(warmup_steps=warmup, min_lr_ratio=min_ratio, gamma=gamma)
    want = jopt.warmup_cosine_restarts_schedule(1.0, cycle, **kw)
    got = topt.warmup_cosine_restarts_schedule(1.0, cycle, **kw)
    steps = np.arange(2 * 3 * cycle + 1)     # twice three cycles
    np.testing.assert_allclose(np.array([float(got(int(s))) for s in steps]),
                               np.asarray(jax.vmap(want)(jnp.asarray(steps))), rtol=TOL, atol=TOL)


def _group_moments(jax_state):
    """{path: (mu, nu)} of every leaf the optax state holds moments for,
    and the adam count; paths "/"-joined as the port keys them."""
    inner = jax_state[-1] if isinstance(jax_state, tuple) and not hasattr(
        jax_state, "inner_states") else jax_state
    out, counts = {}, set()
    for group, st in inner.inner_states.items():
        if group == "frozen":
            continue
        adam = st.inner_state[0]
        counts.add(int(adam.count))
        mus = jax.tree_util.tree_flatten_with_path(adam.mu)[0]
        nus = dict(jax.tree_util.tree_flatten_with_path(adam.nu)[0])
        for path, mu in mus:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            out[key] = (path, np.asarray(mu.astype(jnp.float32)), np.asarray(nus[path]))
    return out, counts


def _conv(path_key: str, arr: np.ndarray) -> np.ndarray:
    """A JAX leaf in the port's layout (conv kernels WIO -> OIW)."""
    parts = path_key.split("/")
    if parts[-1] == "kernel" and ("convs" in parts or "pos_conv" in parts):
        return arr.transpose(2, 1, 0)
    return arr


@pytest.mark.parametrize("freeze,mu_dtype,clip,scheduler", [
    (True, None, None, "warmup_cosine"),
    (False, "bfloat16", 0.5, "warmup_cosine"),
    (False, None, 1e-3, "cosine_restarts"),
], ids=["frozen", "unfrozen_bf16_mu_clipped", "unfrozen_restarts_clipped"])
def test_adamw_three_steps_match_optax(freeze, mu_dtype, clip, scheduler):
    cfg = tiny_config()
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(jnp.asarray, perturb(jm.init_model(jax.random.key(0), cfg), rng))
    template = tm.init_model(_port_config(cfg), device="meta")
    tparams = weights.tree_from_jax(jax.tree.map(np.asarray, jparams), template, device="cpu")
    kw = dict(lr=1e-2, total_steps=10, warmup_ratio=0.1, scheduler=scheduler, restart_steps=4,
              freeze_backbones=freeze, grad_clip=clip)
    tx = jopt.make_train_optimizer(jparams, **kw, backbone_moment_dtype=(
        jnp.bfloat16 if mu_dtype else None))
    opt = topt.make_train_optimizer(tparams, **kw, backbone_moment_dtype=(
        torch.bfloat16 if mu_dtype else None))
    jstate, tstate = tx.init(jparams), opt.init(tparams)
    trainable = dict(opt.trainable(tparams))
    assert not any(p.startswith(("classifier/weibull",)) for p in trainable)
    assert any(p.startswith("audio_backbone") for p in trainable) == (not freeze)
    assert set(tstate["mu"]) == set(trainable) == set(tstate["nu"])
    labels = jopt.param_labels(jparams, freeze_backbones=freeze)
    update = jax.jit(lambda g, st, p: (lambda u, st: (optax.apply_updates(p, u), st))(
        *tx.update(g, st, p)))
    for step in range(3):
        # a frozen leaf's gradient is 0 in training (stop_gradient, or the
        # Weibull state outside the loss), and optax's clip norm counts it
        g = jax.tree.map(lambda a, group: np.asarray(
            (0.1 * rng.standard_normal(np.shape(a))).astype(np.float32)
            * np.float32(group != "frozen")), jparams, labels)
        jparams, jstate = update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        tg = dict(topt.leaves_with_paths(weights.tree_from_jax(g, template, device="cpu")))
        opt.apply_(tparams, {p: tg[p] for p in trainable}, tstate)
    want = dict(topt.leaves_with_paths(
        weights.tree_from_jax(jax.tree.map(np.asarray, jparams), template, device="cpu")))
    for path, leaf in topt.leaves_with_paths(tparams):
        low = mu_dtype is not None and opt.labels[path] in ("audio", "text")
        tol = kw["lr"] * BF16_MU_TOL if low else TOL
        np.testing.assert_allclose(leaf.numpy(), want[path].numpy(), rtol=tol, atol=tol,
                                   err_msg=path)
    moments, counts = _group_moments(jstate)
    assert counts == {3} and int(tstate["count"]) == 3
    assert set(moments) == set(trainable)
    for path, (_, mu, nu) in moments.items():
        got_mu = tstate["mu"][path]
        low = mu_dtype is not None and opt.labels[path] in ("audio", "text")
        assert got_mu.dtype == (torch.bfloat16 if low else torch.float32)
        tol = BF16_MU_TOL if low else TOL
        np.testing.assert_allclose(got_mu.float().numpy(), _conv(path, mu), rtol=tol, atol=tol,
                                   err_msg=path)
        np.testing.assert_allclose(tstate["nu"][path].numpy(), _conv(path, nu), rtol=TOL,
                                   atol=TOL, err_msg=path)

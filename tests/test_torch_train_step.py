"""The port's train step (train/train_step.py) against the JAX package's on
the CPU, on tests/test_model.py's tiny config with JAX's parameters.

Random streams cannot match across frameworks, so the parity cases take
the dropout out (rates 0, SpecAugment off, and the quality gates and
conditioning off, whose feature projections drop out at a fixed 0.1) or
run the eval forward, or feed JAX's own draws (augment_batch). Tolerances:
compute_loss and its gradients rtol 1e-4 (f32), three train steps 1e-4,
augment_batch 1e-5 (the resampler's f32 products)."""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.config import TrainConfig as JTrain
from multilingual_multimodal_speech_emotion_recognition_tpu.models import model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu.ops import audio_dsp as jdsp
from multilingual_multimodal_speech_emotion_recognition_tpu.train import (
    optimizer as jopt, train_step as jts)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg, weights
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    layers as tl, model as tm, wav2vec2 as tw2v)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
    audio_dsp as tdsp, residual_stack as trs)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
    optimizer as topt, train_step as tts)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import runtime

from test_model import tiny_batch, tiny_config
from test_torch_audio_dsp import exact_speed_perturb_length
from torch_port_helpers import perturb
from torch_port_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_RTOL = 1e-4
STEP_TOL = 1e-4
AUG_TOL = 1e-5


def dropout_free(cfg, *, features: bool = False):
    """cfg with every dropout and SpecAugment off; without `features` also
    the quality gates and conditioning (their 0.1 dropout is fixed)."""
    out = dataclasses.replace(
        cfg, classifier_dropout=0.0, cross_dropout=0.0, fusion_dropout=0.0, anchor_dropout=0.0,
        audio=dataclasses.replace(cfg.audio, hidden_dropout=0.0, attention_dropout=0.0,
                                  activation_dropout=0.0, apply_spec_augment=False),
        text=dataclasses.replace(cfg.text, hidden_dropout=0.0, attention_dropout=0.0))
    if not features:
        out = dataclasses.replace(out, use_quality_gates=False, use_audio_conditioning=False)
    return out


def port_config(jcfg):
    return tcfg.from_json(json.dumps(dataclasses.asdict(jcfg)))


def port_train(jtrain):
    return tcfg.TrainConfig(**dataclasses.asdict(jtrain))


def params_for(jcfg, seed=0):
    """(JAX params with every leaf perturbed, the port's copy on the CPU)."""
    jp = jax.tree.map(jnp.asarray, perturb(jm.init_model(jax.random.key(seed), jcfg),
                                           np.random.default_rng(seed)))
    tp = weights.tree_from_jax(jax.tree.map(np.asarray, jp),
                               tm.init_model(port_config(jcfg), device="meta"), device="cpu")
    return jp, tp


def labelled_batch(seed=3):
    b = {k: np.asarray(v) for k, v in tiny_batch().items()}
    b["labels"] = np.random.default_rng(seed).permutation(4).astype(np.int32)
    return b


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.clone()


def port_leaves(tree):
    return dict(topt.leaves_with_paths(tree))


def jax_in_port_layout(jtree, jcfg):
    return port_leaves(weights.tree_from_jax(jax.tree.map(np.asarray, jtree),
                                             tm.init_model(port_config(jcfg), device="meta"),
                                             device="cpu"))


def port_loss_and_grads(tp, cfg, train, batch, *, paths, deterministic=False, seed=0):
    """compute_loss and its gradients at `paths`, through detached aliases."""
    alias = {}

    def swap(path, t):
        if path in paths:
            alias[path] = t.detach().requires_grad_(True)
            return alias[path]
        return t

    view = runtime.map_leaves(tp, swap)
    loss, metrics = tts.compute_loss(view, cfg, train, batch, deterministic=deterministic,
                                     generator=torch.Generator().manual_seed(seed))
    grads = torch.autograd.grad(loss, [alias[p] for p in paths], allow_unused=True,
                                materialize_grads=True)
    return loss, metrics, dict(zip(paths, grads))


@pytest.mark.parametrize("case", ["train_route", "eval_forward_with_features"])
@pytest.mark.parametrize("freeze", [True, False])
def test_compute_loss_and_gradients_match_jax(case, freeze):
    """The train route (deterministic=False, dropout out: the classifier's
    plain stack) and the eval forward (the front-end feature projections
    and fusion on), with the crema_m3 loss knobs (L2-normalised prototypes,
    softened focal) and SupCon on."""
    jcfg = dropout_free(tiny_config(), features=case != "train_route")
    train = JTrain(proto_l2_normalize=True, focal_beta=0.99, focal_gamma=1.0,
                   supcon_weight=0.1, freeze_backbones=freeze)
    deterministic = case != "train_route"
    jp, tp = params_for(jcfg)
    batch = labelled_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        return jts.compute_loss(p, jcfg, train, jb, dropout_key=jax.random.key(0),
                                deterministic=deterministic)

    (jl, jmetrics), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    cfg = port_config(jcfg)
    opt = topt.make_train_optimizer(tp, lr=1e-3, total_steps=10, freeze_backbones=freeze)
    paths = [p for p, _ in opt.trainable(tp)]
    tl_, tmetrics, tgrads = port_loss_and_grads(tp, cfg, port_train(train), batch, paths=paths,
                                                deterministic=deterministic)
    np.testing.assert_allclose(tl_.item(), float(jl), rtol=LOSS_RTOL)
    for name, got in tmetrics._asdict().items():
        np.testing.assert_allclose(got.item(), float(getattr(jmetrics, name)), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=name)
    want = jax_in_port_layout(jgrads, jcfg)
    # atol on the gradients' own scale: some are zero but for rounding (the
    # key biases, which the softmax cancels)
    scale = max(float(np.abs(want[p].numpy()).max()) for p in paths)
    for path in paths:
        np.testing.assert_allclose(tgrads[path].numpy(), want[path].numpy(), rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL * scale, err_msg=path)
    if freeze:   # JAX stops the backbones' gradients; the port never asks for them
        assert not any(p.startswith(("audio_backbone", "text_backbone")) for p in paths)
        for path, g in want.items():
            if path.startswith(("audio_backbone", "text_backbone")):
                assert not g.any(), path


@pytest.mark.parametrize("freeze,clip", [(True, None), (False, 0.5)], ids=["frozen", "unfrozen"])
def test_three_train_steps_match_jax(freeze, clip):
    """AdamW's g / sqrt(v) turns a gradient that is zero but for rounding
    (the attention key biases, which the softmax cancels) into a step of
    about lr of either sign, in both frameworks alike: those leaves are
    held to 2 lr a step; every other leaf to STEP_TOL."""
    jcfg = dropout_free(tiny_config())
    train = JTrain(freeze_backbones=freeze, grad_clip=clip)
    jp, tp = params_for(jcfg, seed=1)
    start = clone(tp)
    lr = 1e-3
    kw = dict(lr=lr, total_steps=10, freeze_backbones=freeze, grad_clip=clip)
    tx = jopt.make_train_optimizer(jp, **kw)
    jstate = tx.init(jp)
    jstep = jts.make_train_step(jcfg, train, tx, donate=False)
    opt = topt.make_train_optimizer(tp, **kw)
    state = opt.init(tp)
    step = tts.make_train_step(port_config(jcfg), port_train(train), opt, device="cpu")
    trainable = [p for p, _ in opt.trainable(tp)]
    _, _, g0 = port_loss_and_grads(tp, port_config(jcfg), port_train(train), labelled_batch(0),
                                   paths=trainable)
    scale = max(float(g.abs().max()) for g in g0.values())
    degenerate = {p for p, g in g0.items() if float(g.abs().max()) < 1e-5 * scale}
    for i in range(3):
        batch = labelled_batch(seed=i)
        jp, jstate, jm_ = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.key(i))
        m = step(tp, state, batch, i)
        np.testing.assert_allclose(float(m.loss), float(jm_.loss), rtol=STEP_TOL)
    assert int(state["count"]) == 3
    want = jax_in_port_layout(jp, jcfg)
    before = port_leaves(start)
    for path, got in port_leaves(tp).items():
        tol = 2 * lr * 3 if path in degenerate else STEP_TOL
        np.testing.assert_allclose(got.numpy(), want[path].numpy(), rtol=tol, atol=tol,
                                   err_msg=path)
        if opt.labels[path] == topt.FROZEN:
            assert torch.equal(got, before[path]), path
        elif path.startswith("classifier/layers"):
            assert not torch.equal(got, before[path]), path


class SGD(topt.AdamW):
    """Plain SGD over the same groups: its update is linear in the
    gradient, so equal updates mean equal gradients (AdamW's g / sqrt(v)
    would amplify rounding on near-zero gradients)."""

    @torch.no_grad()
    def apply_(self, params, grads, state, ok=None):
        for path, leaf in self.trainable(params):
            leaf.sub_(0.1 * grads[path])
        state["count"] += 1


def sgd(params, freeze=True):
    return SGD(topt.param_labels(params, freeze_backbones=freeze), {})


def test_grad_accum_matches_the_whole_batch_and_rejects_an_indivisible_one():
    """Focal off (its class weights are per microbatch by design) and every
    dropout out: then two microbatches give the whole batch's update."""
    cfg = port_config(dropout_free(tiny_config()))
    _, tp = params_for(dropout_free(tiny_config()), seed=2)
    batch = labelled_batch()
    outs = {}
    for accum in (1, 2):
        p = clone(tp)
        train = tcfg.TrainConfig(grad_accum=accum, focal_weight=0.0)
        m = tts.make_train_step(cfg, train, sgd(p), device="cpu")(p, {"count": torch.zeros(())},
                                                                   batch, 0)
        outs[accum] = (p, m)
    np.testing.assert_allclose(float(outs[2][1].loss), float(outs[1][1].loss), rtol=1e-5)
    assert float(outs[2][1].accuracy) == float(outs[1][1].accuracy)
    whole = port_leaves(outs[1][0])
    for path, got in port_leaves(outs[2][0]).items():
        np.testing.assert_allclose(got.numpy(), whole[path].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=path)
    step = tts.make_train_step(cfg, tcfg.TrainConfig(grad_accum=3), sgd(tp), device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        step(tp, {"count": torch.zeros(())}, batch, 0)      # B=4 is not 3 microbatches


def test_non_finite_batch_skips_everything():
    """A NaN in the audio makes the loss and the gradients non-finite: the
    parameters, both moments and the step count stay bitwise as they were,
    decided on the device without a read back."""
    jcfg = tiny_config()
    _, tp = params_for(jcfg, seed=4)
    cfg = port_config(jcfg)
    opt = topt.make_train_optimizer(tp, lr=1e-2, total_steps=10, grad_clip=1.0)
    state = opt.init(tp)
    step = tts.make_train_step(cfg, tcfg.TrainConfig(), opt, device="cpu")
    good = labelled_batch()
    for i in range(2):                          # moments and count away from zero
        step(tp, state, good, i)
    before, before_state = clone(tp), clone(state)
    bad = {**good, "audio": good["audio"].copy()}
    bad["audio"][0, 0] = np.nan
    m = step(tp, state, bad, 7)
    assert not np.isfinite(float(m.loss))
    for path, t in port_leaves(tp).items():
        assert torch.equal(t, port_leaves(before)[path]), path
    assert int(state["count"]) == int(before_state["count"]) == 2
    for k in ("mu", "nu"):
        for path, t in state[k].items():
            assert torch.equal(t, before_state[k][path]), (k, path)
    m = step(tp, state, good, 8)                # and the next finite batch applies
    assert np.isfinite(float(m.loss)) and int(state["count"]) == 3


def test_consistency_gate_is_drawn_once_per_optimizer_batch():
    """With grad_accum 2 the consistency CE's gate holds for both
    microbatches: the loss lands on the fraction-0 or the fraction-1
    endpoint, bitwise (the same draws at every fraction), never between."""
    cfg = port_config(tiny_config())
    _, tp = params_for(tiny_config(), seed=5)
    batch = labelled_batch()
    saw = set()
    for seed in range(6):
        losses = {}
        for frac in (0.0, 0.5, 1.0):
            train = tcfg.TrainConfig(grad_accum=2, focal_weight=0.0, consistency_aug_weight=0.3,
                                     consistency_aug_fraction=frac)
            p = clone(tp)
            step = tts.make_train_step(cfg, train, sgd(p), device="cpu")
            losses[frac] = float(step(p, {"count": torch.zeros(())}, batch, seed).loss)
        assert losses[1.0] > losses[0.0]
        assert losses[0.5] in (losses[0.0], losses[1.0])
        saw.add(losses[0.5] == losses[1.0])
    assert saw == {True, False}


def jax_draws(key, B, T, per_batch):
    """JAX's augment_batch draws, in its order, as the port's AugmentDraws."""
    k_sp, k_spf, k_np, k_snr, k_noise = jax.random.split(key, 5)
    n = len(tdsp.SPEED_FACTORS)
    factor = jax.random.randint(k_spf, () if per_batch else (B,), 0, n)
    return tdsp.AugmentDraws(
        speed=torch.from_numpy(np.asarray(jax.random.bernoulli(k_sp, 0.5, (B,)))),
        factor=int(factor) if per_batch else torch.from_numpy(np.asarray(factor)),
        noise=torch.from_numpy(np.asarray(jax.random.bernoulli(k_np, 0.5, (B,)))),
        snr_db=torch.from_numpy(np.asarray(jax.random.uniform(k_snr, (B,), minval=10.0,
                                                              maxval=20.0))),
        normal=torch.from_numpy(np.asarray(jax.random.normal(k_noise, (B, T), jnp.float32))))


@pytest.mark.parametrize("per_batch", [True, False], ids=["speed_per_batch", "per_sample"])
def test_augment_batch_matches_jax_on_its_draws(per_batch, monkeypatch):
    monkeypatch.setattr(jdsp, "speed_perturb_length", exact_speed_perturb_length)
    B, T = 6, 8000
    rng = np.random.default_rng(9)
    t = np.arange(T) / 16000
    wave = (0.3 * np.sin(2 * np.pi * rng.uniform(150, 900, (B, 1)) * t)
            + 0.01 * rng.standard_normal((B, T))).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    for r, keep in enumerate((8000, 7000, 5001, 4000, 7999, 6333)):
        mask[r, keep:] = 0
    wave *= mask
    seen_speed = set()
    for seed in range(4):
        key = jax.random.key(seed)
        jw, jmask = jdsp.augment_batch(key, jnp.asarray(wave), jnp.asarray(mask),
                                       speed_per_batch=per_batch)
        draws = jax_draws(key, B, T, per_batch)
        seen_speed |= set(draws.speed.tolist())
        tw, tmask = tdsp.augment_batch(torch.from_numpy(wave), torch.from_numpy(mask),
                                       draws=draws)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=AUG_TOL, atol=AUG_TOL)
    assert seen_speed == {True, False}
    # without draws: the port's own, repeatable from the generators' seeds
    g = lambda: dict(generator=torch.Generator().manual_seed(1),
                     host_generator=torch.Generator().manual_seed(2))
    a = tdsp.augment_batch(torch.from_numpy(wave), torch.from_numpy(mask),
                           speed_per_batch=per_batch, **g())
    b = tdsp.augment_batch(torch.from_numpy(wave), torch.from_numpy(mask),
                           speed_per_batch=per_batch, **g())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_dropout_keeps_at_its_rate_and_scales():
    x = torch.ones(200_000)
    for rate in (0.1, 0.25):
        y = tl.dropout(torch.Generator().manual_seed(0), x, rate, False)
        kept = y != 0
        n, p = x.numel(), 1.0 - rate
        assert abs(kept.float().mean().item() - p) < 5 * (p * (1 - p) / n) ** 0.5
        assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / p))
    assert tl.dropout(None, x, 0.1, True) is x and tl.dropout(None, x, 0.0, False) is x
    with pytest.raises(ValueError, match="Generator"):
        tl.dropout(None, x, 0.1, False)


def test_spec_augment_masks_runs_of_valid_frames():
    cfg = tcfg.Wav2Vec2Config(mask_time_prob=0.3, mask_time_length=5)
    B, T, H = 8, 300, 16
    hidden = torch.randn(B, T, H, generator=torch.Generator().manual_seed(0))
    frame_mask = torch.ones(B, T)
    valid = [300, 250, 123, 300, 77, 299, 200, 10]
    for r, n in enumerate(valid):
        frame_mask[r, n:] = 0
    embed = torch.rand(H, generator=torch.Generator().manual_seed(1)) + 5.0
    out = tw2v._spec_augment(torch.Generator().manual_seed(2), cfg, hidden, frame_mask, embed)
    masked = (out == embed).all(-1)
    assert torch.equal(out[~masked], hidden[~masked])
    total = 0
    for r, n in enumerate(valid):
        row = masked[r].tolist()
        assert not any(row[n:]), "a padded frame was masked"
        runs, start = [], None
        for i, m in enumerate(row[:n] + [False]):
            if m and start is None:
                start = i
            elif not m and start is not None:
                runs.append((start, i))
                start = None
        for a, b in runs:   # a run cut by the end of the valid frames may be shorter
            assert b - a >= cfg.mask_time_length or b == n, (r, a, b)
        total += sum(b - a for a, b in runs)
    assert total > 0


def test_training_classifier_takes_the_plain_stack_with_gradients_at_every_layer(monkeypatch):
    """deterministic=False never reaches the residual-stack kernel's wrapper
    (on the card it has no backward), and every one of the L stacked layers
    gets a gradient."""
    def no_kernel(*a, **k):
        raise AssertionError("the training forward reached the residual-stack wrapper")

    monkeypatch.setattr(trs, "residual_stack", no_kernel)
    jcfg = dataclasses.replace(tiny_config(), classifier_layers=4)
    cfg = port_config(jcfg)
    _, tp = params_for(jcfg, seed=6)
    paths = [p for p in port_leaves(tp) if p.startswith("classifier/layers/")]
    _, _, grads = port_loss_and_grads(tp, cfg, tcfg.TrainConfig(), labelled_batch(),
                                      paths=paths)
    for path in paths:
        g = grads[path]
        assert g.shape[0] == 4
        per_layer = g.reshape(4, -1).abs().sum(-1)
        assert (per_layer > 0).all(), (path, per_layer)
    with pytest.raises(AssertionError, match="residual-stack wrapper"):
        tm.model_forward(tp, cfg, labelled_batch())     # the eval forward does take it


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_gradients_of_no_remat_with_dropout_on(remat):
    """Unfrozen, every dropout and SpecAugment on, the same seed: a
    checkpointed layer replays its own draws in the backward, so remat
    changes memory, not the gradients (nor the draws after the encoders)."""
    jcfg = dataclasses.replace(tiny_config(), audio=dataclasses.replace(
        tiny_config().audio, apply_spec_augment=True, mask_time_prob=0.3, mask_time_length=3))
    _, tp = params_for(jcfg, seed=7)
    train = tcfg.TrainConfig(freeze_backbones=False)
    batch = labelled_batch()
    paths = list(port_leaves(tp))
    results = {}
    for mode in ("none", remat):
        cfg = dataclasses.replace(port_config(jcfg), remat_encoders=mode)
        loss, _, grads = port_loss_and_grads(tp, cfg, train, batch, paths=paths, seed=11)
        results[mode] = (loss, grads)
    torch.testing.assert_close(results[remat][0], results["none"][0], rtol=0, atol=0)
    for path in paths:
        torch.testing.assert_close(results[remat][1][path], results["none"][1][path],
                                   rtol=1e-6, atol=1e-7, msg=path)
    layer_grad = results["none"][1]["audio_backbone/layers/q/kernel"]
    assert layer_grad.abs().sum() > 0

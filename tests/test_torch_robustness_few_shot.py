"""The port's eval/robustness.py and eval/few_shot.py against the JAX
package's on the CPU.

Noise injection at 1e-6: babble and music are the same sums of sines in
f32; gaussian noise is fed JAX's own jax.random.normal draw. Code-mixing
feeds the model the same texts (the same random.Random stream). Few-shot
adaptation runs both frameworks over the same two batches of a
dropout-free tiny config (tests/test_torch_train_step.py's dropout_free
and bridged parameters): the trained leaves at the train-step parity
tolerance (1e-4), the frozen leaves and the caller's whole tree bitwise
unchanged."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.eval import (
    few_shot as jfs, robustness as jrob)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
    few_shot as tfs, robustness as trob)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import runtime

from test_model import tiny_batch, tiny_config
from test_torch_train_step import clone, dropout_free, params_for, port_config
from torch_port_helpers import one_torch_thread

NOISE_TOL = 1e-6
STEP_TOL = 1e-4
ADAPT_LR = 1e-3

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def wave_and_mask(B=3, T=4000, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T), np.float32)
    mask[1, T // 2:] = 0
    mask[2, 3 * T // 4:] = 0
    wave = (0.3 * rng.standard_normal((B, T))).astype(np.float32) * mask
    return wave, mask


@pytest.mark.parametrize("noise_type", ["gaussian", "babble", "music"])
@pytest.mark.parametrize("snr_db", [20.0, 0.0, -5.0])
def test_add_noise_at_snr_matches_jax(noise_type, snr_db):
    wave, mask = wave_and_mask()
    key = jax.random.key(3)
    want = np.asarray(jrob.add_noise_at_snr(key, jnp.asarray(wave), jnp.asarray(mask),
                                            jnp.float32(snr_db), noise_type=noise_type))
    draw = np.asarray(jax.random.normal(key, wave.shape, jnp.float32))
    got = trob.add_noise_at_snr(torch.from_numpy(wave), torch.from_numpy(mask), snr_db,
                                noise_type=noise_type, noise=torch.from_numpy(draw.copy()))
    assert got.dtype == torch.float32 and got.shape == wave.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=NOISE_TOL, atol=NOISE_TOL)
    # the mask is honoured: padded samples stay as they were (zero)
    assert (got.numpy()[mask == 0] == 0).all()
    # the noise power sits at the target SNR over the valid samples
    noise = (got.numpy() - wave) * mask
    ratio = (wave ** 2).sum(-1) / (noise ** 2).sum(-1)
    if noise_type != "gaussian":
        np.testing.assert_allclose(10 * np.log10(ratio), snr_db, atol=1e-3)


def test_add_noise_at_snr_gaussian_draws_from_the_generator():
    wave, mask = wave_and_mask()
    x, m = torch.from_numpy(wave), torch.from_numpy(mask)
    draws = [trob.add_noise_at_snr(x, m, 10.0, generator=torch.Generator().manual_seed(5))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    g = torch.Generator().manual_seed(5)
    first, second = (trob.add_noise_at_snr(x, m, 10.0, generator=g) for _ in range(2))
    assert not torch.equal(first, second)
    # a per-row SNR tensor
    per_row = trob.add_noise_at_snr(x, m, torch.tensor([10.0, 10.0, 10.0]),
                                    noise_type="music")
    assert torch.equal(per_row, trob.add_noise_at_snr(x, m, 10.0, noise_type="music"))


TEXTS = ["the cat is on the mat and it is good", "a big dog with the small ball",
         "happy words", "the end", "it is from up to down", ""]


@pytest.mark.parametrize("language", ["hi", "bn"])
def test_code_mixing_feeds_the_texts_jax_feeds(language):
    labels = np.array([0, 1, 2, 3, 0, 1])
    seen = {"port": [], "jax": []}

    def predictor(name):
        def predict(texts):
            seen[name].append(list(texts))
            h = np.array([len(t) % 4 for t in texts])
            p = np.full((len(texts), 4), 0.1)
            p[np.arange(len(texts)), h] = 0.7
            return {"preds": h, "probs": p}
        return predict

    got = trob.evaluate_code_mixing(predictor("port"), TEXTS, labels, target_language=language,
                                    baseline_f1=0.8, seed=4)
    want = jrob.evaluate_code_mixing(predictor("jax"), TEXTS, labels, target_language=language,
                                     baseline_f1=0.8, seed=4)
    assert seen["port"] == seen["jax"]
    assert seen["port"][-1] != TEXTS          # ratio 1 substituted words
    assert got == want
    assert trob.ood_trigger_rate(np.array([[0.4, 0.6], [0.45, 0.55], [0.3, 0.3]])) == \
        jrob.ood_trigger_rate(np.array([[0.4, 0.6], [0.45, 0.55], [0.3, 0.3]]))


def test_noise_sweep_draws_one_generator_in_order():
    """evaluate_noise_robustness seeds one generator and the batches draw
    from it in order: a rerun repeats, another seed differs."""
    wave, mask = wave_and_mask()
    batches = [{"audio": wave, "audio_mask": mask, "labels": np.array([0, 1, 2])}] * 2

    def run(seed):
        seen = []

        def predict(batch, generator, snr_db, noise_type):
            noisy = trob.add_noise_at_snr(torch.from_numpy(batch["audio"]),
                                          torch.from_numpy(batch["audio_mask"]), snr_db,
                                          noise_type=noise_type, generator=generator)
            seen.append(noisy)
            return {"preds": np.array([0, 1, 1]), "probs": np.full((3, 2), 0.5),
                    "labels": batch["labels"]}

        res = trob.evaluate_noise_robustness(predict, batches, snr_levels=(10.0, 0.0),
                                             noise_types=("gaussian", "babble"),
                                             baseline_f1=0.9, seed=seed, device="cpu")
        return res, seen

    (r1, s1), (r2, s2), (_, s3) = run(0), run(0), run(1)
    assert r1 == r2 and set(r1) == {"gaussian", "babble"} and set(r1["babble"]) == {"10dB", "0dB"}
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))
    assert not torch.equal(s1[0], s1[1])          # the second batch took new draws
    assert not torch.equal(s1[0], s3[0])
    assert torch.equal(s1[4], s3[4])              # babble draws nothing
    mixing = {"ratio_0": {"weighted_f1": 0.5, "ood_trigger_rate": 0.1}}
    assert trob.robustness_report(r1, mixing) == jrob.robustness_report(r1, mixing)


def adapt_batches(seed=5):
    """Two labelled batches, the second with a padded row (example_mask 0)."""
    out = []
    for i in range(2):
        b = {k: np.asarray(v) for k, v in tiny_batch().items()}
        b["labels"] = np.random.default_rng(seed + i).permutation(4).astype(np.int32)
        b["example_mask"] = np.array([1, 1, 1, 0 if i else 1], np.float32)
        out.append(b)
    return out


def test_adapt_matches_jax_and_leaves_the_base_untouched():
    jcfg = dropout_free(tiny_config())
    jp, tp = params_for(jcfg, seed=2)
    batches = adapt_batches()
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    jadapted = jfs.adapt(jp, jcfg, lambda: jb, num_epochs=1, lr=ADAPT_LR, seed=42)
    before = clone(tp)
    got = tfs.adapt(tp, port_config(jcfg), lambda: batches, num_epochs=1, lr=ADAPT_LR,
                    seed=42)
    want = dict(runtime.leaves_with_paths(
        jax.tree.map(np.asarray, jadapted)))
    moved = 0
    for path, t in runtime.leaves_with_paths(got):
        base = dict(runtime.leaves_with_paths(before))[path]
        if path.split("/")[0] in tfs.TRAINABLE:
            moved += not torch.equal(t, base)
        else:
            assert torch.equal(t, base), f"frozen leaf {path} changed"
    assert moved > 10
    # the caller's tree is bitwise unchanged (the clone before the in-place update)
    for path, t in runtime.leaves_with_paths(tp):
        assert torch.equal(t, dict(runtime.leaves_with_paths(before))[path]), path
    # the trained leaves against JAX's, through the bridge's layout
    from test_torch_train_step import jax_in_port_layout
    jw = jax_in_port_layout(jadapted, jcfg)
    assert set(jw) == {p for p, _ in runtime.leaves_with_paths(got)}
    for path, t in runtime.leaves_with_paths(got):
        np.testing.assert_allclose(t.numpy(), jw[path], rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=path)
    assert len(want) == len(jw)


def test_adaptation_labels_and_optimizer():
    jcfg = dropout_free(tiny_config())
    _, tp = params_for(jcfg)
    labels = tfs.adaptation_labels(tp)
    for path, label in runtime.leaves_with_paths(labels):
        assert label == ("train" if path.split("/")[0] in tfs.TRAINABLE else "frozen"), path
    opt = tfs.make_adapt_optimizer(tp, 1e-4)
    assert opt.groups == {"train": (1.0, 0.01)}
    assert {p.split("/")[0] for p, _ in opt.trainable(tp)} == set(tfs.TRAINABLE)


def test_few_shot_suite_adapts_every_k_from_the_base():
    jcfg = dropout_free(tiny_config())
    _, tp = params_for(jcfg, seed=1)
    cfg = port_config(jcfg)
    before = clone(tp)
    pool = adapt_batches(seed=9)
    seen = {}

    def make_batches(indices):
        return pool[:1 + len(indices) % 2]

    def evaluate(p, indices):
        seen[len(indices)] = clone({k: p[k] for k in tfs.TRAINABLE})
        return {"f1": 0.5 + 0.01 * len(indices), "accuracy": 0.6}

    results = tfs.run_few_shot_suite(tp, cfg, make_batches=make_batches, evaluate=evaluate,
                                     n_items=12, shots=[3, 4, 3], zero_shot_f1=0.4,
                                     full_ft_f1=0.7, num_epochs=1)
    assert [r.num_shots for r in results] == [3, 4, 3]
    assert [r.recovery_rate for r in results] == pytest.approx(
        [tfs.recovery_rate(0.4, 0.5 + 0.01 * (12 - k), 0.7) for k in (3, 4, 3)])
    for path, t in runtime.leaves_with_paths(tp):
        assert torch.equal(t, dict(runtime.leaves_with_paths(before))[path]), path
    # each K's adapted tree is adapt() from the base alone
    for k in (3, 4):
        shot_idx, eval_idx = tfs.select_shots(12, k)
        alone = tfs.adapt(tp, cfg, lambda: make_batches(shot_idx), num_epochs=1)
        for path, t in runtime.leaves_with_paths(seen[len(eval_idx)]):
            assert torch.equal(t, dict(runtime.leaves_with_paths(
                {k2: alone[k2] for k2 in tfs.TRAINABLE}))[path]), (k, path)
    assert tfs.select_shots(12, 4) == jfs.select_shots(12, 4)
    assert tfs.few_shot_report(results) == jfs.few_shot_report(
        [jfs.FewShotResult(**vars(r)) for r in results])

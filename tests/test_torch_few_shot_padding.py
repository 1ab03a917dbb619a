"""Few-shot adaptation on the loader's partial batches, on the CPU.

data/pipeline.BucketedLoader pads a partial batch with rows of one valid
sample (example_mask 0). The conv extractor gives such a row zero frames,
so every key of its attention is masked and its logits are NaN, in the JAX
package as in the port (held here against JAX on the loader's own batch).
Weighed by example_mask 0 in the CE, 0 x NaN made the loss and every adapted
leaf NaN; the port's eval/few_shot.adapt_loss drops those rows before the
forward instead. Its adapted leaves are held against an adapt over the same
batches with the padded rows cut away by hand, at
test_torch_robustness_few_shot's step tolerance (1e-4)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.config import DataConfig as JData
from multilingual_multimodal_speech_emotion_recognition_tpu.data import (
    pipeline as jpipe, tokenizer as jtok)
from multilingual_multimodal_speech_emotion_recognition_tpu.models import model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
    audio_io, manifest, pipeline as tpipe, tokenizer as ttok)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import few_shot as tfs
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import model as tm
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils import runtime

from test_model import tiny_config
from test_torch_robustness_few_shot import ADAPT_LR, STEP_TOL
from test_torch_train_step import dropout_free, params_for, port_config
from torch_port_helpers import one_torch_thread

SR = 16000
CLIPS = 7                 # batches of 4 and 3 + one padded row
BATCH = 4
CLIP_SECONDS = 0.2
TEXTS = ["the angry one", "el gato feliz", "the sad words", "plain neutral"]
LOGIT_TOL = 1e-4

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """CLIPS clips of 0.2 s, a tone per class, in one 0.25 s bucket; the
    two packages' data configs and the manifest's path."""
    root = tmp_path_factory.mktemp("few_shot_padding")
    wavdir = root / "datasets" / "synth"
    wavdir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    items = []
    for i in range(CLIPS):
        label = i % 4
        t = np.arange(int(SR * CLIP_SECONDS)) / SR
        x = 0.4 * np.sin(2 * np.pi * [300, 600, 1200, 2400][label] * t)
        x = (x + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
        audio_io.write_wav(wavdir / f"a{i:02d}.wav", x, SR)
        items.append({"audio": f"synth/a{i:02d}.wav", "text": TEXTS[label],
                      "label": label, "dataset": "synth"})
    manifest.write_manifest(root / "train.jsonl", items)
    kw = dict(audio_buckets=(0.25,), min_audio_seconds=CLIP_SECONDS, max_text_tokens=12,
              dataset_root=str(root / "datasets"))
    return str(root / "train.jsonl"), JData(**kw), tcfg.DataConfig(**kw)


def port_batches(data, shuffle=True):
    """One epoch of the port's loader, as the academic battery's few-shot
    part draws its batches (shuffled, seed 42, without 'indices')."""
    path, _, dcfg = data
    loader = tpipe.BucketedLoader(tpipe.SERDataset(path, dcfg), batch_size=BATCH,
                                  tokenizer=ttok.HashTokenizer(vocab_size=100),
                                  shuffle=shuffle, seed=42)
    return [{k: v for k, v in b.items() if k != "indices"} for b in loader.epoch(0)]


def cut_by_hand(batch):
    keep = batch["example_mask"] > 0
    return {k: v[keep] for k, v in batch.items() if k != "example_mask"}


def test_adapt_on_the_loaders_partial_batch_is_finite_and_drops_the_padded_rows(data):
    batches = port_batches(data)
    masks = [b["example_mask"] for b in batches]
    assert [m.tolist() for m in masks if not m.all()] == [[1, 1, 1, 0]]
    jcfg = dropout_free(tiny_config())
    cfg = port_config(jcfg)
    _, params = params_for(jcfg, seed=3)
    got = tfs.adapt(params, cfg, lambda: batches, num_epochs=2, lr=ADAPT_LR)
    cut = [cut_by_hand(b) for b in batches]
    want = dict(runtime.leaves_with_paths(
        tfs.adapt(params, cfg, lambda: cut, num_epochs=2, lr=ADAPT_LR)))
    base = dict(runtime.leaves_with_paths(params))
    moved = 0
    for path, t in runtime.leaves_with_paths(got):
        if path.split("/")[0] in tfs.TRAINABLE:
            assert torch.isfinite(t).all(), path
            moved += not torch.equal(t, base[path])
        np.testing.assert_allclose(t.numpy(), want[path].numpy(), rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=path)
    assert moved > 10
    partial = next(b for b in batches if not b["example_mask"].all())
    assert torch.isfinite(tfs.adapt_loss(params, cfg, partial, torch.Generator()))


def test_padded_row_is_nan_in_both_packages_and_real_rows_agree(data):
    """The cause: the loader's padded row has zero frames and NaN logits in
    JAX's forward and the port's alike; the real rows agree at 1e-4. The
    config runs the front-end DSP, as the battery's does."""
    path, jdata, _ = data
    jloader = jpipe.BucketedLoader(jpipe.SERDataset(path, jdata), batch_size=BATCH,
                                   tokenizer=jtok.HashTokenizer(vocab_size=100),
                                   shuffle=False)
    jbatch = list(jloader.epoch(0))[-1]
    batch = port_batches(data, shuffle=False)[-1]
    for k, v in batch.items():
        np.testing.assert_array_equal(v, np.asarray(jbatch[k]), err_msg=k)
    padded = batch["example_mask"] == 0
    assert padded.tolist() == [False, False, False, True]
    assert batch["audio_mask"][padded].sum() == 1

    jcfg = tiny_config(frontend_dsp=True)
    jp, params = params_for(jcfg, seed=4)
    fwd = {k: v for k, v in batch.items() if k not in ("labels", "example_mask", "indices")}
    want = np.asarray(jax.jit(lambda p, b: jm.model_forward(p, jcfg, b).logits)(
        jp, {k: jnp.asarray(v) for k, v in fwd.items()}))
    got = tm.model_forward(params, port_config(jcfg), fwd).logits.numpy()
    assert np.isnan(want[padded]).all() and np.isnan(got[padded]).all()
    assert np.isfinite(want[~padded]).all() and np.isfinite(got[~padded]).all()
    np.testing.assert_allclose(got[~padded], want[~padded], rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_a_batch_with_no_real_row_raises(data):
    jcfg = dropout_free(tiny_config())
    _, params = params_for(jcfg)
    empty = {**port_batches(data)[0], "example_mask": np.zeros(BATCH, np.float32)}
    with pytest.raises(ValueError, match="no real row"):
        tfs.adapt(params, port_config(jcfg), lambda: [empty], num_epochs=1)


def test_real_rows_indexes_every_per_row_key(data):
    """numpy arrays and tensors alike; a full batch comes back as it is."""
    partial = next(b for b in port_batches(data) if not b["example_mask"].all())
    keep = partial["example_mask"] > 0
    assert tfs.real_rows({"audio": partial["audio"]})["audio"] is partial["audio"]
    full = {**partial, "example_mask": np.ones(BATCH, np.float32)}
    assert tfs.real_rows(full) is full
    for batch in (partial, {k: torch.from_numpy(v) for k, v in partial.items()}):
        got = tfs.real_rows(batch)
        assert set(got) == set(batch)
        for k, v in partial.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v[keep], err_msg=k)

"""The port's tensor parallelism on the mesh's 'model' axis
(parallel/tensor.py: Megatron's column / row split of both encoders and the
cross-modal attention) on gloo ranks on the CPU.

The tiny model of tests/test_model.py and its WavLM variant (gated relative
position bias, stable layer norm, layer-norm extractor) run on meshes
(1, 2) and (2, 2): the forward against the JAX package's model_forward on a
mesh of the same shape, as tests/test_model.py runs it, within rtol 1e-5 /
atol 1e-6 in f32; one train step (FSDP over 'data' on (2, 2)) against the
port's one-process step (the reduced gradients rtol 1e-4 / atol 5e-7, as
tests/test_torch_parallel.py holds the (1, 2) step's, and their norm rtol
1e-5; loss rtol 1e-5; parameters rtol 1e-4 / atol 1e-5, the attention key
biases, which a softmax cancels, 2 lr), with no 'model'-sharded leaf
gathered whole; the manifest eval's rows each once, equal to
one process's. Two RankPools (tests/torch_port_helpers.py), one of two and
one of four ranks, each spawned once for the module."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu import config as jcfg
from multilingual_multimodal_speech_emotion_recognition_tpu.config import TrainConfig as JTrain
from multilingual_multimodal_speech_emotion_recognition_tpu.models import model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu.parallel import mesh as jmesh
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
    audio_io, manifest as tman)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
    evaluate as tev)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import model as tm
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.parallel import (
    mesh as tmesh, multihost as tmh, tensor as ttp)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
    optimizer as topt, train_step as tts)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
    leaves_with_paths)

from test_model import tiny_batch, tiny_config
from test_torch_parallel import KEY_BIASES, _assert_grads, _grads
from test_torch_train_step import clone, dropout_free, params_for, port_config
from torch_port_helpers import RankPool, one_torch_thread, two_ranks

pytestmark = pytest.mark.usefixtures("one_torch_thread")

#: the leaves the 'model' rule shards, and the dimension it shards (the
#: first suffix that matches: pos_conv's kernel is torch's [C_out, C_in/g, K])
SHARDED = {"pos_conv/kernel": 0, "q/kernel": -1, "k/kernel": -1, "v/kernel": -1,
           "ffn_in/kernel": -1, "out/kernel": -2}


@pytest.fixture(scope="module")
def four_ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


def wavlm_config():
    """tiny_config with the WavLM-Large preset's flags at its widths."""
    base = tiny_config()
    audio = dataclasses.replace(jcfg.wavlm_large_audio_config(),
                                **{k: getattr(base.audio, k) for k in (
                                    "conv_dim", "conv_stride", "conv_kernel", "hidden_size",
                                    "num_hidden_layers", "num_attention_heads",
                                    "intermediate_size", "num_conv_pos_embeddings",
                                    "num_conv_pos_embedding_groups", "apply_spec_augment")},
                                num_buckets=16, max_bucket_distance=40)
    return dataclasses.replace(base, audio=audio)


CONFIGS = {"base": tiny_config, "wavlm": wavlm_config}


def _local_rows(batch, mesh):
    index, count = ttp.data_shard(mesh)
    rows = next(iter(batch.values())).shape[0] // count
    return {k: v[index * rows:(index + 1) * rows] for k, v in batch.items()}


def _numpy(tree):
    return {p: v.detach().float().numpy() for p, v in leaves_with_paths(tree)}


# ------------------------------------------------------------ rank side

def rank_forward(params, batch, cfg, shape):
    """The tensor-parallel eval forward of this rank's rows, the logits
    gathered over 'data', and the local shapes of the sharded leaves."""
    mesh = tmesh.make_mesh(data=shape[0], model=shape[1], device="cpu")
    view, tp = ttp.split(tmesh.shard_params(params, mesh))
    local = _local_rows(batch, mesh)
    with torch.inference_mode():
        logits = tm.model_forward(view, cfg, local, tp=tp).logits.numpy()
    logits = tev.gather_rows({"l": logits}, mesh, [len(logits)])["l"]
    shapes = {p: tuple(t.shape) for p, t in leaves_with_paths(view)
              if p.endswith(tuple(SHARDED))}
    return logits, shapes


def rank_step(params, batch, model_cfg, train_cfg, shape, fsdp):
    """One train step on the mesh: (loss, the parameters gathered whole
    afterwards, every redistribution in the step that gathered a leaf's
    'model' shards, the reduced gradients gathered whole and their norm)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = tmesh.make_mesh(data=shape[0], model=shape[1], device="cpu")
    p = tmesh.shard_params(params, mesh, fsdp=fsdp, fsdp_min_size=1)
    opt = topt.make_train_optimizer(p, lr=1e-3, total_steps=10,
                                    freeze_backbones=train_cfg.freeze_backbones,
                                    grad_clip=train_cfg.grad_clip)
    state = opt.init(p)
    rows, tp = tts.RowGather(mesh), ttp.model_group(mesh)
    grads = _grads(p, [q for q, _ in opt.trainable(p)], mesh, lambda v: tts.compute_loss(
        v, model_cfg, train_cfg, _local_rows(batch, mesh), generator=torch.Generator(),
        rows=rows, tp=tp)[0])
    step = tts.make_train_step(model_cfg, train_cfg, opt, device="cpu")
    gathered = []
    model_dim = mesh.mesh_dim_names.index(tmesh.MODEL_AXIS)
    redistribute, full_tensor = DTensor.redistribute, DTensor.full_tensor

    def record(t, to):
        if t.placements[model_dim].is_shard() and not to[model_dim].is_shard():
            gathered.append(tuple(t.shape))

    def spy_redistribute(self, device_mesh=None, placements=None, **kw):
        record(self, placements)
        return redistribute(self, device_mesh, placements, **kw)

    def spy_full_tensor(self, **kw):
        record(self, [Replicate()] * len(self.placements))
        return full_tensor(self, **kw)

    DTensor.redistribute, DTensor.full_tensor = spy_redistribute, spy_full_tensor
    try:
        metrics = step(p, state, tmesh.shard_batch(_local_rows(batch, mesh), mesh), 0)
    finally:
        DTensor.redistribute, DTensor.full_tensor = redistribute, full_tensor
    return float(metrics.loss), _numpy(tmh.host_replicated(p)), gathered, grads


def rank_evaluate(params, cfg, manifest):
    out = tev.evaluate_manifest(params, cfg, manifest, batch_size=4, verbose=False,
                                device="cpu")
    return {k: out[k] for k in ("logits", "labels", "indices", "weighted_f1")}


def rank_indivisible():
    """The ValueError shard_params raises for a leaf whose 'model'-sharded
    dimension the axis does not divide."""
    mesh = tmesh.make_mesh(data=1, model=2, device="cpu")
    try:
        tmesh.shard_params({"enc": {"q": {"kernel": torch.zeros(4, 3)}}}, mesh)
    except ValueError as e:
        return str(e)
    return None


# ------------------------------------------------------------ tests

@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["mesh1x2", "mesh2x2"])
def test_tensor_parallel_forward_matches_jax(two_ranks, four_ranks, shape, name):
    jc = CONFIGS[name]()
    jp, params = params_for(jc, seed=5)
    jbatch = tiny_batch(B=4)
    mesh = jmesh.make_mesh(jax.devices()[:shape[0] * shape[1]], data=shape[0], model=shape[1])
    want = np.asarray(jax.jit(lambda p, b: jm.model_forward(p, jc, b).logits)(
        jmesh.shard_params(jp, mesh), jmesh.shard_batch(jbatch, mesh)))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    pool = two_ranks if shape == (1, 2) else four_ranks
    whole = dict(leaves_with_paths(params))
    for logits, shapes in pool.run(rank_forward, params, batch, port_config(jc), shape):
        np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-6)
        assert len(shapes) == 6 * 2 + 1 + 4 * 2   # both stacks, pos_conv, both cross blocks
        for path, got in shapes.items():
            dim = next(d for suffix, d in SHARDED.items() if path.endswith(suffix))
            full = list(whole[path].shape)
            full[dim] //= 2
            assert list(got) == full, path


@pytest.mark.parametrize("shape,fsdp", [((1, 2), False), ((2, 2), True)],
                         ids=["mesh1x2", "mesh2x2_fsdp"])
def test_tensor_parallel_train_step_equals_one_process(two_ranks, four_ranks, shape, fsdp):
    jcfg_ = dropout_free(tiny_config())
    cfg = port_config(jcfg_)
    train = tcfg.TrainConfig(**dataclasses.asdict(JTrain(
        augment=False, freeze_backbones=False, supcon_weight=0.1, grad_clip=1.0)))
    _, params = params_for(jcfg_, seed=0)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in tiny_batch(B=8).items()}
    batch["labels"] = torch.from_numpy(np.arange(8) % cfg.num_labels).int()
    start = clone(params)
    opt = topt.make_train_optimizer(params, lr=1e-3, total_steps=10, freeze_backbones=False,
                                    grad_clip=1.0)
    want_grads = _grads(params, [p for p, _ in opt.trainable(params)], None, lambda v: (
        tts.compute_loss(v, cfg, train, batch, generator=torch.Generator())[0]))
    step = tts.make_train_step(cfg, train, opt, device="cpu")
    want_loss = float(step(params, opt.init(params), batch, 0).loss)
    want = _numpy(params)
    pool = two_ranks if shape == (1, 2) else four_ranks
    for loss, got, gathered, grads in pool.run(rank_step, start, batch, cfg, train, shape,
                                               fsdp):
        assert gathered == [], "a 'model'-sharded leaf was gathered whole in the step"
        _assert_grads(grads, want_grads, atol=5e-7)
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        assert got.keys() == want.keys()
        for path in want:
            tol = (dict(rtol=2e-3, atol=2e-3) if path.endswith(KEY_BIASES)
                   else dict(rtol=1e-4, atol=1e-5))
            np.testing.assert_allclose(got[path], want[path], err_msg=path, **tol)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_clips")
    wavdir = root / "datasets" / "synth"
    wavdir.mkdir(parents=True)
    rng = np.random.default_rng(6)
    items = []
    for i in range(10):
        label = i % 4
        n = int(16000 * (0.5 + 0.05 * i))
        t = np.arange(n) / 16000
        x = 0.4 * np.sin(2 * np.pi * 200.0 * (label + 1) * t) + 0.02 * rng.standard_normal(n)
        audio_io.write_wav(wavdir / f"c{i:02d}.wav", x.astype(np.float32), 16000)
        items.append({"audio": f"synth/c{i:02d}.wav", "text": f"words {label}", "label": label})
    tman.write_manifest(root / "m.jsonl", items)
    return root


def test_manifest_eval_rows_once_on_a_model_group(four_ranks, clips):
    """evaluate_manifest (collect_logits) on the (2, 2) mesh of the config:
    every clip's row comes back once, in one process's order, with its
    logits (rtol 1e-5 / atol 1e-6), label and the F1 (exactly)."""
    cfg = tcfg.Config(model=port_config(tiny_config()),
                      data=tcfg.DataConfig(dataset_root=str(clips / "datasets")),
                      mesh=tcfg.MeshConfig(model_axis=2))
    params = tm.init_model(cfg.model, torch.Generator().manual_seed(0), device="cpu")
    manifest = str(clips / "m.jsonl")
    want = rank_evaluate(params, cfg, manifest)
    assert len(want["indices"]) == 10
    for got in four_ranks.run(rank_evaluate, params, cfg, manifest):
        np.testing.assert_array_equal(got["indices"], want["indices"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5, atol=1e-6)
        assert got["weighted_f1"] == want["weighted_f1"]


def test_an_axis_that_does_not_divide_a_leaf_raises_naming_it(two_ranks):
    cfg = port_config(tiny_config())
    with pytest.raises(ValueError, match="audio_backbone/layers/q/kernel's 4 heads.*"
                                         "audio_backbone/pos_conv/kernel's 4 groups"):
        ttp.check_model_axis(cfg, 3)
    ttp.check_model_axis(cfg, 2)
    with pytest.raises(ValueError, match="attention heads: 4 is not divisible"):
        ttp.ModelGroup(None, 0, 3).span(4, "attention heads")
    for err in two_ranks.run(rank_indivisible):
        assert err is not None and err.startswith("enc/q/kernel: the 'model' axis of 2")

"""The port's sharded training (the train step, loop, CLI, evaluate_manifest
and distill under a process group, parallel/multihost.py's collectives) on
two gloo ranks on the CPU, against the port's one-process runs.

The ranks are one RankPool (tests/torch_port_helpers.py), spawned once for
the module; each check below runs a module-level function on both ranks.
Tolerances: the sharded train step's loss rtol 1e-5, its parameters rtol
1e-4, atol 1e-5 (JAX's FSDP test; a bias that a softmax cancels at 2 lr a
step); allgather_rows, the checkpoint and the F1s exactly. The ring and
pipeline stacks are in test_torch_parallel_stacks.py."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from multilingual_multimodal_speech_emotion_recognition_tpu.config import TrainConfig as JTrain
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli import train as tcli
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
    audio_io, manifest as tman)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.eval import (
    evaluate as tev)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    layers as tl, model as tm)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.parallel import (
    mesh as tmesh, multihost as tmh, tensor as ttp)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
    checkpoint as tckpt, distill as tdst, loop as tloop, optimizer as topt,
    train_step as tts)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
    leaves_with_paths)

from test_model import tiny_batch, tiny_config
from test_torch_train_step import clone, dropout_free, params_for, port_config
from torch_port_helpers import one_torch_thread, two_ranks

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(11)
#: the gradient of a bias that a softmax cancels (the attention keys', the
#: pooling scores') is zero but for rounding, which AdamW turns into a step
#: of about lr of either sign: those leaves are held to 2 lr a step
#: (tests/test_torch_train_step.py)
KEY_BIASES = ("k/bias", "k_a/bias", "k_t/bias", "pool_a/w2/bias", "pool_t/w2/bias")


def _numpy(tree):
    return {p: v.detach().float().numpy() for p, v in leaves_with_paths(tree)}


def _grads(params, paths, mesh, loss_of):
    """The gradients of loss_of(view) at `paths` (reduced onto the
    parameters' placements under a mesh, then gathered whole) and their
    global norm, as the train step computes them."""
    view, inputs = tts.trainable_view(params, paths, mesh)
    g = torch.autograd.grad(loss_of(view), inputs, allow_unused=True, materialize_grads=True)
    leaves = dict(leaves_with_paths(params))
    g = tts.reduce_grads(g, [leaves[p] for p in paths], mesh)
    return _numpy(tmh.host_replicated(dict(zip(paths, g)))), float(topt.global_norm(g))


def _local_rows(batch, mesh):
    n, r = mesh["data"].size(), mesh["data"].get_local_rank()
    rows = next(iter(batch.values())).shape[0] // n
    return {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}


def _assert_grads(got, want, atol=1e-7):
    (g, gn), (w, wn) = got, want
    assert g.keys() == w.keys()
    for path in w:
        np.testing.assert_allclose(g[path], w[path], rtol=1e-4, atol=atol, err_msg=path)
    np.testing.assert_allclose(gn, wn, rtol=1e-5)


# ------------------------------------------------------------ rank side

def rank_train_step(params, batch, model_cfg, train_cfg, shape):
    mesh = tmesh.make_mesh(data=shape[0], model=shape[1], device="cpu")
    p = tmesh.shard_params(params, mesh, fsdp=True, fsdp_min_size=1)
    opt = topt.make_train_optimizer(p, lr=1e-3, total_steps=10,
                                    freeze_backbones=train_cfg.freeze_backbones,
                                    grad_clip=train_cfg.grad_clip)
    state = opt.init(p)
    local = _local_rows(batch, mesh)
    rows, tp = tts.RowGather(mesh), ttp.model_group(mesh)
    grads = _grads(p, [q for q, _ in opt.trainable(p)], mesh, lambda v: tts.compute_loss(
        v, model_cfg, train_cfg, local, generator=torch.Generator(), rows=rows, tp=tp)[0])
    step = tts.make_train_step(model_cfg, train_cfg, opt, device="cpu")
    metrics = step(p, state, tmesh.shard_batch(local, mesh), 0)
    from torch.distributed.tensor import DTensor, Shard
    sharded = [path for path, m in state["mu"].items()
               if isinstance(m, DTensor) and any(isinstance(pl, Shard) for pl in m.placements)]
    return float(metrics.loss), _numpy(tmh.host_replicated(p)), sharded, grads


def rank_collectives(root):
    r = dist.get_rank()
    rows = np.arange(3 * (r + 1), dtype=np.float32).reshape(r + 1, 3) + 100 * r
    gathered = tmh.allgather_rows(rows)
    flags = (tmh.any_process(r == 1), tmh.any_process(False))
    mesh = tmesh.make_mesh(device="cpu")
    params = {"a": {"kernel": torch.arange(24.0).reshape(4, 6)}, "b": torch.ones(3)}
    sharded = tmesh.shard_params(params, mesh, fsdp=True, fsdp_min_size=1)
    tckpt.save_checkpoint(Path(root) / f"ck{r}", params=sharded, step=3)
    dist.barrier()
    back, meta = tckpt.restore_checkpoint(Path(root) / "ck0", device="cpu")
    return (gathered, flags, sorted(p.name for p in Path(root).iterdir()),
            _numpy(back), meta["step"])


def rank_evaluate(params, cfg, manifest):
    out = tev.evaluate_manifest(params, cfg, manifest, batch_size=4, calibrate=True,
                                val_manifest=manifest, verbose=False, device="cpu")
    return {k: out[k] for k in ("logits", "labels", "indices", "weighted_f1", "temperature")}


def rank_distill(teacher, cfg, manifest, save_dir):
    res = tdst.distill(teacher, cfg, train_manifest=manifest, val_manifest=manifest,
                       dcfg=tdst.DistillConfig(student_preset="tiny", feature_match_weight=0.1),
                       train_cfg=tcfg.TrainConfig(epochs=1, batch_size=4, save_dir=save_dir),
                       progress=False, device="cpu")
    return res["best_f1"], _numpy(tmh.host_replicated(res["params"]))


def rank_distill_grads(student, teacher, teacher_cfg, student_cfg, train, batch):
    mesh = tmesh.make_mesh(device="cpu")
    p = tmesh.shard_params(student, mesh, fsdp=True, fsdp_min_size=1)
    local, rows = _local_rows(batch, mesh), tts.RowGather(mesh)
    return _grads(p, [q for q, _ in leaves_with_paths(student)], mesh,
                  lambda v: _distill_loss(v, teacher, local, teacher_cfg, student_cfg, train,
                                          rows))


def _distill_loss(params, teacher, batch, teacher_cfg, student_cfg, train, rows):
    return tdst.distill_loss(params, teacher, batch, torch.Generator(), teacher_cfg=teacher_cfg,
                             student_cfg=student_cfg, tcfg=train, rows=rows,
                             dcfg=tdst.DistillConfig(feature_match_weight=0.1))[0]


def rank_model_axis_run(which, cfg, manifest, save_dir, teacher):
    """train or distill for cfg.train's epochs on cfg.mesh under the group
    (one process without one): (best F1, the parameters gathered whole)."""
    if which == "train":
        res = tloop.train(cfg, train_manifest=manifest, val_manifest=manifest, progress=False,
                          device="cpu")
    else:
        res = tdst.distill(teacher, cfg, train_manifest=manifest, val_manifest=manifest,
                           dcfg=tdst.DistillConfig(student_preset="tiny"), train_cfg=cfg.train,
                           progress=False, device="cpu")
    return res["best_f1"], _numpy(tmh.host_replicated(res["params"]))


def rank_cli(argv, model_json):
    return _run_cli(argv, model_json)


def _run_cli(argv, model_json):
    """The train CLI with the tiny model in place of the flags' model."""
    build = tcli.build_config
    tcli.build_config = lambda args: dataclasses.replace(
        build(args), model=tcfg.from_json(model_json))
    try:
        result = tcli.main(argv)
    finally:
        tcli.build_config = build
    return result["best_f1"], result["final_f1"]


# ------------------------------------------------------------ tests

@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["fsdp_data2", "tp_model2"])
def test_sharded_train_step_equals_the_one_process_step(two_ranks, shape):
    """FSDP (min size 1) on mesh (2, 1) and the 'model' rule with FSDP on
    (1, 2), against the one-process step on the global batch: the reduced
    gradients rtol 1e-4 / atol 1e-7 and their global norm rtol 1e-5 (the
    first AdamW step is nearly blind to a gradient's scale), the loss rtol
    1e-5, the parameters rtol 1e-4 / atol 1e-5, a moment sharded. On
    (1, 2) the step is tensor-parallel: its row-parallel products and the
    gradients of its column-parallel inputs sum the two ranks' f32 partial
    sums, which round in another order than one process's products. Its
    reduced gradients are held to one process at atol 5e-7: on 8 tiny
    batches the rounding needed at most 1.53e-7, and a doubled or a missing
    all-reduce in copy_to_model's backward needs 0.31 or more."""
    jcfg = dropout_free(tiny_config())
    cfg = port_config(jcfg)
    train = tcfg.TrainConfig(**dataclasses.asdict(JTrain(
        augment=False, freeze_backbones=False, supcon_weight=0.1, grad_clip=1.0)))
    _, params = params_for(jcfg, seed=0)
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
    for loss, got, sharded, grads in two_ranks.run(rank_train_step, start, batch, cfg, train,
                                                   shape):
        _assert_grads(grads, want_grads, atol=1e-7 if shape[1] == 1 else 5e-7)
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        assert got.keys() == want.keys()
        for path in want:
            tol = (dict(rtol=2e-3, atol=2e-3) if path.endswith(KEY_BIASES)
                   else dict(rtol=1e-4, atol=1e-5))
            np.testing.assert_allclose(got[path], want[path], err_msg=path, **tol)
        assert sharded, "no AdamW moment is sharded"


def test_allgather_rows_any_process_and_rank_zero_checkpoint(two_ranks, tmp_path):
    results = two_ranks.run(rank_collectives, str(tmp_path))
    want_rows = np.concatenate([np.arange(3, dtype=np.float32).reshape(1, 3),
                                np.arange(6, dtype=np.float32).reshape(2, 3) + 100])
    for gathered, flags, written, back, step in results:
        np.testing.assert_array_equal(gathered, want_rows)
        assert flags == (True, False)
        assert written == ["ck0"]          # rank 1's save wrote nothing
        np.testing.assert_array_equal(back["a/kernel"], np.arange(24.0).reshape(4, 6))
        np.testing.assert_array_equal(back["b"], np.ones(3))
        assert step == 3


@pytest.fixture(scope="module")
def cli_clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("pod_cli")
    wavdir = root / "datasets" / "synth"
    wavdir.mkdir(parents=True)
    rng = np.random.default_rng(5)
    items = []
    for i in range(12):
        label = i % 4
        n = int(16000 * (0.5 + 0.04 * i))
        t = np.arange(n) / 16000
        x = 0.4 * np.sin(2 * np.pi * 220.0 * (label + 1) * t) + 0.02 * rng.standard_normal(n)
        audio_io.write_wav(wavdir / f"c{i:02d}.wav", x.astype(np.float32), 16000)
        items.append({"audio": f"synth/c{i:02d}.wav", "text": f"words {label}", "label": label})
    tman.write_manifest(root / "m.jsonl", items)
    return root


def test_train_cli_on_two_ranks_equals_one_process(two_ranks, cli_clips, tmp_path):
    """1 epoch (3 steps at lr 1e-4), global batch 4: the pod branch's
    checkpoint and validation F1 equal the one-process run's."""
    model = dropout_free(tiny_config())
    model_json = json.dumps(dataclasses.asdict(model))
    manifest = str(cli_clips / "m.jsonl")
    base = ["--train_manifest", manifest, "--val_manifest", manifest, "--epochs", "1",
            "--batch_size", "4", "--dataset_root", str(cli_clips / "datasets"),
            "--device", "cpu"]
    want = _run_cli(base + ["--save_dir", str(tmp_path / "one")], model_json)
    got = two_ranks.run(rank_cli, base + ["--save_dir", str(tmp_path / "pod"), "--fsdp",
                                          "--fsdp_min_size", "1"], model_json)
    assert got == [want, want]
    (one,) = [p for p in (tmp_path / "one").glob("epoch_*")]
    (pod,) = [p for p in (tmp_path / "pod").glob("epoch_*")]
    assert one.name == pod.name
    a, _ = tckpt.restore_checkpoint(one, device="cpu")
    b, _ = tckpt.restore_checkpoint(pod, device="cpu")
    b = dict(leaves_with_paths(b))
    for path, leaf in leaves_with_paths(a):
        tol = (dict(rtol=6e-4, atol=6e-4) if path.endswith(KEY_BIASES)
               else dict(rtol=1e-4, atol=1e-5))
        np.testing.assert_allclose(b[path].numpy(), leaf.numpy(), err_msg=path, **tol)
    assert json.loads((pod / "config.json").read_text())["mesh"]["fsdp"] is True


def test_evaluate_manifest_on_two_ranks_equals_one_process(two_ranks, cli_clips):
    """Each rank scores its rows of every batch; the gathered logits (in
    rank order: joined by their manifest indices), the calibration and the
    report equal one process's (no TTA: its noise views draw per rank)."""
    model = tiny_config()
    cfg = tcfg.Config(model=port_config(model),
                      data=tcfg.DataConfig(dataset_root=str(cli_clips / "datasets")))
    params = tm.init_model(cfg.model, torch.Generator().manual_seed(0), device="cpu")
    manifest = str(cli_clips / "m.jsonl")
    want = rank_evaluate(params, cfg, manifest)
    order = np.argsort(want["indices"])
    for got in two_ranks.run(rank_evaluate, params, cfg, manifest):
        mine = np.argsort(got["indices"])
        np.testing.assert_array_equal(got["indices"][mine], want["indices"][order])
        np.testing.assert_allclose(got["logits"][mine], want["logits"][order], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["labels"][mine], want["labels"][order])
        assert got["weighted_f1"] == want["weighted_f1"]
        assert got["temperature"] == want["temperature"]


def test_distill_on_two_ranks_equals_one_process(two_ranks, cli_clips, tmp_path):
    """A dropout-free tiny teacher into the 'tiny' student, FSDP (min size
    1), feature matching on: the distillation loss's reduced gradients
    equal one process's (rtol 1e-4 / atol 1e-7); after 1 epoch at global
    batch 4 the student and its validation F1 equal one process's."""
    model = port_config(dropout_free(tiny_config()))
    cfg = tcfg.Config(model=model,
                      data=tcfg.DataConfig(dataset_root=str(cli_clips / "datasets")),
                      mesh=tcfg.MeshConfig(fsdp=True, fsdp_min_size=1))
    teacher = tm.init_model(model, torch.Generator().manual_seed(1), device="cpu")
    # the distillation loss's gradients, the projection's included (the
    # loss uses it on the gathered rows)
    smodel = tdst.student_model_config(model, "tiny")
    student = tm.init_model(smodel, torch.Generator().manual_seed(2), device="cpu")
    student["distill_proj"] = tl.init_linear(tl.Init(torch.Generator().manual_seed(3), "cpu"),
                                             smodel.proj_dim, model.proj_dim)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in tiny_batch(B=8).items()}
    batch["labels"] = torch.from_numpy(np.arange(8) % model.num_labels).int()
    want_grads = _grads(student, [p for p, _ in leaves_with_paths(student)], None,
                        lambda v: _distill_loss(v, teacher, batch, model, smodel, cfg.train,
                                                None))
    for grads in two_ranks.run(rank_distill_grads, student, teacher, model, smodel, cfg.train,
                               batch):
        _assert_grads(grads, want_grads)
    manifest = str(cli_clips / "m.jsonl")
    want_f1, want = rank_distill(teacher, cfg, manifest, str(tmp_path / "one"))
    for f1, got in two_ranks.run(rank_distill, teacher, cfg, manifest, str(tmp_path / "pod")):
        assert f1 == want_f1
        assert got.keys() == want.keys()
        for path in want:
            tol = (dict(rtol=6e-4, atol=6e-4) if path.endswith(KEY_BIASES)
                   else dict(rtol=1e-4, atol=1e-5))
            np.testing.assert_allclose(got[path], want[path], err_msg=path, **tol)


@pytest.mark.parametrize("which", ["train", "distill"])
def test_a_model_axis_is_refused_under_a_group(two_ranks, cli_clips, tmp_path, which):
    """A 'model' axis of 2 under the group (mesh (1, 2)) runs tensor-parallel:
    the train loop and distill, 1 epoch at global batch 4 on rows both ranks
    of the model group read, give one process's validation F1 and, within
    the sharded step's tolerances, its parameters; rank 0 alone writes the
    checkpoints. Without a group the mesh section is not read."""
    model = port_config(dropout_free(tiny_config()))
    cfg = tcfg.Config(model=model,
                      data=tcfg.DataConfig(dataset_root=str(cli_clips / "datasets")),
                      train=tcfg.TrainConfig(epochs=1, batch_size=4, lr=1e-4),
                      mesh=tcfg.MeshConfig(model_axis=2))
    assert tloop.train_mesh(cfg.mesh, torch.device("cpu")) is None
    teacher = tm.init_model(model, torch.Generator().manual_seed(1), device="cpu")
    manifest = str(cli_clips / "m.jsonl")

    def run(where, fn):
        c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                               save_dir=str(tmp_path / where)))
        return fn(rank_model_axis_run, which, c, manifest, c.train.save_dir, teacher)

    want_f1, want = run("one", lambda fn, *a: fn(*a))
    for f1, got in run("pod", two_ranks.run):
        assert f1 == want_f1
        assert got.keys() == want.keys()
        for path in want:
            tol = (dict(rtol=6e-4, atol=6e-4) if path.endswith(KEY_BIASES)
                   else dict(rtol=1e-4, atol=1e-5))
            np.testing.assert_allclose(got[path], want[path], err_msg=path, **tol)
    assert sorted(p.name for p in (tmp_path / "pod").iterdir()) == sorted(
        p.name for p in (tmp_path / "one").iterdir())

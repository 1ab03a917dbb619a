"""The port's sharding rules and multi-process row algebra without a process
group, against the JAX package: every leaf of the tiny model's tree gets
JAX's PartitionSpec (fsdp off, and on at min size 1 and at the default),
a conv kernel the same logical dimension in its transposed layout;
HostShardedLoader's plans
partition the global plan row for row and the stacked local rows
reproduce the global batches (tests/test_multihost.py's checks, ranks
simulated); `initialize` is a no-op without flags or torchrun's
environment."""

import dataclasses
import json

import numpy as np
import pytest
import jax
import torch

import multilingual_multimodal_speech_emotion_recognition_tpu.models.model as jm
from multilingual_multimodal_speech_emotion_recognition_tpu.parallel import mesh as jmesh
from multilingual_multimodal_speech_emotion_recognition_tpu_torch import config as tcfg
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.data import (
    audio_io, manifest as tman, pipeline as tpipe)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import model as tm
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.parallel import (
    mesh as tmesh, multihost as tmh)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.utils.runtime import (
    leaves_with_paths)

from test_model import tiny_config
from torch_port_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(23)


def _jax_specs(params, mesh, **kw):
    flat = jax.tree_util.tree_flatten_with_path(jmesh.param_shardings(params, mesh, **kw))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): s.spec
            for path, s in flat}


@pytest.mark.parametrize("fsdp,min_size", [(False, None), (True, 1), (True, None)],
                         ids=["replicated", "fsdp_min1", "fsdp_default"])
@pytest.mark.parametrize("data,model", [(2, 2), (4, 1)])
def test_param_specs_match_jax(fsdp, min_size, data, model):
    jcfg = tiny_config()
    jparams = jm.init_model(jax.random.key(0), jcfg)
    mesh = jmesh.make_mesh(jax.devices()[:data * model], data=data, model=model)
    want = _jax_specs(jparams, mesh, fsdp=fsdp, fsdp_min_size=min_size)
    port = tm.init_model(tcfg.from_json(json.dumps(dataclasses.asdict(jcfg))), device="meta")
    sharded = 0
    for path, leaf in leaves_with_paths(port):
        got = tmesh.leaf_spec(path, tuple(leaf.shape), n_data=data, fsdp=fsdp,
                              fsdp_min_size=min_size)
        spec = tuple(want[path]) + (None,) * (leaf.dim() - len(want[path]))
        if tmesh._conv_kernel(path):      # torch's [C_out, C_in/g, K] is JAX's reversed
            spec = spec[::-1]
        assert got == spec, path
        sharded += any(a is not None for a in got)
        placements = tmesh.placements(got)
        for axis, pl in zip(tmesh.AXES, placements):
            dims = [d for d, a in enumerate(got) if a == axis]
            assert (pl.is_shard(dims[0]) if dims else pl.is_replicate()), (path, axis)
    assert sharded > 0 or (not fsdp and model == 1)


def test_fsdp_rules_on_jax_examples():
    """JAX's own rule table (tests/test_parallel.py:test_fsdp_sharding_rules)."""
    kw = dict(n_data=4, fsdp=True, fsdp_min_size=64)
    assert tmesh.leaf_spec("encoder/ffn_in/kernel", (256, 512), **kw) == ("data", "model")
    assert tmesh.leaf_spec("encoder/ffn_out/kernel", (512, 256), **kw) == ("model", "data")
    assert tmesh.leaf_spec("encoder/ffn_in/bias", (512,), **kw) == ("data",)
    assert tmesh.leaf_spec("small/kernel", (4, 8), **kw) == (None, None)
    assert tmesh.leaf_spec("odd/kernel", (258, 514), **kw) == (None, None)
    assert tmesh.leaf_spec("encoder/ffn_in/bias", (512,), n_data=4, fsdp=False) == (None,)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """10 clips in two buckets (<= 2 s, <= 4 s): a partial last batch at a
    global batch of 4."""
    root = tmp_path_factory.mktemp("hostsharded")
    (root / "datasets" / "crema").mkdir(parents=True)
    emotions = ["ANG", "HAP", "SAD", "NEU", "DIS", "FEA"]
    items = []
    for i in range(10):
        n = 12000 if i % 2 else 40000
        x = np.clip(RNG.standard_normal(n) * 0.2, -1, 1).astype(np.float32)
        name = f"10{i:02d}_IEO_{emotions[i % 6]}_XX.wav"
        audio_io.write_wav(root / "datasets" / "crema" / name, x, 16000)
        items.append({"audio": f"crema/{name}", "text": f"utterance {i}",
                      "label": tman.crema_label(name), "dataset": "crema"})
    tman.write_manifest(root / "train.jsonl", items)
    return tpipe.SERDataset(str(root / "train.jsonl"),
                            tcfg.DataConfig(dataset_root=str(root / "datasets")))


def _loaders(dataset, pc):
    g = tpipe.BucketedLoader(dataset, batch_size=4, shuffle=True, seed=3)
    return g, [tmh.HostShardedLoader(dataset, batch_size=4, shuffle=True, seed=3,
                                     process_index=p, process_count=pc) for p in range(pc)]


def test_sharded_plans_partition_the_global_plan(dataset):
    g, (s0, s1) = _loaders(dataset, 2)
    gp, p0, p1 = g._plan(5), s0._plan(5), s1._plan(5)
    assert len(gp) == len(p0) == len(p1)
    assert g.batches_per_epoch() == s0.batches_per_epoch()
    for (gb, gc), (b0, c0), (b1, c1) in zip(gp, p0, p1):
        assert gb == b0 == b1
        assert c0 == gc[:2] and c1 == gc[2:4]
        assert c0 + c1 == gc


def test_stacked_local_rows_reproduce_global_batches(dataset):
    g, (s0, s1) = _loaders(dataset, 2)
    for bg, b0, b1 in zip(g.epoch(1), s0.epoch(1), s1.epoch(1)):
        assert b0["audio"].shape[0] == 2 and bg["audio"].shape[0] == 4
        vg = bg["example_mask"] > 0
        for key in ("audio", "audio_mask", "text_ids", "text_mask", "labels", "lid_entropy",
                    "lid_conf", "indices"):
            stacked = np.concatenate([b0[key][b0["example_mask"] > 0],
                                      b1[key][b1["example_mask"] > 0]])
            np.testing.assert_array_equal(stacked, bg[key][vg], err_msg=key)
    with pytest.raises(ValueError, match="not divisible by 2 ranks"):
        tmh.HostShardedLoader(dataset, batch_size=5, process_index=0, process_count=2)


def test_without_a_group_everything_is_one_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert tmh.initialize() is False
    assert not tmh.group_up()
    assert (tmh.world_size(), tmh.rank(), tmh.is_coordinator()) == (1, 0, True)
    rows = np.arange(6).reshape(3, 2)
    assert tmh.allgather_rows(rows) is rows
    assert tmh.any_process(True) and not tmh.any_process(False)
    tree = {"a": torch.ones(2)}
    assert tmh.host_replicated(tree)["a"] is tree["a"]
    # torchrun's environment half set is not a job; an incomplete rendezvous raises
    monkeypatch.setenv("RANK", "0")
    assert tmh.initialize() is False
    with pytest.raises(ValueError, match="--num_processes / WORLD_SIZE"):
        tmh.initialize(process_id=0, device="cpu")
    with pytest.raises(RuntimeError, match="needs a process group"):
        tmesh.make_mesh(device="cpu")

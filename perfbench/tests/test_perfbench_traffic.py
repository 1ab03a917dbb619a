"""The labelling stream: one seed, one stream; the bucket mix and the
audio-seconds a batch fixed whatever the seed."""

import numpy as np
import pytest
import torch

from perfbench.harness import registry

CELLS = ["flagship.bulk", "wavlm_large.bulk", "flagship.tta"]


def _small(cell):
    wl = registry.workload_file(cell)
    for b in wl["params"]["buckets"]:
        b["batch"] = max(1, b["batch"] // 32)
    wl["params"]["cycles"] = 2
    return wl


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_batches_other_seed_other_clips(cell):
    gen = registry.load_module("traffic", "labelling")
    params = _small(cell)["params"]
    a = gen.generate(params, 2**31 + 17, "cpu", 250002)
    b = gen.generate(params, 2**31 + 17, "cpu", 250002)
    c = gen.generate(params, 5, "cpu", 250002)
    for x, y in zip(a, b):
        for k in ("audio", "audio_mask", "text_ids", "text_mask"):
            assert torch.equal(x[k], y[k])
    assert not all(torch.equal(x["audio"], y["audio"]) for x, y in zip(a, c) if
                   x["audio"].shape == y["audio"].shape)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [0, 123456789012])
def test_bucket_ratio_and_audio_seconds_a_batch(cell, seed):
    wl = registry.workload_file(cell)
    params = dict(wl["params"], cycles=3)
    rng = np.random.default_rng(seed)
    order = registry.load_module("traffic", "labelling").cycle_order(params, rng)
    buckets = params["buckets"]
    per_cycle = sum(b["share"] for b in buckets)
    assert len(order) == 3 * per_cycle
    for k in range(3):
        cyc = order[k * per_cycle:(k + 1) * per_cycle]
        assert sorted(cyc) == sorted(i for i, b in enumerate(buckets) for _ in range(b["share"]))
    seconds = {b["seconds"] * b["batch"] for b in buckets}
    assert len(seconds) == 1            # the same audio-seconds in every batch
    assert [b["share"] for b in buckets] == [1, 2, 1]


def test_clips_lie_in_their_bucket_and_masks_cover_them():
    gen = registry.load_module("traffic", "labelling")
    params = _small("flagship.bulk")["params"]
    for b in gen.generate(params, 9, "cpu", 250002):
        lo, hi = next(x["clip_seconds"] for x in params["buckets"]
                      if x["seconds"] == b["bucket_seconds"])
        n = b["audio_mask"].sum(1)
        assert (n >= lo * 16000 - 1).all() and (n <= hi * 16000).all()
        assert b["audio"].shape[1] == int(b["bucket_seconds"] * 16000)
        assert (b["audio"] * (1 - b["audio_mask"])).abs().max() == 0
        assert b["audio"].abs().max() <= 1.0
        ids, tm = b["text_ids"], b["text_mask"]
        length = tm.sum(1).long()
        assert ((length >= 8) & (length <= 32)).all()
        assert (ids[:, 0] == 0).all()
        assert (ids[torch.arange(len(ids)), length - 1] == 2).all()
        assert (ids[tm == 0] == 1).all()


def test_noisy_share_and_snr_are_drawn():
    gen = registry.load_module("traffic", "labelling")
    rng = np.random.default_rng(4)
    params = registry.workload_file("flagship.bulk")["params"]
    c = gen._clip_params(rng, 4000, 1.0, 2.0, params)
    assert abs(c["noisy"].mean() - 0.5) < 0.03
    assert c["snr"].min() >= 10 and c["snr"].max() <= 20


def test_a_noisy_clip_has_its_snr():
    gen = registry.load_module("traffic", "labelling")
    params = {**registry.workload_file("flagship.bulk")["params"], "noisy_share": 1.0,
              "snr_db": [12.0, 12.0]}
    rng = np.random.default_rng(5)
    c = gen._clip_params(rng, 8, 1.0, 2.0, params)
    g = torch.Generator().manual_seed(0)
    noisy = gen._synthesise(c, 32000, g, "cpu").double()
    clean = gen._synthesise({**c, "noisy": np.zeros(8, bool)}, 32000,
                            torch.Generator().manual_seed(0), "cpu").double()
    m = (torch.arange(32000)[None, :] < torch.as_tensor(c["length"])[:, None]).double()
    power = lambda x: (x * x * m).sum(1) / m.sum(1)
    snr = 10 * torch.log10(power(clean) / power(noisy - clean))
    assert (snr - 12.0).abs().max() < 1.0

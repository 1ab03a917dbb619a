"""The reference against the port's eval steps at a tiny size on the CPU,
and its front-end DSP against the port's, bit for bit."""

import pytest
import torch

from perfbench import reference as ref
from perfbench.harness import registry, runner, weights as weights_lib
from perfbench.reference import dsp
from perfbench.tests.tiny import tiny_config, tiny_workload


def _setup(cell, compute_dtype, audio):
    cfg = tiny_config(compute_dtype, audio)
    return runner.set_up(cell, 11, device="cpu", cfg=cfg,
                         workload=tiny_workload(cell, batches=(4, 3, 2)))


@pytest.mark.parametrize("cell", ["flagship.bulk", "flagship.tta"])
@pytest.mark.parametrize("audio", ["group", "layer"])
def test_reference_agrees_with_the_ports_step_in_float32(cell, audio):
    c = _setup(cell, "float32", audio)
    program = runner.program_of(c)
    with torch.inference_mode(), ref.plain_fp32():
        for i in range(len(c.host)):
            batch = runner._on_device(c.host[i], "cpu")
            got = program(batch, c.extras[i])
            want = c.entry.reference(ref, c.cfg, c.weights, batch, c.extras[i], c.args)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell", ["flagship.bulk", "flagship.tta"])
@pytest.mark.parametrize("audio", ["group", "layer"])
def test_reference_equals_the_ports_step_in_bfloat16_on_the_cpu(cell, audio):
    """In bfloat16 the reference rounds where the configuration does, so on
    one device, where both sides take the same kernels, it gives the
    port's answers bit for bit; the same reference in float32 does not."""
    c = _setup(cell, "bfloat16", audio)
    program = runner.program_of(c)
    f32 = {**c.cfg, "model": {**c.cfg["model"], "compute_dtype": "float32"}}
    with torch.inference_mode(), ref.plain_fp32():
        for i in range(len(c.host)):
            batch = runner._on_device(c.host[i], "cpu")
            got = program(batch, c.extras[i])
            want = c.entry.reference(ref, c.cfg, c.weights, batch, c.extras[i], c.args)
            assert torch.equal(got, want)
            assert all(v == 0.0 for v in c.entry.compare(got, want).values())
            exact = c.entry.reference(ref, f32, c.weights, batch, c.extras[i], c.args)
            assert c.entry.compare(got, exact)["logit_gap"] > 0


def test_dsp_decisions_and_waves_equal_the_ports_bit_for_bit():
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.frontend import (
        frontend_process)
    gen = registry.load_module("traffic", "labelling")
    params = tiny_workload("flagship.bulk", batches=(6, 5, 3))["params"]
    params["noisy_share"] = 0.5
    for b in gen.generate(params, 21, "cpu", 100):
        B = b["audio"].shape[0]
        want = frontend_process(b["audio"], b["audio_mask"], lid_entropy=torch.ones(B),
                                lid_confidence=torch.zeros(B))
        got = dsp.frontend(b["audio"], b["audio_mask"], sample_rate=16000, use_gates=True,
                           use_conditioning=True, zero_non_accept=False)
        for g, w in zip(got, want[:3]):
            assert torch.equal(g, w)


def test_served_weights_round_all_but_the_classifier():
    w = {"classifier": {"k": torch.tensor([1.0 + 2 ** -12])},
         "cross": {"k": torch.tensor([1.0 + 2 ** -12])}}
    s = ref.model.served_weights(w, "bfloat16")
    assert s["classifier"]["k"].item() == 1.0 + 2 ** -12 and s["cross"]["k"].item() == 1.0
    assert ref.model.served_weights(w, "float32") is w


def test_weights_are_the_seeds_and_keep_the_ports_layout():
    port = runner.import_port()
    cfg = tiny_config()
    layout = port.model.init_model(runner.model_config(port, cfg), device="meta")
    a = weights_lib.make_weights(layout, 3, "cpu")
    b = weights_lib.make_weights(layout, 3, "cpu")
    c = weights_lib.make_weights(layout, 4, "cpu")
    la = list(weights_lib._paths(a))
    assert la == list(weights_lib._paths(layout))
    flat = lambda t: torch.cat([x.flatten() for x in _leaves(t)])
    assert torch.equal(flat(a), flat(b)) and not torch.equal(flat(a), flat(c))
    assert all(x.storage_offset() % weights_lib.ALIGN == 0 for x in _leaves(a))
    assert torch.equal(a["classifier"]["weibull"]["alpha"], torch.ones(4))


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    elif isinstance(t, list):
        for v in t:
            yield from _leaves(v)
    else:
        yield t

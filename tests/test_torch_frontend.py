"""The port's front-end DSP (frontend/) against the JAX package's on the
CPU: the same numpy inputs through both, JAX on its default CPU path
(jnp.fft; masked_quantile sorts below 8192 entries and bit-searches at
8192 and above).

Inputs come from the JAX tests' own generators: `speech_like`, the hum +
120 Hz "dirty" clip of tests/test_frontend.py, and the bench's
`worst_case_dsp_audio`. At 1 s their rows fire the hum, HPF and denoise
branches, leave one row clean, and pad one row.

Tolerances: decisions and branch flags equal; masked_quantile within
rtol 1e-6 (the same order statistics); spectral outputs rtol 1e-4 with an
atol of 1e-5 of each output's peak (FFT rounding is relative to the
peak); gate and conditioning features within 1e-4; conditioned waves
within 1e-5 of each row's peak.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu.eval import benchmark as jbench
from multilingual_multimodal_speech_emotion_recognition_tpu.frontend import (
    conditioning as jc, frontend_process as jfrontend_process, lid as jlid,
    quality_gates as jq, spectral as js)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.frontend import (
    conditioning as tc, frontend_process as tfrontend_process, lid as tlid,
    quality_gates as tq, spectral as ts)

from test_frontend import speech_like

SR = 16000
FEATURE_TOL = 1e-4
PADDED_LEN = 11200          # row 3: 0.7 s of a 1 s batch


def dirty_clip(T, seed=42):
    """A 50 Hz hum line and 120 Hz energy over a little noise: fires the
    notch, the HPF and (steady tones, high energy floor) the denoiser."""
    t = np.arange(T) / SR
    rng = np.random.default_rng(seed)
    return (0.5 * np.sin(2 * np.pi * 50 * t) + 0.6 * np.sin(2 * np.pi * 120 * t)
            + 0.05 * np.sin(2 * np.pi * 300 * t)
            + 0.02 * rng.standard_normal(T)).astype(np.float32)


def dsp_batch(T=SR, short=None):
    """[4, T]: worst-case hum + HPF row, worst-case denoise row, a clean
    speech-like row, the dirty clip padded to 0.7 s (or to `short`)."""
    wc = jbench.worst_case_dsp_audio(np.random.default_rng(5), 2, T)
    wave = np.stack([wc[0], wc[1], speech_like(T, seed=3), dirty_clip(T)]).astype(np.float32)
    mask = np.ones_like(wave)
    L = short or min(PADDED_LEN, T)
    wave[3, L:] = 0.0
    mask[3, L:] = 0.0
    return wave, mask


def lid_inputs(B):
    rng = np.random.default_rng(9)
    return ((1.0 + rng.random(B)).astype(np.float32),
            (0.5 * rng.random(B)).astype(np.float32))


def both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def assert_peak_close(got, want, rel, rtol=0.0):
    """Within `rel` of the output's peak (and `rtol` of each value)."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=rtol,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def assert_stats_match(got, want, exact):
    for field in want._fields:
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert tuple(g.shape) == w.shape, field
        if field in exact:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
        else:
            np.testing.assert_allclose(g.double().numpy(), w.astype(np.float64),
                                       rtol=FEATURE_TOL, atol=FEATURE_TOL, err_msg=field)


# ---------------------------------------------------------------- spectral

@pytest.mark.parametrize("N", [500, 8192], ids=["sort", "bitsearch"])
def test_masked_quantile_matches_jax(N):
    assert (N >= js._QUANTILE_BITSEARCH_MIN_N) == (N == 8192)
    rng = np.random.default_rng(N)
    x = rng.standard_normal((5, N)).astype(np.float32)
    x[1] = np.round(x[1] * 2) / 2                  # duplicates
    x[2] = x[2] ** 2
    mask = np.zeros((5, N), np.float32)
    for i, L in enumerate([N, N - 1, N // 3, 1, 2]):
        mask[i, :L] = 1
    (xj, xt), (mj, mt) = both(x), both(mask)
    for q in (0.0, 0.1, 0.3, 0.5, 1.0):
        want = np.asarray(js.masked_quantile(xj, mj, q))
        np.testing.assert_allclose(ts.masked_quantile(xt, mt, q).numpy(), want, rtol=1e-6,
                                   atol=0, err_msg=f"q={q}")


SPECTRAL_CASES = {
    "welch_2048": lambda m, w, k: m.welch_psd(w, k, sample_rate=SR, nperseg=2048)[1],
    "welch_1024": lambda m, w, k: m.welch_psd(w, k, sample_rate=SR, nperseg=1024)[1],
    "stft_center": lambda m, w, k: m.stft_mag(w),
    "stft_uncentered": lambda m, w, k: m.stft_mag(w, n_fft=1024, hop=256, center=False),
    "rms_vad": lambda m, w, k: m.rms_frames(w, frame_length=400, hop=160),
    "rms_content": lambda m, w, k: m.rms_frames(w, frame_length=2048, hop=512),
    "descriptors": lambda m, w, k: m.spectral_descriptors(w, k, sample_rate=SR),
    "median_smooth": lambda m, w, k: m.median_smooth_bool(w[:, ::97] > 0.05),
    "frame_masks": lambda m, w, k: (m.frame_valid_mask(k, 400, 160),
                                    m.stft_frame_mask(k),
                                    m.stft_frame_mask(k, n_fft=1024, hop=256, center=False)),
}


@pytest.mark.parametrize("case", sorted(SPECTRAL_CASES))
def test_spectral_matches_jax(case):
    wave, mask = dsp_batch()
    (wj, wt), (mj, mt) = both(wave), both(mask)
    want = SPECTRAL_CASES[case](js, wj, mj)
    got = SPECTRAL_CASES[case](ts, wt, mt)
    wants, gots = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    for g, w in zip(gots, wants):
        assert tuple(g.shape) == np.shape(w)
        assert_peak_close(g, w, 1e-5, rtol=1e-4)


def test_welch_grid_is_numpys():
    freqs, _ = ts.welch_psd(torch.zeros(1, 3000), torch.ones(1, 3000), sample_rate=SR,
                            nperseg=2048)
    assert freqs.dtype == torch.float64
    np.testing.assert_array_equal(freqs.numpy(), np.fft.rfftfreq(2048, 1.0 / SR))
    np.testing.assert_array_equal(ts.hann_window(1024, torch.device("cpu")).numpy(),
                                  js.hann_window(1024))


@pytest.mark.parametrize("T,pad", [(10, 3), (5, 9), (2, 7), (1, 4)])
def test_reflect_pad_matches_numpy_at_any_length(T, pad):
    x = np.arange(2 * T, dtype=np.float32).reshape(2, T) ** 2
    np.testing.assert_array_equal(ts.reflect_pad(torch.from_numpy(x), pad).numpy(),
                                  np.pad(x, [(0, 0), (pad, pad)], mode="reflect"))


def test_rms_frames_no_cancellation_on_long_clips():
    """tests/test_frontend.py's spec for the JAX module, on the port: 30 s
    of near-full-scale noise with silence late in it keeps the silent
    frames at (near-)zero RMS."""
    rng = np.random.default_rng(33)
    T = 480_000
    wave = (0.9 * rng.standard_normal(T)).astype(np.float32).clip(-1, 1)
    wave[T - 64_000:T - 16_000] = 0.0
    got = ts.rms_frames(torch.from_numpy(wave)[None], frame_length=400, hop=160)[0].numpy()
    f_lo = (T - 64_000 + 400) // 160 + 2
    f_hi = (T - 16_000 - 400) // 160 - 2
    assert got[f_lo:f_hi].max() < 1e-4, got[f_lo:f_hi].max()
    w = np.pad(wave, (200, 200))
    np.testing.assert_allclose(got[100], np.sqrt((w[16000:16400] ** 2).mean()), rtol=2e-4)


# ----------------------------------------------------------- quality gates

GATE_CASES = {
    # (T, row 3's length, zero_non_accept)
    "long": (SR, None, False),
    "long_zero_non_accept": (SR, None, True),
    # a row shorter than n_fft + 3 hop: the JAX module takes its gather
    # path for the boundary frames instead of its slice path
    "short_row": (SR, 3000, False),
    "sub_window": (2000, 1500, False),      # T <= n_fft
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_quality_gates_match_jax(case):
    T, short, zero_non_accept = GATE_CASES[case]
    wave, mask = dsp_batch(T, short)
    ent, conf = lid_inputs(4)
    (wj, wt), (mj, mt), (ej, et), (cj, ct) = both(wave), both(mask), both(ent), both(conf)
    want_wave, want = jq.quality_gates(wj, mj, lid_entropy=ej, lid_confidence=cj,
                                       sample_rate=SR, zero_non_accept=zero_non_accept)
    got_wave, got = tq.quality_gates(wt, mt, lid_entropy=et, lid_confidence=ct,
                                     sample_rate=SR, zero_non_accept=zero_non_accept)
    assert_stats_match(got, want, exact=("decision",))
    np.testing.assert_array_equal(got_wave.numpy(), np.asarray(want_wave))
    if case == "long":
        assert set(got.decision.tolist()) == {tq.REJECT, tq.UNCERTAIN}


def test_quality_gates_are_padding_invariant():
    """A clip's gate features alone and padded in a batch. Naturalness (3)
    and music (6) are left out: the spectral descriptors read centered
    STFT frames reflected at the batch's end, not the clip's, in the JAX
    package as here (about 2e-3 apart at 0.7 s in 1 s)."""
    clip = speech_like(int(0.7 * SR), seed=7)
    wave, mask = dsp_batch()
    wave[2], mask[2] = 0.0, 0.0
    wave[2, :clip.size], mask[2, :clip.size] = clip, 1.0
    ent, conf = torch.ones(4), torch.zeros(4)
    _, one = tq.quality_gates(torch.from_numpy(clip[None]), torch.ones(1, clip.size),
                              lid_entropy=ent[:1],
                              lid_confidence=conf[:1])
    _, batch = tq.quality_gates(torch.from_numpy(wave), torch.from_numpy(mask),
                                lid_entropy=ent, lid_confidence=conf)
    invariant = [0, 1, 2, 4, 5, 7]
    torch.testing.assert_close(batch.features[2, invariant], one.features[0, invariant],
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ conditioning

CONDITIONING_FLAGS = ("hum_filtered", "hpf_applied", "denoise_applied", "dereverb_applied",
                      "noise_type")


@pytest.mark.parametrize("case", ["dsp_batch", "clean"])
def test_condition_audio_matches_jax(case):
    """`dsp_batch` fires the notch/HPF and denoise gates; `clean` (speech-
    like rows only) fires none, so every stage takes its skip branch."""
    if case == "clean":
        wave = np.stack([speech_like(SR, seed=s) for s in (3, 4)])
        mask = np.ones_like(wave)
    else:
        wave, mask = dsp_batch()
    (wj, wt), (mj, mt) = both(wave), both(mask)
    want_wave, want = jc.condition_audio(wj, mj, sample_rate=SR)
    got_wave, got = tc.condition_audio(wt, mt, sample_rate=SR)
    assert_stats_match(got, want, exact=CONDITIONING_FLAGS)
    want_wave = np.asarray(want_wave)
    for row in range(wave.shape[0]):
        assert_peak_close(got_wave[row], want_wave[row], 1e-5)
    fired = {f: getattr(got, f).tolist() for f in CONDITIONING_FLAGS[:3]}
    if case == "clean":
        assert not any(any(v) for v in fired.values()), fired
    else:
        assert fired == {"hum_filtered": [True, False, False, True],
                         "hpf_applied": [True, False, False, True],
                         "denoise_applied": [False, True, False, True]}, fired


STAGES = {
    "hum_notch": lambda m, w, k, t60: m.hum_notch(w, k, sample_rate=SR),
    "hpf": lambda m, w, k, t60: m.apply_hpf(w, k, *m.hpf_decision(w, k, sample_rate=SR),
                                            sample_rate=SR),
    "noise_type": lambda m, w, k, t60: m.detect_noise_type(w, k, sample_rate=SR),
    "snr_energy": lambda m, w, k, t60: m.estimate_snr_energy(w, k),
    "denoise": lambda m, w, k, t60: m.spectral_gate_denoise(w, k),
    "t60": lambda m, w, k, t60: m.estimate_t60(w, k, sample_rate=SR),
    # T60 above the 0.5 s gate on rows 0 and 2 fires the dereverb pass
    "dereverb": lambda m, w, k, t60: m.dereverb(w, k, t60, sample_rate=SR),
    "loudness": lambda m, w, k, t60: m.normalize_loudness(0.5 * w, k),
}


@pytest.mark.parametrize("stage", list(STAGES))
def test_conditioning_stage_matches_jax(stage):
    wave, mask = dsp_batch()
    (wj, wt), (mj, mt) = both(wave), both(mask)
    tj, tt = both(np.array([0.7, 0.1, 0.9, 0.1], np.float32))
    want, got = STAGES[stage](jc, wj, mj, tj), STAGES[stage](tc, wt, mt, tt)
    wants, gots = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    for g, w in zip(gots, wants):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(g.numpy(), w)
        elif w.ndim == 2:
            for row in range(w.shape[0]):
                assert_peak_close(g[row], w[row], 1e-5)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=FEATURE_TOL, atol=FEATURE_TOL)


def test_conditioning_report_reads_the_stats():
    wave, mask = dsp_batch()
    _, stats = tc.condition_audio(torch.from_numpy(wave), torch.from_numpy(mask))
    report = tc.conditioning_report(stats, 3)
    assert "Hum Filtering: Yes" in report and "Denoising: Yes" in report
    assert "Noise Type: " + tc.NOISE_TYPES[int(stats.noise_type[3])] in report


# ----------------------------------------------------------- the whole DSP

@pytest.mark.parametrize("use_gates,use_conditioning,zero_non_accept", [
    (True, True, False), (True, True, True), (False, True, False), (True, False, False)])
def test_frontend_process_matches_jax(use_gates, use_conditioning, zero_non_accept):
    wave, mask = dsp_batch()
    ent, conf = lid_inputs(4)
    kw = dict(sample_rate=SR, use_gates=use_gates, use_conditioning=use_conditioning,
              zero_non_accept=zero_non_accept)
    (wj, wt), (mj, mt), (ej, et), (cj, ct) = both(wave), both(mask), both(ent), both(conf)
    want = jfrontend_process(wj, mj, lid_entropy=ej, lid_confidence=cj, **kw)
    got = tfrontend_process(wt, mt, lid_entropy=et, lid_confidence=ct, **kw)
    want_wave = np.asarray(want[0])
    for row in range(4):
        assert_peak_close(got[0][row], want_wave[row], 1e-5)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FEATURE_TOL,
                                   atol=FEATURE_TOL)
    assert got[3].keys() == want[3].keys()
    if use_gates:
        assert_stats_match(got[3]["quality"], want[3]["quality"], exact=("decision",))
    if use_conditioning:
        assert_stats_match(got[3]["conditioning"], want[3]["conditioning"],
                           exact=CONDITIONING_FLAGS)


def test_lid_copy_matches_jax():
    texts = ["hello there, how are you", "", None, "el perro y la casa",
             "Привет, как дела", "これは日本語です", "zzz qqq", "der Hund und die Katze"]
    assert tlid.batch_lid(texts) == jlid.batch_lid(texts)
    for text in texts:
        assert tlid.identify_language(text) == jlid.identify_language(text)

"""Front-end quality gates: VAD, signal quality, content type, abstain.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
frontend/quality_gates.py: the whole gate battery as one batched function
over padded [B, T] waveforms, on the input's device. It reads nothing back
to the host.

The JAX module picks between two value-identical ways of gathering the
clip-end STFT frames (a slice path for long clips, a gather otherwise);
the port has the gather alone (`_boundary_frames`), so the gates take no
branch on data.

Language ID is text-side and stays on the host (frontend/lid.py); its
entropy and confidence enter here as per-utterance scalars.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import spectral as sp

Tensor = torch.Tensor

# EarlyAbstainPolicy thresholds (the reference's quality_gates.py:353-360)
SNR_LOW, SNR_HIGH = 5.0, 10.0
CLIPPING_MAX_PCT = 30.0
SPEECH_LOW, SPEECH_HIGH = 0.4, 0.8
LID_ENTROPY_MAX = 1.5
MUSIC_MAX = 0.2

REJECT, UNCERTAIN, ACCEPT = 0, 1, 2

SNR_N_FFT, SNR_HOP = 2048, 512
BOUNDARY_FRAMES = 3


class QualityStats(NamedTuple):
    speech_prob: Tensor           # [B]
    snr_db: Tensor                # [B]
    clipping_percent: Tensor      # [B]
    spectral_naturalness: Tensor  # [B]
    lid_entropy: Tensor           # [B]
    lid_confidence: Tensor        # [B]
    music_prob: Tensor            # [B]
    laughter_prob: Tensor         # [B]
    decision: Tensor              # [B] int32: 0 reject / 1 uncertain / 2 accept
    quality_score: Tensor         # [B]
    features: Tensor              # [B, 8] raw (pre-projection) feature vector


def energy_vad(wave: Tensor, mask: Tensor, *, sample_rate: int = 16000) -> Tensor:
    """Energy VAD speech probability: 25 ms frames / 10 ms hop, threshold =
    30th percentile + 0.1 std of the valid frames' energy, median-5
    smoothing; speech_prob = mean over valid frames."""
    frame = int(sample_rate * 0.025)
    hop = int(sample_rate * 0.010)
    energy = sp.rms_frames(wave, frame_length=frame, hop=hop)        # [B, F]
    fmask = sp.center_frame_mask(mask, hop, energy.shape[-1])
    thr = sp.masked_quantile(energy, fmask, 0.30) + 0.1 * sp.masked_std(energy, fmask)
    speech = (energy > thr[:, None]) & (fmask > 0)
    speech = sp.median_smooth_bool(speech, size=5)
    return sp.masked_mean(speech.float(), fmask)


def _boundary_frames(wave: Tensor, length: Tensor, pos: Tensor, *,
                     n_fft: int, hop: int) -> Tensor:
    """CENTERED frames at positions pos [B, P] of each clip, with the
    clip's own reflection at both of its ends (librosa reflect-pads the
    unpadded clip; the batch holds zeros past its length L, so frames that
    cross L are gathered anew: x[L + i] = x[L - 2 - i]). wave [B, T],
    length [B] -> [B, P, n_fft], by one gather of P * n_fft indices per
    row."""
    B, T = wave.shape
    P = pos.shape[1]
    starts = pos * hop - n_fft // 2                                  # clip coordinates
    idx = starts[..., None] + torch.arange(n_fft, device=wave.device)
    idx = idx.abs()                                                  # head reflection
    last = (length - 1)[:, None, None]
    over = idx - last
    idx = torch.where(over > 0, last - over, idx).clamp(0, T - 1)
    return wave.gather(1, idx.reshape(B, P * n_fft)).reshape(B, P, n_fft)


def estimate_snr(wave: Tensor, mask: Tensor, *, S: Tensor | None = None) -> Tensor:
    """SNR from the STFT's edge frames, librosa-faithful: centered 2048/512
    hann framing (1 + L//hop frames), noise = mean magnitude of the LAST
    10 % of frames (the reference overwrites its first-10 % estimate with
    the last-10 % one), signal = frames [k, n - k). The up to 3 frames
    whose window crosses the clip's end are gathered anew with the clip's
    own reflection, so the result is librosa's on the unpadded clip.
    `S` is the precomputed centered stft_mag, if the caller has it."""
    n_fft, hop = SNR_N_FFT, SNR_HOP
    T = wave.shape[-1]
    if T <= n_fft:
        # sub-window clips: one uncentered frame is both signal and noise
        # (ratio 1 -> 0 dB; silence -> 50), as the JAX module does
        S_u = sp.stft_mag(wave, n_fft=min(n_fft, T), hop=hop, center=False)
        power = (S_u.mean(1) ** 2).mean(-1)
        return torch.where(power > 0, 0.0, 50.0)
    if S is None:
        S = sp.stft_mag(wave, n_fft=n_fft, hop=hop, center=True)     # [B, F, bins]
    F = S.shape[1]
    dev = wave.device
    L = mask.sum(-1).to(torch.int32)                                 # [B]
    n_c = 1 + L // hop                                               # librosa's count
    k = (0.1 * n_c).to(torch.int32).clamp(min=1)
    j = torch.arange(F, device=dev)[None, :]
    P = BOUNDARY_FRAMES
    pos = n_c[:, None] - (P - torch.arange(P, device=dev))[None, :]  # [B, P]
    pos_valid = pos >= 0
    frames = _boundary_frames(wave, L, pos.clamp(0, F - 1), n_fft=n_fft, hop=hop)
    S_fix = sp.frame_magnitude(frames, sp.hann_window(n_fft, dev))   # [B, P, bins]
    interior = j < (n_c - P)[:, None]                                # these come from S
    noise_c = (j >= (n_c - k)[:, None]) & (j < n_c[:, None]) & interior
    signal_c = (j >= k[:, None]) & (j < (n_c - k)[:, None]) & interior
    noise_b = pos_valid & (pos >= (n_c - k)[:, None])                # these from S_fix
    signal_b = pos_valid & (pos >= k[:, None]) & (pos < (n_c - k)[:, None])

    def _mean(mc, mb):
        tot = (S * mc[..., None]).sum(1) + (S_fix * mb[..., None]).sum(1)
        cnt = (mc.sum(-1) + mb.sum(-1)).to(S.dtype)
        return tot / cnt.clamp(min=1.0)[:, None], cnt

    noise_spec, _ = _mean(noise_c, noise_b)
    signal_spec, n_sig = _mean(signal_c, signal_b)
    # degenerate rows (n - 2k <= 0): all valid frames are the signal
    all_spec, _ = _mean((j < n_c[:, None]) & interior, pos_valid)
    signal_spec = torch.where((n_sig > 0)[:, None], signal_spec, all_spec)
    signal_power = (signal_spec ** 2).mean(-1)
    noise_power = (noise_spec ** 2).mean(-1)
    snr = 10.0 * torch.log10(signal_power / noise_power.clamp(min=1e-20))
    snr = torch.where(noise_power > 0, snr, 50.0)
    return snr.clamp(0.0, 50.0)


def clipping_percent(wave: Tensor, mask: Tensor) -> Tensor:
    """% of samples above 0.95 of the per-utterance peak (denominator: the
    valid length)."""
    absw = wave.abs()
    peak = (absw * mask).amax(-1, keepdim=True)
    norm = torch.where(peak > 0, absw / peak.clamp(min=1e-12), absw)
    clipped = ((norm > 0.95) & (mask > 0)).sum(-1)
    return 100.0 * clipped / mask.sum(-1).clamp(min=1.0)


def spectral_naturalness(wave: Tensor, mask: Tensor, *, sample_rate: int = 16000,
                         descriptors=None) -> Tensor:
    """Centroid/rolloff/bandwidth heuristic score. The reference compares
    mean rolloff (in Hz) against 0.85, so the rolloff term is ~0 for any
    real signal; kept as it is."""
    if descriptors is None:
        descriptors = sp.spectral_descriptors(wave, mask, sample_rate=sample_rate)
    centroid, rolloff, bandwidth = descriptors
    centroid_score = 1.0 - ((centroid - 2000.0).abs() / 2000.0).clamp(0, 1)
    rolloff_score = 1.0 - ((rolloff - 0.85).abs() / 0.15).clamp(0, 1)
    bandwidth_score = 1.0 - ((bandwidth - 1000.0).abs() / 1000.0).clamp(0, 1)
    return (centroid_score + rolloff_score + bandwidth_score) / 3.0


def content_type(wave: Tensor, mask: Tensor, *, sample_rate: int = 16000,
                 descriptors=None) -> tuple[Tensor, Tensor]:
    """(music_prob, laughter_prob), rule-based: music = mean centroid /
    4000, laughter = var(rms) / 0.1, both clipped to [0, 1]."""
    if descriptors is None:
        descriptors = sp.spectral_descriptors(wave, mask, sample_rate=sample_rate)
    music = (descriptors[0] / 4000.0).clamp(0.0, 1.0)
    energy = sp.rms_frames(wave, frame_length=2048, hop=512)
    fmask = sp.center_frame_mask(mask, 512, energy.shape[-1])
    laughter = (sp.masked_var(energy, fmask) / 0.1).clamp(0.0, 1.0)
    return music, laughter


def abstain_decision(snr_db, clipping_pct, speech_prob, lid_entropy, music_prob) -> Tensor:
    """Vectorized EarlyAbstainPolicy.make_decision: int32 codes."""
    reject = (snr_db < SNR_LOW) | (clipping_pct > CLIPPING_MAX_PCT) | (speech_prob < SPEECH_LOW)
    uncertain = (((snr_db >= SNR_LOW) & (snr_db < SNR_HIGH))
                 | (lid_entropy > LID_ENTROPY_MAX) | (music_prob > MUSIC_MAX))
    accept = ((snr_db >= SNR_HIGH) & (speech_prob >= SPEECH_HIGH)
              & (lid_entropy < LID_ENTROPY_MAX))
    d = torch.where(accept, ACCEPT, UNCERTAIN)      # default 'uncertain'
    d = torch.where(uncertain, UNCERTAIN, d)
    d = torch.where(reject, REJECT, d)
    return d.to(torch.int32)


def quality_score(snr_db, speech_prob, clipping_pct, naturalness, lid_entropy,
                  music_prob) -> Tensor:
    """Weighted quality score."""
    snr_score = (snr_db / 20.0).clamp(0, 1)
    clip_score = 1.0 - (clipping_pct / 100.0).clamp(0, 1)
    lid_score = 1.0 - (lid_entropy / 2.0).clamp(0, 1)
    music_score = 1.0 - music_prob
    return (0.25 * snr_score + 0.25 * speech_prob + 0.15 * clip_score
            + 0.15 * naturalness + 0.10 * lid_score + 0.10 * music_score)


def quality_gates(wave: Tensor, mask: Tensor, *, lid_entropy: Tensor,
                  lid_confidence: Tensor, sample_rate: int = 16000,
                  zero_non_accept: bool = False) -> tuple[Tensor, QualityStats]:
    """Run the full gate battery; returns (processed_wave, stats).

    processed_wave is zeroed where the decision is 'reject';
    zero_non_accept=True also zeroes 'uncertain' clips (the reference
    encoder's behaviour; see ModelConfig.zero_non_accept). stats.features
    is the raw 8-dim vector; its learned projection is the model's
    `quality_proj`."""
    speech_prob = energy_vad(wave, mask, sample_rate=sample_rate)
    clip_pct = clipping_percent(wave, mask)
    # one centered 2048/512 STFT serves SNR, naturalness and content type
    if wave.shape[-1] > SNR_N_FFT:
        S_c = sp.stft_mag(wave, n_fft=SNR_N_FFT, hop=SNR_HOP)        # [B, F_c, bins]
        snr_db = estimate_snr(wave, mask, S=S_c)
    else:                                                            # sub-window clips
        S_c = None
        snr_db = estimate_snr(wave, mask)
    desc = sp.spectral_descriptors(wave, mask, sample_rate=sample_rate, S=S_c)
    naturalness = spectral_naturalness(wave, mask, sample_rate=sample_rate, descriptors=desc)
    music, laughter = content_type(wave, mask, sample_rate=sample_rate, descriptors=desc)

    decision = abstain_decision(snr_db, clip_pct, speech_prob, lid_entropy, music)
    score = quality_score(snr_db, speech_prob, clip_pct, naturalness, lid_entropy, music)
    features = torch.stack([
        speech_prob, snr_db / 50.0, clip_pct / 100.0, naturalness,
        lid_entropy / 2.0, lid_confidence, music, laughter], dim=-1)

    zero_here = (decision != ACCEPT) if zero_non_accept else (decision == REJECT)
    processed = torch.where(zero_here[:, None], 0.0, wave)
    stats = QualityStats(speech_prob=speech_prob, snr_db=snr_db,
                         clipping_percent=clip_pct, spectral_naturalness=naturalness,
                         lid_entropy=lid_entropy, lid_confidence=lid_confidence,
                         music_prob=music, laughter_prob=laughter,
                         decision=decision, quality_score=score, features=features)
    return processed, stats

"""Audio conditioning: hum notch, HPF, denoise, dereverb, loudness norm.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
frontend/conditioning.py: the chain as one batched function on the input's
device. Zero-phase IIR filters (filtfilt of iirnotch / butter) are their
exact steady-state |H(f)|^2 responses applied in the rfft domain.

The heavy stages (the notch/HPF fft round trip, the spectral-gate
denoiser, the dereverb Welch pass) run only when some utterance of the
batch needs them, as the JAX module's `lax.cond` gates do. Each such gate
goes through `gated`: run eagerly, a Python `if` on one predicate read back
from the device, the only host reads of the chain; traced by torch.export,
a `torch.cond`, so that the exported program keeps both branches and picks
on the device. `condition_audio` takes three: notch/HPF, denoise (which
also decides the post-denoise SNR), dereverb. The values are the same
whichever way a gate goes, since the rows that do not need a stage are
selected past it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils import profiling
from ..utils.runtime import export_safe_cache
from . import spectral as sp

Tensor = torch.Tensor

HUM_FREQS = (50.0, 60.0)
NOTCH_Q = 30.0
SNR_DENOISE_THRESHOLD = 15.0
T60_THRESHOLD = 0.5
TARGET_LUFS = -23.0
MAX_GAIN_DB = 6.0
MAX_COMPRESSION = 4.0
WELCH_NPERSEG = 2048

# detect_noise_type's categories; stats carry the int32 code, NOISE_TYPES
# maps it back to the reference's strings for reports
NOISE_TYPES = ("unknown", "low_frequency", "high_frequency", "mid_frequency",
               "white_noise")
(NOISE_UNKNOWN, NOISE_LOW_FREQ, NOISE_HIGH_FREQ, NOISE_MID_FREQ,
 NOISE_WHITE) = range(5)


class ConditioningStats(NamedTuple):
    hum_filtered: Tensor       # [B] bool
    hpf_applied: Tensor        # [B] bool
    denoise_applied: Tensor    # [B] bool
    dereverb_applied: Tensor   # [B] bool
    snr_before: Tensor         # [B] dB
    snr_after: Tensor          # [B] dB
    denoise_gain_db: Tensor    # [B]
    estimated_t60: Tensor      # [B] s
    lufs_original: Tensor      # [B]
    lufs_adjustment: Tensor    # [B] dB
    peak_reduction_db: Tensor  # [B]
    compression_ratio: Tensor  # [B]
    hpf_cutoff: Tensor         # [B] Hz
    noise_type: Tensor         # [B] int32 code into NOISE_TYPES
    features: Tensor           # [B, 12] raw (pre-projection) feature vector


def read_gate(pred: Tensor, name: str) -> bool:
    """The 0-d bool `pred` read back from the device: a gate's one host
    read, in the span "sync.dsp_<name>", counted in the counters
    "dsp.<name>.reads" and, where it holds, "dsp.<name>.taken"."""
    with profiling.span(f"sync.dsp_{name}"):
        taken = bool(pred)
    profiling.count(f"dsp.{name}.reads")
    profiling.count(f"dsp.{name}.taken", int(taken))
    return taken


def gated(pred: Tensor, run, skip, operands: tuple, *, name: str):
    """run(*operands) if the 0-d bool `pred` holds, else skip(*operands).
    Eagerly a Python `if` on `pred` read back from the device
    (`read_gate`); while torch.export traces, `torch.cond` (JAX's `lax.cond`),
    whose branches take every tensor they read as an operand and may not
    return one (torch 2.11 refuses the aliasing): a branch's output that is
    an operand is cloned there."""
    if torch.compiler.is_exporting():
        def fresh(branch):
            def call(*ops):
                out = branch(*ops)
                outs = out if isinstance(out, tuple) else (out,)
                outs = tuple(o.clone() if any(o is a for a in ops) else o for o in outs)
                return outs if isinstance(out, tuple) else outs[0]
            return call
        return torch.cond(pred, fresh(run), fresh(skip), operands)
    return run(*operands) if read_gate(pred, name) else skip(*operands)


def _zero_phase_apply(wave: Tensor, mag_sq_response: Tensor) -> Tensor:
    """Apply |H(f)|^2 in the rfft domain == steady-state filtfilt."""
    spec = torch.fft.rfft(wave, dim=-1)
    return torch.fft.irfft(spec * mag_sq_response, n=wave.shape[-1], dim=-1)


def _notch_mag_sq_freqs(freqs: Tensor, sample_rate: int, f0: float, Q: float) -> Tensor:
    """|H(f)|^2 of scipy.signal.iirnotch(f0, Q) on a float64 frequency
    grid, evaluated in float64 and returned as f32."""
    w = 2 * math.pi * freqs.double() / sample_rate
    w0 = 2 * math.pi * f0 / sample_rate
    bw = w0 / Q
    gb = 1.0 / math.sqrt(2.0)
    beta = (math.sqrt(1.0 - gb ** 2) / gb) * math.tan(bw / 2.0)
    gain = 1.0 / (1.0 + beta)
    b = (gain, -2.0 * math.cos(w0) * gain, gain)
    a = (1.0, -2.0 * math.cos(w0) * gain, 2.0 * gain - 1.0)
    z = torch.exp(torch.complex(torch.zeros_like(w), -w))
    z2 = z * z
    H = (b[0] + b[1] * z + b[2] * z2) / (a[0] + a[1] * z + a[2] * z2)
    return (H.abs() ** 2).float()


@export_safe_cache(maxsize=16)
def _notch_mag_sq(n: int, sample_rate: int, f0: float, Q: float,
                  device: torch.device) -> Tensor:
    """The notch's |H|^2 on the length-n rfft grid, cached per grid."""
    return _notch_mag_sq_freqs(sp.rfftfreq(n, sample_rate, device, torch.float64),
                               sample_rate, f0, Q)


def _butter_hp_mag_sq_on(freqs: Tensor, cutoff: Tensor, order: int = 4) -> Tensor:
    """|H(f)|^2 of an order-n Butterworth HPF on a frequency grid:
    1 / (1 + (fc/f)^(2n)). cutoff [B] -> [B, len(freqs)]."""
    f = freqs.float()
    ratio = cutoff[:, None] / f[None, :].clamp(min=1e-6)
    return 1.0 / (1.0 + ratio ** (2 * order))


def _butter_hp_mag_sq(T: int, sample_rate: int, cutoff: Tensor, order: int = 4) -> Tensor:
    """Same response on the length-T rfft grid."""
    return _butter_hp_mag_sq_on(sp.rfftfreq(T, sample_rate, cutoff.device), cutoff, order)


def _detect_hum_from_psd(freqs: Tensor, psd: Tensor) -> Tensor:
    """[B, len(HUM_FREQS)] flags: the PSD at the bin nearest each hum
    frequency above mean + 2 std of the PSD (population std)."""
    thr = psd.mean(-1) + 2.0 * psd.std(-1, correction=0)              # [B]
    bins = torch.stack([(freqs - f0).abs().argmin() for f0 in HUM_FREQS])
    return psd.index_select(-1, bins) > thr[:, None]


def detect_hum(wave: Tensor, mask: Tensor, *, sample_rate: int) -> Tensor:
    """Per-hum-frequency detection flags [B, len(HUM_FREQS)] (Welch peak >
    mean + 2 std of the PSD)."""
    freqs, psd = sp.welch_psd(wave, mask, sample_rate=sample_rate, nperseg=WELCH_NPERSEG)
    return _detect_hum_from_psd(freqs, psd)


def _notch_response(flags: Tensor, n: int, sample_rate: int) -> Tensor:
    """Product of the detected lines' notch responses, per row: [B, n//2+1]."""
    resp = torch.ones(flags.shape[0], n // 2 + 1, device=flags.device)
    for i, f0 in enumerate(HUM_FREQS):
        r = _notch_mag_sq(n, sample_rate, f0, NOTCH_Q, flags.device)
        resp = resp * torch.where(flags[:, i, None], r[None, :], 1.0)
    return resp


def hum_notch(wave: Tensor, mask: Tensor, *, sample_rate: int):
    """Notch out detected hum lines, in one fft round trip that runs only
    when some row has hum. Returns (filtered, any_filtered [B])."""
    flags = detect_hum(wave, mask, sample_rate=sample_rate)          # [B, H]
    out = wave
    if bool(flags.any()):
        out = _zero_phase_apply(wave, _notch_response(flags, wave.shape[-1], sample_rate))
    return out * mask, flags.any(-1)


def _hpf_decision_from_psd(freqs: Tensor, psd: Tensor):
    low = (freqs < 200.0).to(psd.dtype)
    low_ratio = (psd * low).sum(-1) / psd.sum(-1).clamp(min=1e-20)
    should = low_ratio > 0.2
    cum = torch.cumsum(psd, dim=-1)
    cut_idx = (cum > 0.1 * cum[..., -1:]).to(torch.uint8).argmax(-1)   # first bin
    cutoff = freqs.float()[cut_idx].clamp(80.0, 100.0)
    return should, torch.where(should, cutoff, 80.0)


def hpf_decision(wave: Tensor, mask: Tensor, *, sample_rate: int):
    """(should_apply [B], cutoff_hz [B]): more than 20 % of the PSD below
    200 Hz; cutoff where 10 % of the energy is reached, in [80, 100] Hz."""
    freqs, psd = sp.welch_psd(wave, mask, sample_rate=sample_rate, nperseg=WELCH_NPERSEG)
    return _hpf_decision_from_psd(freqs, psd)


def apply_hpf(wave: Tensor, mask: Tensor, should: Tensor, cutoff: Tensor,
              *, sample_rate: int) -> Tensor:
    """The HPF on the rows that should have it; the fft round trip runs
    only when some row does."""
    if not bool(should.any()):
        return wave
    filtered = _zero_phase_apply(wave, _butter_hp_mag_sq(wave.shape[-1], sample_rate,
                                                         cutoff)) * mask
    return torch.where(should[:, None], filtered, wave)


def estimate_snr_energy(wave: Tensor, mask: Tensor) -> Tensor:
    """Energy / 10th-percentile noise-floor SNR, in [0, 50] dB."""
    sq = wave ** 2
    energy = sp.masked_mean(sq, mask)
    floor = sp.masked_quantile(sq, mask, 0.10)
    snr = 10.0 * torch.log10(energy / floor.clamp(min=1e-20))
    snr = torch.where(floor > 0, snr, 50.0)
    return snr.clamp(0.0, 50.0)


def classify_noise_psd(freqs: Tensor, psd: Tensor) -> Tensor:
    """Band-ratio noise classification from a Welch PSD: energies in
    [0, 500) / [500, 2000) / [2000, inf) Hz; low > 0.5 -> low_frequency,
    elif high > 0.4 -> high_frequency, elif mid > 0.6 -> mid_frequency,
    else white_noise; zero total -> unknown. int32 codes [B]."""
    band = lambda m: (psd * m.to(psd.dtype)).sum(-1)
    e_low = band(freqs < 500.0)
    e_mid = band((freqs >= 500.0) & (freqs < 2000.0))
    e_high = band(freqs >= 2000.0)
    total = e_low + e_mid + e_high
    t = total.clamp(min=1e-30)
    code = torch.where(e_low / t > 0.5, NOISE_LOW_FREQ,
                       torch.where(e_high / t > 0.4, NOISE_HIGH_FREQ,
                                   torch.where(e_mid / t > 0.6, NOISE_MID_FREQ, NOISE_WHITE)))
    return torch.where(total > 0, code, NOISE_UNKNOWN).to(torch.int32)


def detect_noise_type(wave: Tensor, mask: Tensor, *, sample_rate: int) -> Tensor:
    """Standalone noise-type detection on its own nperseg=1024 Welch pass
    (the reference's); condition_audio classifies its shared 2048 grid."""
    freqs, psd = sp.welch_psd(wave, mask, sample_rate=sample_rate, nperseg=1024)
    return classify_noise_psd(freqs, psd)


@export_safe_cache(maxsize=16)
def _overlap_add_norm(out_len: int, n_fft: int, hop: int, device: torch.device) -> Tensor:
    """The window-square normaliser of an overlap-add of hann frames into
    out_len samples, max(sum of win^2, 1e-8): [out_len], cached per shape."""
    num_frames = 1 + (out_len - n_fft) // hop
    win2 = sp.hann_window(n_fft, device).square()
    cols = win2[None, :, None].expand(1, n_fft, num_frames)
    wsum = F.fold(cols, (1, out_len), (1, n_fft), stride=(1, hop)).reshape(-1)
    return wsum.clamp(min=1e-8)


def spectral_gate_denoise(wave: Tensor, mask: Tensor, *, n_fft: int = 1024,
                          hop: int = 256) -> Tensor:
    """Batched spectral gating: noise profile from the first and last 10 %
    of valid frames, Wiener-style magnitude gain smoothed over 3 frames,
    overlap-add resynthesis."""
    B, T = wave.shape
    pad = n_fft // 2
    frames = sp.frame_signal(sp.reflect_pad(wave, pad), n_fft, hop)   # [B, F, n]
    win = sp.hann_window(n_fft, wave.device)
    re, im = sp.framed_rfft(frames * win)                             # [B, F, bins]
    mag = torch.sqrt(re * re + im * im)

    fmask = (sp.frame_signal(F.pad(mask, (pad, pad)), n_fft, hop).mean(-1) > 0.25).to(wave.dtype)
    n_valid = fmask.sum(-1)
    n_edge = (0.1 * n_valid).to(torch.int32).clamp(min=1)
    rank = torch.cumsum(fmask, dim=-1)
    edge = (((rank <= n_edge[:, None]) | (rank > (n_valid - n_edge)[:, None]))
            & (fmask > 0))[..., None].to(mag.dtype)
    noise_mag = sp.masked_mean(mag, edge, dim=1)
    noise_std = torch.sqrt(sp.masked_var(mag, edge, dim=1))
    thresh = (noise_mag + 1.5 * noise_std)[:, None, :]                # [B, 1, bins]
    gain = ((mag - thresh) / mag.clamp(min=1e-10)).clamp(0.0, 1.0)
    # 3-tap moving average over time, zero beyond the ends (numpy's
    # convolve "same"), as shifted products: a cuDNN conv1d would take TF32
    # under torch's default cudnn.allow_tf32
    k = 1.0 / 3.0
    g = F.pad(gain, (0, 0, 1, 1))
    gain = g[:, :-2] * k + g[:, 1:-1] * k + g[:, 2:] * k

    recon = sp.framed_irfft(re * gain, im * gain, n_fft) * win        # [B, F, n]
    out_len = T + 2 * pad
    out = F.fold(recon.transpose(1, 2), (1, out_len), (1, n_fft), stride=(1, hop))
    out = out.reshape(B, out_len) / _overlap_add_norm(out_len, n_fft, hop, wave.device)
    return out[:, pad:pad + T] * mask


def estimate_t60(wave: Tensor, mask: Tensor, *, sample_rate: int) -> Tensor:
    """Energy-decay T60 estimate with the reference's actual semantics,
    which give 0.0 or 0.1: t60 = 0 when the peak sample carries under 0.1 %
    of the post-peak energy, else 0.1; short (< 1 s after the peak) or
    silent decays 0.1. It never exceeds 0.1 s, so the dereverb gate
    (> 0.5 s) does not fire on real audio; kept as it is."""
    T = wave.shape[-1]
    sq = wave.square()
    peak_sq = (sq * mask).amax(-1)                                    # [B]
    peak_idx = (wave.abs() * mask).argmax(-1)                         # [B], first maximum
    t = torch.arange(T, device=wave.device)
    after = (t[None, :] >= peak_idx[:, None]) & (mask > 0)
    total = (sq * after).sum(-1)
    t60 = torch.where(peak_sq < 1e-3 * total, 0.0, 0.1)
    valid_len = mask.sum(-1)
    short = (valid_len - peak_idx.to(valid_len.dtype)) < sample_rate
    t60 = torch.where(short | (total <= 0), 0.1, t60)
    return t60.clamp(0.0, 2.0)


def dereverb(wave: Tensor, mask: Tensor, t60: Tensor, *,
             sample_rate: int) -> tuple[Tensor, Tensor]:
    """Mean-gain spectral-subtraction dereverb where T60 > 0.5 s (the
    reference scales the whole clip by the mean per-bin gain); the Welch
    pass runs only when some row is reverberant. Returns (out, gain_db)."""
    apply = t60 > T60_THRESHOLD

    def run(wave, mask, apply):
        _, psd = sp.welch_psd(wave, mask, sample_rate=sample_rate, nperseg=1024)
        reverb_est = psd.mean(-1, keepdim=True) * 0.1
        psd_clean = torch.maximum(psd - reverb_est, psd * 0.1)
        gain = torch.sqrt(psd_clean / (psd + 1e-10)).clamp(0.1, 1.0)
        return torch.where(apply[:, None], wave * gain.mean(-1)[:, None], wave)

    out = gated(apply.any(), run, lambda wave, mask, apply: wave, (wave, mask, apply),
                name="dereverb")
    orig_e = sp.masked_mean(wave ** 2, mask)
    new_e = sp.masked_mean(out ** 2, mask)
    gain_db = torch.where(apply & (new_e > 0),
                          10.0 * torch.log10(new_e.clamp(min=1e-20) / orig_e.clamp(min=1e-20)),
                          0.0)
    return out, gain_db


def measure_lufs(wave: Tensor, mask: Tensor) -> Tensor:
    """RMS-based LUFS approximation: 20 log10(rms) - 70 (-60 for silence)."""
    rms = torch.sqrt(sp.masked_mean(wave ** 2, mask))
    return torch.where(rms > 0, 20.0 * torch.log10(rms.clamp(min=1e-20)) - 70.0, -60.0)


def normalize_loudness(wave: Tensor, mask: Tensor):
    """Compression (if the dynamic range exceeds 40 dB) and a gain toward
    -23 LUFS clamped to +-6 dB. Returns (out, lufs_original,
    lufs_adjustment, peak_reduction_db, compression_ratio)."""
    lufs_orig = measure_lufs(wave, mask)
    rms = torch.sqrt(sp.masked_mean(wave ** 2, mask))
    peak = (wave.abs() * mask).amax(-1)
    dr_db = torch.where(rms > 0, 20.0 * torch.log10(peak.clamp(min=1e-20)
                                                    / rms.clamp(min=1e-20)), 0.0)
    need_comp = dr_db > 40.0
    ratio = torch.where(need_comp, (dr_db / 40.0).clamp(max=MAX_COMPRESSION), 1.0)
    thr = (rms * 2.0)[:, None]
    absw = wave.abs()
    compressed = torch.where(absw > thr,
                             torch.sign(wave) * (thr + (absw - thr) / ratio[:, None]), wave)
    out = torch.where(need_comp[:, None], compressed, wave)

    adj = (TARGET_LUFS - lufs_orig).clamp(-MAX_GAIN_DB, MAX_GAIN_DB)
    out = out * (10.0 ** (adj / 20.0))[:, None]
    new_peak = (out.abs() * mask).amax(-1)
    peak_red = torch.where(peak > 0, 20.0 * torch.log10(new_peak.clamp(min=1e-20)
                                                        / peak.clamp(min=1e-20)), 0.0)
    return out, lufs_orig, adj, peak_red, ratio


def condition_audio(wave: Tensor, mask: Tensor, *,
                    sample_rate: int = 16000) -> tuple[Tensor, ConditioningStats]:
    """Full conditioning chain: notch -> HPF -> denoise -> dereverb ->
    loudness. Returns (conditioned_wave, stats); stats.features is the raw
    12-dim vector (its learned projection is the model's `cond_proj`).

    As in the JAX module, notch and HPF share one Welch pass and one fft
    round trip: the HPF decision reads the post-notch PSD as psd * |H_notch|^2
    on the Welch grid, and the noise type reads it with the HPF's response
    folded in too."""
    T = wave.shape[-1]
    n_w = min(WELCH_NPERSEG, T)
    freqs_w, psd0 = sp.welch_psd(wave, mask, sample_rate=sample_rate, nperseg=n_w)
    hum_flags = _detect_hum_from_psd(freqs_w, psd0)                  # [B, H]
    hum_filtered = hum_flags.any(-1)
    notch_w = _notch_response(hum_flags, n_w, sample_rate)
    should_hpf, cutoff = _hpf_decision_from_psd(freqs_w, psd0 * notch_w)

    def notch_hpf(wave, mask, hum_flags, should_hpf, cutoff):
        resp = _notch_response(hum_flags, T, sample_rate)
        hp = _butter_hp_mag_sq(T, sample_rate, cutoff)
        resp = resp * torch.where(should_hpf[:, None], hp, 1.0)
        return _zero_phase_apply(wave, resp) * mask

    x = gated(hum_filtered.any() | should_hpf.any(), notch_hpf,          # host read 1
              lambda wave, *_: wave, (wave, mask, hum_flags, should_hpf, cutoff),
              name="notch_hpf")
    x = x * mask
    cutoff_feat = torch.where(should_hpf, cutoff, 0.0)

    # noise type on the post-notch/HPF signal, from the shared Welch PSD
    psd_post = psd0 * notch_w * torch.where(
        should_hpf[:, None], _butter_hp_mag_sq_on(freqs_w, cutoff), 1.0)
    noise_type = classify_noise_psd(freqs_w, psd_post)

    snr_before = estimate_snr_energy(x, mask)
    need_denoise = snr_before < SNR_DENOISE_THRESHOLD

    def denoise(x, mask, need_denoise, snr_before):
        x = torch.where(need_denoise[:, None], spectral_gate_denoise(x, mask), x)
        return x, estimate_snr_energy(x, mask)

    # x unchanged, and so its SNR, where no row is denoised
    x, snr_after = gated(need_denoise.any(), denoise,                   # host read 2
                         lambda x, mask, need_denoise, snr_before: (x, snr_before),
                         (x, mask, need_denoise, snr_before), name="denoise")
    orig_e = sp.masked_mean(wave ** 2, mask)
    new_e = sp.masked_mean(x ** 2, mask)
    denoise_gain = torch.where(
        need_denoise & (new_e > 0),
        10.0 * torch.log10(new_e.clamp(min=1e-20) / orig_e.clamp(min=1e-20)), 0.0)

    t60 = estimate_t60(x, mask, sample_rate=sample_rate)
    x, _ = dereverb(x, mask, t60, sample_rate=sample_rate)           # host read 3
    dereverb_applied = t60 > T60_THRESHOLD

    x, lufs_orig, lufs_adj, peak_red, comp_ratio = normalize_loudness(x, mask)
    x = x * mask

    features = torch.stack([
        hum_filtered.float(), should_hpf.float(), need_denoise.float(),
        dereverb_applied.float(), snr_before / 50.0, snr_after / 50.0,
        denoise_gain / 20.0, t60 / 2.0, (lufs_orig + 60.0) / 60.0,
        lufs_adj / 20.0, peak_red / 20.0, comp_ratio / 4.0], dim=-1)
    stats = ConditioningStats(
        hum_filtered=hum_filtered, hpf_applied=should_hpf,
        denoise_applied=need_denoise, dereverb_applied=dereverb_applied,
        snr_before=snr_before, snr_after=snr_after, denoise_gain_db=denoise_gain,
        estimated_t60=t60, lufs_original=lufs_orig, lufs_adjustment=lufs_adj,
        peak_reduction_db=peak_red, compression_ratio=comp_ratio,
        hpf_cutoff=cutoff_feat, noise_type=noise_type, features=features)
    return x, stats


def conditioning_report(stats: ConditioningStats, i: int = 0) -> str:
    """Human-readable report of utterance i (reads the stats on the host)."""
    g = lambda a: float(a[i])
    return f"""
Audio Conditioning Report:
==========================
Processing Applied:
  - Hum Filtering: {'Yes' if g(stats.hum_filtered) else 'No'}
  - High-Pass Filter: {'Yes' if g(stats.hpf_applied) else 'No'} (cutoff: {g(stats.hpf_cutoff):.0f} Hz)
  - Denoising: {'Yes' if g(stats.denoise_applied) else 'No'}
  - Dereverberation: {'Yes' if g(stats.dereverb_applied) else 'No'}

Quality Metrics:
  - SNR Before: {g(stats.snr_before):.1f} dB
  - SNR After: {g(stats.snr_after):.1f} dB
  - Denoise Gain: {g(stats.denoise_gain_db):.1f} dB
  - Estimated T60: {g(stats.estimated_t60):.2f} s
  - Noise Type: {NOISE_TYPES[int(stats.noise_type[i])]}

Loudness Normalization:
  - Original LUFS: {g(stats.lufs_original):.1f}
  - LUFS Adjustment: {g(stats.lufs_adjustment):.1f} dB
  - Peak Reduction: {g(stats.peak_reduction_db):.1f} dB
  - Compression Ratio: {g(stats.compression_ratio):.1f}
"""

"""Plain front-end DSP of the reference: quality gates, then conditioning.

Frozen copy of the arithmetic of the port's `frontend/spectral.py`,
`frontend/quality_gates.py` and `frontend/conditioning.py` (themselves the
reference repository's `src/frontend` semantics), with the port's caches,
its `torch.export` branches and its statistics tuples left out. Every
function keeps the port's order of operations, so that on one device the
gates' decisions (reject, hum, HPF, denoise) come out bit for bit as the
port's do: a decision that flipped at a threshold would move a clip's
whole logit vector, not its rounding.

The heavy stages run only when some row of the batch needs them (a plain
Python `if` on the batch's `any()`, as the reference's per-batch gates
do); rows that do not need a stage are selected past it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# quality gates (EarlyAbstainPolicy)
SNR_LOW, SNR_HIGH = 5.0, 10.0
CLIPPING_MAX_PCT = 30.0
SPEECH_LOW, SPEECH_HIGH = 0.4, 0.8
LID_ENTROPY_MAX = 1.5
MUSIC_MAX = 0.2
REJECT, UNCERTAIN, ACCEPT = 0, 1, 2
SNR_N_FFT, SNR_HOP = 2048, 512
BOUNDARY_FRAMES = 3

# conditioning
HUM_FREQS = (50.0, 60.0)
NOTCH_Q = 30.0
SNR_DENOISE_THRESHOLD = 15.0
T60_THRESHOLD = 0.5
TARGET_LUFS = -23.0
MAX_GAIN_DB = 6.0
MAX_COMPRESSION = 4.0
WELCH_NPERSEG = 2048


# ---------------------------------------------------------------- spectral

def hann_window(n: int, device) -> Tensor:
    k = torch.arange(n, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)).float()


def rfftfreq(n: int, sample_rate: int, device, dtype=torch.float32) -> Tensor:
    step = 1.0 / (n * (1.0 / sample_rate))
    k = torch.arange(n // 2 + 1, dtype=torch.float64, device=device)
    return (k * step).to(dtype)


def reflect_pad(x: Tensor, pad: int) -> Tensor:
    T = x.shape[-1]
    i = torch.arange(-pad, T + pad, device=x.device)
    if T == 1:
        idx = torch.zeros_like(i)
    else:
        period = 2 * (T - 1)
        m = i.abs() % period
        idx = torch.where(m >= T, period - m, m)
    return x.index_select(-1, idx)


def frame_signal(wave: Tensor, frame_length: int, hop: int) -> Tensor:
    T = wave.shape[-1]
    if T < frame_length:
        wave = torch.cat([wave, wave[..., -1:].expand(*wave.shape[:-1], frame_length - T)], -1)
    return wave.unfold(-1, frame_length, hop)


def center_frame_mask(mask: Tensor, hop: int, num_frames: int) -> Tensor:
    valid_len = mask.sum(-1, keepdim=True)
    starts = torch.arange(num_frames, dtype=mask.dtype, device=mask.device)[None, :] * hop
    return (starts <= valid_len).to(mask.dtype)


def full_frame_mask(mask: Tensor, frame_length: int, hop: int, num_frames: int) -> Tensor:
    valid_len = mask.sum(-1, keepdim=True)
    ends = (torch.arange(num_frames, dtype=mask.dtype, device=mask.device)[None, :] * hop
            + frame_length)
    out = (ends <= valid_len).to(mask.dtype)
    out[..., 0].fill_(1.0)
    return out


def framed_rfft(frames: Tensor):
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real, spec.imag


def framed_irfft(re: Tensor, im: Tensor, n: int) -> Tensor:
    return torch.fft.irfft(torch.complex(re, im), n=n, dim=-1)


def frame_magnitude(frames: Tensor, win: Tensor) -> Tensor:
    re, im = framed_rfft(frames * win)
    return torch.sqrt(re * re + im * im)


def stft_mag(wave: Tensor, *, n_fft: int = 2048, hop: int = 512, center: bool = True) -> Tensor:
    if center:
        wave = reflect_pad(wave, n_fft // 2)
    return frame_magnitude(frame_signal(wave, n_fft, hop), hann_window(n_fft, wave.device))


def stft_frame_mask(mask: Tensor, *, n_fft: int = 2048, hop: int = 512) -> Tensor:
    T = mask.shape[-1]
    num_frames = max(1 + (T + 2 * (n_fft // 2) - n_fft) // hop, 1)
    return center_frame_mask(mask, hop, num_frames)


def rms_frames(wave: Tensor, *, frame_length: int, hop: int) -> Tensor:
    pad = frame_length // 2
    x2 = F.pad(wave.float().square(), (pad, pad))
    sumsq = x2.unfold(-1, frame_length, hop).sum(-1)
    return torch.sqrt(sumsq.clamp(min=0.0) / frame_length)


def masked_mean(x: Tensor, mask: Tensor, dim: int = -1, eps: float = 1e-10) -> Tensor:
    return (x * mask).sum(dim) / (mask.sum(dim) + eps)


def masked_var(x: Tensor, mask: Tensor, dim: int = -1, eps: float = 1e-10) -> Tensor:
    mu = masked_mean(x, mask, dim=dim, eps=eps)
    return masked_mean((x - mu.unsqueeze(dim)) ** 2, mask, dim=dim, eps=eps)


def masked_std(x: Tensor, mask: Tensor, dim: int = -1, eps: float = 1e-10) -> Tensor:
    return torch.sqrt(masked_var(x, mask, dim=dim, eps=eps))


def masked_quantile(x: Tensor, mask: Tensor, q: float) -> Tensor:
    """np.percentile's linear interpolation over the valid entries of each row."""
    N = x.shape[-1]
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(mask > 0, x, big), dim=-1).values
    n = mask.sum(-1)
    pos = q * (n - 1.0).clamp(min=0.0)
    lo = torch.floor(pos).long().clamp(0, N - 1)
    hi = (lo + 1).clamp(0, N - 1)
    frac = pos - lo.to(pos.dtype)
    vlo = xs.gather(-1, lo[:, None])[:, 0]
    vhi = xs.gather(-1, hi[:, None])[:, 0]
    vhi = torch.where(hi.to(pos.dtype) <= pos, vlo, vhi)
    return vlo + frac * (vhi - vlo)


def median_smooth_bool(x: Tensor, size: int = 5) -> Tensor:
    pad = size // 2
    xp = F.pad(x.float()[:, None], (pad, pad), mode="replicate")[:, 0]
    return xp.unfold(-1, size, 1).sum(-1) > (size / 2.0)


def welch_psd(wave: Tensor, mask: Tensor, *, sample_rate: int, nperseg: int = 2048):
    """scipy.signal.welch (hann, 50 % overlap, constant detrend, density)
    over each row's whole frames. Returns (freqs f64, psd [B, bins])."""
    T = wave.shape[-1]
    nperseg = min(nperseg, T)
    hop = nperseg // 2
    frames = frame_signal(wave, nperseg, hop)
    fmask = full_frame_mask(mask, nperseg, hop, frames.shape[-2])
    frames = frames - frames.mean(-1, keepdim=True)
    win = hann_window(nperseg, wave.device)
    re, im = framed_rfft(frames * win)
    scale = (1.0 / (sample_rate * win.double().square().sum())).float()
    spec = (re * re + im * im) * scale
    spec[..., 1:-1] *= 2.0
    psd = masked_mean(spec, fmask[..., None], dim=-2)
    return rfftfreq(nperseg, sample_rate, wave.device, torch.float64), psd


def spectral_descriptors(wave: Tensor, mask: Tensor, *, sample_rate: int, S: Tensor,
                         n_fft: int = 2048, hop: int = 512):
    fmask = stft_frame_mask(mask, n_fft=n_fft, hop=hop)
    freqs = rfftfreq(n_fft, sample_rate, S.device).to(S.dtype)
    norm = S.sum(-1) + 1e-10
    centroid = (S * freqs).sum(-1) / norm
    cum = torch.cumsum(S, dim=-1)
    roll_idx = (cum >= 0.85 * cum[..., -1:]).to(torch.uint8).argmax(-1)
    rolloff = freqs[roll_idx]
    bandwidth = torch.sqrt(((freqs - centroid[..., None]) ** 2 * S).sum(-1) / norm)
    return (masked_mean(centroid, fmask), masked_mean(rolloff, fmask),
            masked_mean(bandwidth, fmask))


# ----------------------------------------------------------- quality gates

def energy_vad(wave: Tensor, mask: Tensor, *, sample_rate: int) -> Tensor:
    frame = int(sample_rate * 0.025)
    hop = int(sample_rate * 0.010)
    energy = rms_frames(wave, frame_length=frame, hop=hop)
    fmask = center_frame_mask(mask, hop, energy.shape[-1])
    thr = masked_quantile(energy, fmask, 0.30) + 0.1 * masked_std(energy, fmask)
    speech = (energy > thr[:, None]) & (fmask > 0)
    speech = median_smooth_bool(speech, size=5)
    return masked_mean(speech.float(), fmask)


def _boundary_frames(wave: Tensor, length: Tensor, pos: Tensor, *, n_fft: int, hop: int):
    B, T = wave.shape
    P = pos.shape[1]
    starts = pos * hop - n_fft // 2
    idx = starts[..., None] + torch.arange(n_fft, device=wave.device)
    idx = idx.abs()
    last = (length - 1)[:, None, None]
    over = idx - last
    idx = torch.where(over > 0, last - over, idx).clamp(0, T - 1)
    return wave.gather(1, idx.reshape(B, P * n_fft)).reshape(B, P, n_fft)


def estimate_snr(wave: Tensor, mask: Tensor, S: Tensor) -> Tensor:
    """librosa-style SNR from the centered 2048/512 STFT's edge frames
    (noise: the last 10 % of frames; signal: frames [k, n - k)), the frames
    that cross the clip's end rebuilt with the clip's own reflection."""
    n_fft, hop = SNR_N_FFT, SNR_HOP
    F_ = S.shape[1]
    dev = wave.device
    L = mask.sum(-1).to(torch.int32)
    n_c = 1 + L // hop
    k = (0.1 * n_c).to(torch.int32).clamp(min=1)
    j = torch.arange(F_, device=dev)[None, :]
    P = BOUNDARY_FRAMES
    pos = n_c[:, None] - (P - torch.arange(P, device=dev))[None, :]
    pos_valid = pos >= 0
    frames = _boundary_frames(wave, L, pos.clamp(0, F_ - 1), n_fft=n_fft, hop=hop)
    S_fix = frame_magnitude(frames, hann_window(n_fft, dev))
    interior = j < (n_c - P)[:, None]
    noise_c = (j >= (n_c - k)[:, None]) & (j < n_c[:, None]) & interior
    signal_c = (j >= k[:, None]) & (j < (n_c - k)[:, None]) & interior
    noise_b = pos_valid & (pos >= (n_c - k)[:, None])
    signal_b = pos_valid & (pos >= k[:, None]) & (pos < (n_c - k)[:, None])

    def _mean(mc, mb):
        tot = (S * mc[..., None]).sum(1) + (S_fix * mb[..., None]).sum(1)
        cnt = (mc.sum(-1) + mb.sum(-1)).to(S.dtype)
        return tot / cnt.clamp(min=1.0)[:, None], cnt

    noise_spec, _ = _mean(noise_c, noise_b)
    signal_spec, n_sig = _mean(signal_c, signal_b)
    all_spec, _ = _mean((j < n_c[:, None]) & interior, pos_valid)
    signal_spec = torch.where((n_sig > 0)[:, None], signal_spec, all_spec)
    signal_power = (signal_spec ** 2).mean(-1)
    noise_power = (noise_spec ** 2).mean(-1)
    snr = 10.0 * torch.log10(signal_power / noise_power.clamp(min=1e-20))
    snr = torch.where(noise_power > 0, snr, 50.0)
    return snr.clamp(0.0, 50.0)


def clipping_percent(wave: Tensor, mask: Tensor) -> Tensor:
    absw = wave.abs()
    peak = (absw * mask).amax(-1, keepdim=True)
    norm = torch.where(peak > 0, absw / peak.clamp(min=1e-12), absw)
    clipped = ((norm > 0.95) & (mask > 0)).sum(-1)
    return 100.0 * clipped / mask.sum(-1).clamp(min=1.0)


def quality_gates(wave: Tensor, mask: Tensor, *, lid_entropy: Tensor,
                  lid_confidence: Tensor, sample_rate: int, zero_non_accept: bool):
    """(processed wave, features [B, 8]): rejected clips zeroed (and the
    'uncertain' ones where zero_non_accept)."""
    if wave.shape[-1] <= SNR_N_FFT:
        raise ValueError("the reference's gates take clips longer than one 2048-sample window")
    speech_prob = energy_vad(wave, mask, sample_rate=sample_rate)
    clip_pct = clipping_percent(wave, mask)
    S_c = stft_mag(wave, n_fft=SNR_N_FFT, hop=SNR_HOP)
    snr_db = estimate_snr(wave, mask, S_c)
    centroid, rolloff, bandwidth = spectral_descriptors(wave, mask, sample_rate=sample_rate,
                                                        S=S_c)
    centroid_score = 1.0 - ((centroid - 2000.0).abs() / 2000.0).clamp(0, 1)
    rolloff_score = 1.0 - ((rolloff - 0.85).abs() / 0.15).clamp(0, 1)
    bandwidth_score = 1.0 - ((bandwidth - 1000.0).abs() / 1000.0).clamp(0, 1)
    naturalness = (centroid_score + rolloff_score + bandwidth_score) / 3.0
    music = (centroid / 4000.0).clamp(0.0, 1.0)
    energy = rms_frames(wave, frame_length=2048, hop=512)
    fmask = center_frame_mask(mask, 512, energy.shape[-1])
    laughter = (masked_var(energy, fmask) / 0.1).clamp(0.0, 1.0)

    reject = (snr_db < SNR_LOW) | (clip_pct > CLIPPING_MAX_PCT) | (speech_prob < SPEECH_LOW)
    uncertain = (((snr_db >= SNR_LOW) & (snr_db < SNR_HIGH))
                 | (lid_entropy > LID_ENTROPY_MAX) | (music > MUSIC_MAX))
    accept = ((snr_db >= SNR_HIGH) & (speech_prob >= SPEECH_HIGH)
              & (lid_entropy < LID_ENTROPY_MAX))
    decision = torch.where(accept, ACCEPT, UNCERTAIN)
    decision = torch.where(uncertain, UNCERTAIN, decision)
    decision = torch.where(reject, REJECT, decision).to(torch.int32)

    features = torch.stack([
        speech_prob, snr_db / 50.0, clip_pct / 100.0, naturalness,
        lid_entropy / 2.0, lid_confidence, music, laughter], dim=-1)
    zero_here = (decision != ACCEPT) if zero_non_accept else (decision == REJECT)
    return torch.where(zero_here[:, None], 0.0, wave), features


# ------------------------------------------------------------ conditioning

def _zero_phase_apply(wave: Tensor, mag_sq_response: Tensor) -> Tensor:
    spec = torch.fft.rfft(wave, dim=-1)
    return torch.fft.irfft(spec * mag_sq_response, n=wave.shape[-1], dim=-1)


def _notch_mag_sq(n: int, sample_rate: int, f0: float, Q: float, device) -> Tensor:
    """|H(f)|^2 of scipy.signal.iirnotch(f0, Q) on the length-n rfft grid (f64)."""
    freqs = rfftfreq(n, sample_rate, device, torch.float64)
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


def _butter_hp_mag_sq_on(freqs: Tensor, cutoff: Tensor, order: int = 4) -> Tensor:
    f = freqs.float()
    ratio = cutoff[:, None] / f[None, :].clamp(min=1e-6)
    return 1.0 / (1.0 + ratio ** (2 * order))


def _notch_response(flags: Tensor, n: int, sample_rate: int) -> Tensor:
    resp = torch.ones(flags.shape[0], n // 2 + 1, device=flags.device)
    for i, f0 in enumerate(HUM_FREQS):
        r = _notch_mag_sq(n, sample_rate, f0, NOTCH_Q, flags.device)
        resp = resp * torch.where(flags[:, i, None], r[None, :], 1.0)
    return resp


def estimate_snr_energy(wave: Tensor, mask: Tensor) -> Tensor:
    sq = wave ** 2
    energy = masked_mean(sq, mask)
    floor = masked_quantile(sq, mask, 0.10)
    snr = 10.0 * torch.log10(energy / floor.clamp(min=1e-20))
    snr = torch.where(floor > 0, snr, 50.0)
    return snr.clamp(0.0, 50.0)


def spectral_gate_denoise(wave: Tensor, mask: Tensor, *, n_fft: int = 1024,
                          hop: int = 256) -> Tensor:
    B, T = wave.shape
    pad = n_fft // 2
    frames = frame_signal(reflect_pad(wave, pad), n_fft, hop)
    win = hann_window(n_fft, wave.device)
    re, im = framed_rfft(frames * win)
    mag = torch.sqrt(re * re + im * im)
    fmask = (frame_signal(F.pad(mask, (pad, pad)), n_fft, hop).mean(-1) > 0.25).to(wave.dtype)
    n_valid = fmask.sum(-1)
    n_edge = (0.1 * n_valid).to(torch.int32).clamp(min=1)
    rank = torch.cumsum(fmask, dim=-1)
    edge = (((rank <= n_edge[:, None]) | (rank > (n_valid - n_edge)[:, None]))
            & (fmask > 0))[..., None].to(mag.dtype)
    noise_mag = masked_mean(mag, edge, dim=1)
    noise_std = torch.sqrt(masked_var(mag, edge, dim=1))
    thresh = (noise_mag + 1.5 * noise_std)[:, None, :]
    gain = ((mag - thresh) / mag.clamp(min=1e-10)).clamp(0.0, 1.0)
    k = 1.0 / 3.0
    g = F.pad(gain, (0, 0, 1, 1))
    gain = g[:, :-2] * k + g[:, 1:-1] * k + g[:, 2:] * k
    recon = framed_irfft(re * gain, im * gain, n_fft) * win
    out_len = T + 2 * pad
    out = F.fold(recon.transpose(1, 2), (1, out_len), (1, n_fft), stride=(1, hop))
    num_frames = 1 + (out_len - n_fft) // hop
    cols = win.square()[None, :, None].expand(1, n_fft, num_frames)
    norm = F.fold(cols, (1, out_len), (1, n_fft), stride=(1, hop)).reshape(-1).clamp(min=1e-8)
    out = out.reshape(B, out_len) / norm
    return out[:, pad:pad + T] * mask


def estimate_t60(wave: Tensor, mask: Tensor, *, sample_rate: int) -> Tensor:
    T = wave.shape[-1]
    sq = wave.square()
    peak_sq = (sq * mask).amax(-1)
    peak_idx = (wave.abs() * mask).argmax(-1)
    t = torch.arange(T, device=wave.device)
    after = (t[None, :] >= peak_idx[:, None]) & (mask > 0)
    total = (sq * after).sum(-1)
    t60 = torch.where(peak_sq < 1e-3 * total, 0.0, 0.1)
    valid_len = mask.sum(-1)
    short = (valid_len - peak_idx.to(valid_len.dtype)) < sample_rate
    t60 = torch.where(short | (total <= 0), 0.1, t60)
    return t60.clamp(0.0, 2.0)


def condition_audio(wave: Tensor, mask: Tensor, *, sample_rate: int):
    """(conditioned wave, features [B, 12]): notch, HPF, denoise,
    dereverb, loudness."""
    T = wave.shape[-1]
    n_w = min(WELCH_NPERSEG, T)
    freqs_w, psd0 = welch_psd(wave, mask, sample_rate=sample_rate, nperseg=n_w)
    thr = psd0.mean(-1) + 2.0 * psd0.std(-1, correction=0)
    bins = torch.stack([(freqs_w - f0).abs().argmin() for f0 in HUM_FREQS])
    hum_flags = psd0.index_select(-1, bins) > thr[:, None]
    hum_filtered = hum_flags.any(-1)
    notch_w = _notch_response(hum_flags, n_w, sample_rate)

    psd_n = psd0 * notch_w
    low = (freqs_w < 200.0).to(psd_n.dtype)
    low_ratio = (psd_n * low).sum(-1) / psd_n.sum(-1).clamp(min=1e-20)
    should_hpf = low_ratio > 0.2
    cum = torch.cumsum(psd_n, dim=-1)
    cut_idx = (cum > 0.1 * cum[..., -1:]).to(torch.uint8).argmax(-1)
    cutoff = torch.where(should_hpf, freqs_w.float()[cut_idx].clamp(80.0, 100.0), 80.0)

    x = wave
    if bool(hum_filtered.any() | should_hpf.any()):
        resp = _notch_response(hum_flags, T, sample_rate)
        hp = _butter_hp_mag_sq_on(rfftfreq(T, sample_rate, cutoff.device), cutoff)
        resp = resp * torch.where(should_hpf[:, None], hp, 1.0)
        x = _zero_phase_apply(wave, resp) * mask
    x = x * mask

    snr_before = estimate_snr_energy(x, mask)
    need_denoise = snr_before < SNR_DENOISE_THRESHOLD
    snr_after = snr_before
    if bool(need_denoise.any()):
        x = torch.where(need_denoise[:, None], spectral_gate_denoise(x, mask), x)
        snr_after = estimate_snr_energy(x, mask)
    orig_e = masked_mean(wave ** 2, mask)
    new_e = masked_mean(x ** 2, mask)
    denoise_gain = torch.where(
        need_denoise & (new_e > 0),
        10.0 * torch.log10(new_e.clamp(min=1e-20) / orig_e.clamp(min=1e-20)), 0.0)

    t60 = estimate_t60(x, mask, sample_rate=sample_rate)
    reverberant = t60 > T60_THRESHOLD
    if bool(reverberant.any()):
        _, psd = welch_psd(x, mask, sample_rate=sample_rate, nperseg=1024)
        reverb_est = psd.mean(-1, keepdim=True) * 0.1
        psd_clean = torch.maximum(psd - reverb_est, psd * 0.1)
        gain = torch.sqrt(psd_clean / (psd + 1e-10)).clamp(0.1, 1.0)
        x = torch.where(reverberant[:, None], x * gain.mean(-1)[:, None], x)

    # loudness: compression above 40 dB of dynamic range, gain toward -23 LUFS
    rms = torch.sqrt(masked_mean(x ** 2, mask))
    lufs_orig = torch.where(rms > 0, 20.0 * torch.log10(rms.clamp(min=1e-20)) - 70.0, -60.0)
    peak = (x.abs() * mask).amax(-1)
    dr_db = torch.where(rms > 0, 20.0 * torch.log10(peak.clamp(min=1e-20)
                                                    / rms.clamp(min=1e-20)), 0.0)
    need_comp = dr_db > 40.0
    ratio = torch.where(need_comp, (dr_db / 40.0).clamp(max=MAX_COMPRESSION), 1.0)
    thr_c = (rms * 2.0)[:, None]
    absw = x.abs()
    compressed = torch.where(absw > thr_c,
                             torch.sign(x) * (thr_c + (absw - thr_c) / ratio[:, None]), x)
    out = torch.where(need_comp[:, None], compressed, x)
    adj = (TARGET_LUFS - lufs_orig).clamp(-MAX_GAIN_DB, MAX_GAIN_DB)
    out = out * (10.0 ** (adj / 20.0))[:, None]
    new_peak = (out.abs() * mask).amax(-1)
    peak_red = torch.where(peak > 0, 20.0 * torch.log10(new_peak.clamp(min=1e-20)
                                                        / peak.clamp(min=1e-20)), 0.0)
    out = out * mask

    features = torch.stack([
        hum_filtered.float(), should_hpf.float(), need_denoise.float(),
        reverberant.float(), snr_before / 50.0, snr_after / 50.0,
        denoise_gain / 20.0, t60 / 2.0, (lufs_orig + 60.0) / 60.0,
        adj / 20.0, peak_red / 20.0, ratio / 4.0], dim=-1)
    return out, features


def frontend(wave: Tensor, mask: Tensor, *, sample_rate: int, use_gates: bool,
             use_conditioning: bool, zero_non_accept: bool):
    """Gates then conditioning on f32 [B, T] audio; without text the
    language-ID scalars are entropy 1 and confidence 0. Returns (wave,
    quality features [B, 8], conditioning features [B, 12])."""
    B = wave.shape[0]
    q = wave.new_zeros((B, 8))
    c = wave.new_zeros((B, 12))
    if use_gates:
        wave, q = quality_gates(wave, mask, lid_entropy=torch.ones(B, device=wave.device),
                                lid_confidence=torch.zeros(B, device=wave.device),
                                sample_rate=sample_rate, zero_non_accept=zero_non_accept)
    if use_conditioning:
        wave, c = condition_audio(wave, mask, sample_rate=sample_rate)
    return wave, q, c

"""Batched, masked spectral primitives of the front-end DSP.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
frontend/spectral.py. Every function takes padded [B, T] waveforms with a
[B, T] {0, 1} validity mask and runs on the device of its input; the
per-utterance statistics are masked reductions over valid samples or
frames only, so a clip's result does not depend on its batch's padding.

What the JAX module does for the TPU alone is not carried over: the
transforms are torch.fft on every device (no matmul DFT), and
masked_quantile sorts at every length (the bit search returns the same
order statistics). Constants the JAX module builds in numpy (windows,
frequency grids) are built here in float64 on the input's device, rounded
to float32 as JAX's x32 mode rounds them, and cached per shape and device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..utils.runtime import export_safe_cache

Tensor = torch.Tensor


@export_safe_cache(maxsize=32)
def hann_window(n: int, device: torch.device) -> Tensor:
    """Periodic Hann window (scipy.signal.get_window('hann', n)), f32."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)).float()


@export_safe_cache(maxsize=32)
def rfftfreq(n: int, sample_rate: int, device: torch.device,
             dtype: torch.dtype = torch.float32) -> Tensor:
    """np.fft.rfftfreq(n, 1 / sample_rate), computed in f64 and cast."""
    step = 1.0 / (n * (1.0 / sample_rate))
    k = torch.arange(n // 2 + 1, dtype=torch.float64, device=device)
    return (k * step).to(dtype)


@export_safe_cache(maxsize=16)
def _reflect_index(T: int, pad: int, device: torch.device) -> Tensor:
    """Indices of a length-T signal padded by `pad` on both sides with
    numpy's 'reflect' mode, for any pad (the reflection repeats with
    period 2(T - 1), as numpy's does)."""
    i = torch.arange(-pad, T + pad, device=device)
    if T == 1:
        return torch.zeros_like(i)
    period = 2 * (T - 1)
    m = i.abs() % period
    return torch.where(m >= T, period - m, m)


def reflect_pad(x: Tensor, pad: int) -> Tensor:
    """jnp.pad(x, pad, mode="reflect") over the last axis, for any length
    (F.pad's reflect mode needs pad < length)."""
    return x.index_select(-1, _reflect_index(x.shape[-1], pad, x.device))


def frame_signal(wave: Tensor, frame_length: int, hop: int) -> Tensor:
    """[B, T] -> [B, F, frame_length] strided view (no centering). A signal
    shorter than one frame gives one frame padded with its last sample."""
    T = wave.shape[-1]
    if T < frame_length:
        wave = torch.cat([wave, wave[..., -1:].expand(*wave.shape[:-1], frame_length - T)], -1)
    return wave.unfold(-1, frame_length, hop)


def frame_valid_mask(mask: Tensor, frame_length: int, hop: int,
                     min_coverage: float = 0.5) -> Tensor:
    """[B, T] sample mask -> [B, F] frame validity (frame mostly valid)."""
    frames = frame_signal(mask, frame_length, hop)
    return (frames.mean(-1) >= min_coverage).to(mask.dtype)


def center_frame_mask(mask: Tensor, hop: int, num_frames: int) -> Tensor:
    """Exact frame set of a CENTERED framing of the unpadded signal: frame
    i exists iff i*hop <= valid_len (librosa yields 1 + L//hop frames)."""
    valid_len = mask.sum(-1, keepdim=True)
    starts = torch.arange(num_frames, dtype=mask.dtype, device=mask.device)[None, :] * hop
    return (starts <= valid_len).to(mask.dtype)


def full_frame_mask(mask: Tensor, frame_length: int, hop: int,
                    num_frames: int) -> Tensor:
    """Exact frame set of an UNCENTERED framing of the unpadded signal:
    frame i exists iff i*hop + frame_length <= valid_len; frame 0 always
    (degenerate short rows)."""
    valid_len = mask.sum(-1, keepdim=True)
    ends = (torch.arange(num_frames, dtype=mask.dtype, device=mask.device)[None, :] * hop
            + frame_length)
    out = (ends <= valid_len).to(mask.dtype)
    out[..., 0].fill_(1.0)  # a setitem of a Python float would trace a tensor constant
    return out


def framed_rfft(frames: Tensor) -> tuple[Tensor, Tensor]:
    """(re, im) of rfft over the last axis. frames: [..., n] f32."""
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real, spec.imag


def framed_irfft(re: Tensor, im: Tensor, n: int) -> Tensor:
    """Inverse of framed_rfft: [..., n//2+1] (re, im) -> [..., n]."""
    return torch.fft.irfft(torch.complex(re, im), n=n, dim=-1)


def frame_magnitude(frames: Tensor, win: Tensor) -> Tensor:
    """|rfft(frames * win)| over the last axis."""
    re, im = framed_rfft(frames * win)
    return torch.sqrt(re * re + im * im)


def stft_mag(wave: Tensor, *, n_fft: int = 2048, hop: int = 512,
             center: bool = True) -> Tensor:
    """Magnitude STFT, librosa semantics (hann window, reflect-pad center).
    [B, T] -> [B, F, n_fft//2 + 1]."""
    if center:
        wave = reflect_pad(wave, n_fft // 2)
    return frame_magnitude(frame_signal(wave, n_fft, hop), hann_window(n_fft, wave.device))


def stft_frame_mask(mask: Tensor, *, n_fft: int = 2048, hop: int = 512,
                    center: bool = True) -> Tensor:
    """Exact frame validity aligned with stft_mag's framing."""
    T = mask.shape[-1]
    if center:
        num_frames = max(1 + (T + 2 * (n_fft // 2) - n_fft) // hop, 1)
        return center_frame_mask(mask, hop, num_frames)
    num_frames = max(1 + (T - n_fft) // hop, 1)
    return full_frame_mask(mask, n_fft, hop, num_frames)


def rms_frames(wave: Tensor, *, frame_length: int, hop: int) -> Tensor:
    """Per-frame RMS energy (librosa.feature.rms semantics, center=True,
    zero padding). [B, T] -> [B, F].

    Each frame's sum of squares is summed directly over a strided view of
    the squared signal, so a quiet frame late in a long clip keeps its
    (near-)zero energy: no long running sum is differenced (the JAX
    module's chunk-local prefix sums serve the same end)."""
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
    """Per-row quantile over valid entries (linear interpolation, matching
    np.percentile). x, mask: [B, N] -> [B]."""
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
    vhi = torch.where(hi.to(pos.dtype) <= pos, vlo, vhi)   # rows with one entry
    return vlo + frac * (vhi - vlo)


def median_smooth_bool(x: Tensor, size: int = 5) -> Tensor:
    """Median filter over a boolean [B, F] sequence == windowed majority
    vote, with the ends padded by their edge values (the JAX module pads
    with "edge", whatever its docstring says)."""
    pad = size // 2
    xp = F.pad(x.float()[:, None], (pad, pad), mode="replicate")[:, 0]
    return xp.unfold(-1, size, 1).sum(-1) > (size / 2.0)


@export_safe_cache(maxsize=16)
def _welch_scale(nperseg: int, sample_rate: int, device: torch.device) -> Tensor:
    """Density scaling 1 / (fs * sum(win^2)), a 0-d f32 tensor on the
    device (a Python float would cost a device read)."""
    win = hann_window(nperseg, device).double()
    return (1.0 / (sample_rate * win.square().sum())).float()


def welch_psd(wave: Tensor, mask: Tensor, *, sample_rate: int,
              nperseg: int = 2048) -> tuple[Tensor, Tensor]:
    """Batched masked Welch PSD (scipy.signal.welch semantics: hann window,
    50% overlap, constant detrend, density scaling).

    Returns (freqs [n_bins], psd [B, n_bins]). freqs is float64, as the
    JAX module's numpy grid is: its band edges and nearest-bin lookups are
    taken in float64, and a caller casts it before mixing it with data."""
    T = wave.shape[-1]
    nperseg = min(nperseg, T)
    hop = nperseg // 2
    frames = frame_signal(wave, nperseg, hop)                     # [B, F, n]
    fmask = full_frame_mask(mask, nperseg, hop, frames.shape[-2])
    frames = frames - frames.mean(-1, keepdim=True)               # detrend
    re, im = framed_rfft(frames * hann_window(nperseg, wave.device))
    spec = (re * re + im * im) * _welch_scale(nperseg, sample_rate, wave.device)
    spec[..., 1:-1] *= 2.0
    psd = masked_mean(spec, fmask[..., None], dim=-2)             # average segments
    return rfftfreq(nperseg, sample_rate, wave.device, torch.float64), psd


def spectral_descriptors(wave: Tensor, mask: Tensor, *, sample_rate: int = 16000,
                         n_fft: int = 2048, hop: int = 512, S: Tensor | None = None):
    """Masked means of librosa-style spectral centroid / rolloff (85%) /
    bandwidth over valid frames. [B, T] -> three [B] tensors. `S` lets the
    caller pass a precomputed centered stft_mag."""
    if S is None:
        S = stft_mag(wave, n_fft=n_fft, hop=hop)                  # [B, F, bins]
    fmask = stft_frame_mask(mask, n_fft=n_fft, hop=hop)           # [B, F]
    freqs = rfftfreq(n_fft, sample_rate, S.device).to(S.dtype)
    norm = S.sum(-1) + 1e-10
    centroid = (S * freqs).sum(-1) / norm                         # [B, F]
    # rolloff: the smallest frequency whose cumulative energy reaches 85 %;
    # argmax takes the first maximum (bool argmax is not on CUDA: cast)
    cum = torch.cumsum(S, dim=-1)
    roll_idx = (cum >= 0.85 * cum[..., -1:]).to(torch.uint8).argmax(-1)
    rolloff = freqs[roll_idx]
    bandwidth = torch.sqrt(((freqs - centroid[..., None]) ** 2 * S).sum(-1) / norm)
    return (masked_mean(centroid, fmask), masked_mean(rolloff, fmask),
            masked_mean(bandwidth, fmask))

"""Batched audio DSP on the device: resampling, speed perturbation, noise
at a target SNR, the eval-time 5-view TTA expansion and the train-time
augmentation.

Counterpart of the JAX package's ops/audio_dsp.py. The JAX package leaves
these to XLA; here they are plain PyTorch, no kernel of their own.

  * `sinc_resample` — torchaudio's resample algorithm (windowed sinc, hann
    window, lowpass_filter_width=6, rolloff=0.99): the [new, K] polyphase
    kernel is built in numpy f64, cast to f32 and cached per (orig, new,
    device), then applied as a strided window view of the padded wave times
    the kernel, one f32 matmul. Not a cuDNN convolution: under torch's
    default `cudnn.allow_tf32` that would run in TF32.
  * `speed_perturb` — the reference's double resample sr -> sr*f -> sr.
  * `add_noise_snr` — Gaussian noise at a target SNR over valid samples,
    clamped to [-1, 1]. The draw comes from an explicit torch.Generator or
    is passed in (`noise`), so tests can feed JAX's own draws.
  * `tta_expand` — [orig, speed .95, speed 1.05, noise 15 dB, noise 20 dB]
    [:V], stacked view-major as one [V*B, T] batch.
  * `augment_batch` — the reference's online augmentation (train.py:
    130-143): speed perturbation with probability 0.5, then noise at
    U[10, 20) dB SNR with probability 0.5, per row.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.runtime import export_safe_cache

Tensor = torch.Tensor


@export_safe_cache(maxsize=64)
def _resample_kernel(orig_freq: int, new_freq: int,
                     lowpass_filter_width: int = 6,
                     rolloff: float = 0.99) -> Tuple[np.ndarray, int]:
    """torchaudio's _get_sinc_resample_kernel (sinc_interp_hann): (kernel
    [new_freq, 2 * width + orig_freq] f32, width). orig/new must already be
    reduced by their gcd."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = (-np.arange(new_freq, dtype=np.float64)[:, None] / new_freq) + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    scale = base_freq / orig_freq
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * scale
    return kernel.astype(np.float32), width


@export_safe_cache(maxsize=64)
def _kernel_on(orig: int, new: int, device: torch.device) -> Tensor:
    """The [K, new] kernel, transposed for the matmul, once per device."""
    kernel, _ = _resample_kernel(orig, new)
    return torch.from_numpy(np.ascontiguousarray(kernel.T)).to(device)


def resampled_length(length: int, orig_freq: int, new_freq: int) -> int:
    g = math.gcd(orig_freq, new_freq)
    return int(math.ceil(new_freq // g * length / (orig_freq // g)))


def sinc_resample(wave: Tensor, orig_freq: int, new_freq: int) -> Tensor:
    """wave [B, T] -> [B, ceil(T * new / orig)] (torchaudio semantics)."""
    if orig_freq == new_freq:
        return wave
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    _, width = _resample_kernel(orig, new)
    kernel = _kernel_on(orig, new, wave.device)             # [K, new]
    B, T = wave.shape
    target_len = int(math.ceil(new * T / orig))
    x = torch.nn.functional.pad(wave.float(), (width, width + orig))
    frames = x.unfold(-1, kernel.shape[0], orig)            # [B, F, K], a view
    y = torch.matmul(frames, kernel)                        # [B, F, new]
    return y.reshape(B, -1)[:, :target_len].to(wave.dtype)


def speed_perturb(wave: Tensor, factor: float, sample_rate: int = 16000) -> Tensor:
    """Double resample sr -> sr*f -> sr, padded or trimmed back to the
    input length T. `factor` is static."""
    if abs(factor - 1.0) < 1e-3:
        return wave
    T = wave.shape[-1]
    mid = sinc_resample(wave, sample_rate, int(sample_rate * factor))
    out = sinc_resample(mid, int(sample_rate * factor), sample_rate)
    L = out.shape[-1]
    if L >= T:
        return out[..., :T]
    return torch.nn.functional.pad(out, (0, T - L))


def speed_perturb_length(length: Tensor, factor: float,
                         sample_rate: int = 16000) -> Tensor:
    """Valid-sample count after speed_perturb, for the rebuilt mask. As the
    JAX package computes it in 32-bit mode: integer products, then an f32
    division and ceil, twice."""
    new_sr = int(sample_rate * factor)
    g1 = math.gcd(sample_rate, new_sr)
    mid = torch.ceil((length.to(torch.int32) * (new_sr // g1)).float() / (sample_rate // g1))
    g2 = math.gcd(new_sr, sample_rate)
    out = torch.ceil(mid * (sample_rate // g2) / (new_sr // g2))
    return out.to(torch.int32)


def add_noise_snr(wave: Tensor, mask: Tensor, snr_db, *,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Tensor] = None) -> Tensor:
    """Gaussian noise at a target SNR over the valid samples, clamped to
    [-1, 1] (the reference's preprocess.py:65-73). snr_db: a Python number,
    or a tensor, scalar or per-row [B]. `noise` is the standard-normal draw
    [B, T]; without it one is drawn from `generator`. A number stays on the
    host: made into a tensor on the card, it would be a copy that waits."""
    m = mask.float()
    w = wave.float()
    n = m.sum(-1, keepdim=True).clamp(min=1.0)
    signal_power = ((w * w * m).sum(-1, keepdim=True) / n).clamp(min=1e-12)
    if isinstance(snr_db, torch.Tensor):
        snr = snr_db.to(wave.device, torch.float32)
        if snr.ndim == 1:
            snr = snr[:, None]
        noise_power = signal_power / torch.pow(10.0, snr / 10.0)
    else:
        noise_power = signal_power / float(np.float32(10.0) ** (np.float32(snr_db) / 10))
    if noise is None:
        noise = torch.randn(w.shape, generator=generator, device=w.device)
    out = (w + noise.float() * torch.sqrt(noise_power)).clamp(-1.0, 1.0) * m
    return out.to(wave.dtype)


def tta_expand(wave: Tensor, mask: Tensor, *, num_tta: int = 5,
               sample_rate: int = 16000,
               speed_factors: Tuple[float, float] = (0.95, 1.05),
               generator: Optional[torch.Generator] = None,
               noise: Optional[Sequence[Tensor]] = None) -> Tuple[Tensor, Tensor]:
    """Eval-time TTA (the reference's eval.py:23-41): [orig, speed .95,
    speed 1.05, noise 15 dB, noise 20 dB][:num_tta], stacked as [V*B, T]
    with their masks, view-major, so logits reshape to [V, B, C].mean(0).
    `noise`, where given, holds the two noise views' standard-normal draws
    [B, T] (15 dB, then 20 dB); otherwise they come from `generator`, in
    that order. Only the views asked for are computed."""
    T = wave.shape[1]
    views = [(wave, mask)]
    if num_tta > 1:
        lengths = mask.to(torch.int32).sum(-1, dtype=torch.int32)
        positions = torch.arange(T, device=wave.device)[None, :]
        for f in speed_factors[:num_tta - 1]:
            w = speed_perturb(wave, f, sample_rate)
            length = speed_perturb_length(lengths, f, sample_rate).clamp(max=T)
            m = (positions < length[:, None]).to(mask.dtype)
            views.append((w * m, m))
    for i, snr in enumerate((15.0, 20.0)[:max(num_tta - 3, 0)]):
        draw = noise[i] if noise is not None else None
        views.append((add_noise_snr(wave, mask, snr, generator=generator, noise=draw), mask))
    return (torch.cat([v[0] for v in views], dim=0),
            torch.cat([v[1] for v in views], dim=0))


SPEED_FACTORS = (0.9, 0.95, 1.0, 1.05, 1.1)


class AugmentDraws(NamedTuple):
    """The random draws of one `augment_batch` call, in the JAX package's
    order (`jax.random.split(key, 5)`: k_sp, k_spf, k_np, k_snr, k_noise)."""
    speed: Tensor            # [B] bool: speed-perturb this row
    factor: object           # int (one factor for the batch) or [B] ints
    noise: Tensor            # [B] bool: add noise to this row
    snr_db: Tensor           # [B] f32 in [snr_range)
    normal: Tensor           # [B, T] f32 standard normal


def draw_augmentation(B: int, T: int, *, generator: torch.Generator,
                      host_generator: Optional[torch.Generator] = None,
                      speed_per_batch: bool = False, num_factors: int = len(SPEED_FACTORS),
                      speed_prob: float = 0.5, noise_prob: float = 0.5,
                      snr_range: Tuple[float, float] = (10.0, 20.0)) -> AugmentDraws:
    """Draws for `augment_batch` on `generator`'s device. With
    speed_per_batch the factor index comes from `host_generator`, a CPU
    generator, as a Python int: the step picks its resampler on the host
    without reading a value back from the card."""
    dev = generator.device
    rand = lambda *shape: torch.rand(shape, generator=generator, device=dev)
    if speed_per_batch:
        if host_generator is None:
            raise ValueError("augment_batch: speed_per_batch draws its factor "
                             "from a CPU host_generator")
        factor = int(torch.randint(num_factors, (), generator=host_generator))
    else:
        factor = torch.randint(num_factors, (B,), generator=generator, device=dev)
    return AugmentDraws(
        speed=rand(B) < speed_prob, factor=factor, noise=rand(B) < noise_prob,
        snr_db=snr_range[0] + (snr_range[1] - snr_range[0]) * rand(B),
        normal=torch.randn((B, T), generator=generator, device=dev))


def augment_batch(wave: Tensor, mask: Tensor, *,
                  generator: Optional[torch.Generator] = None,
                  host_generator: Optional[torch.Generator] = None,
                  draws: Optional[AugmentDraws] = None,
                  speed_factors: Sequence[float] = SPEED_FACTORS,
                  speed_prob: float = 0.5, noise_prob: float = 0.5,
                  snr_range: Tuple[float, float] = (10.0, 20.0),
                  sample_rate: int = 16000,
                  speed_per_batch: bool = False) -> Tuple[Tensor, Tensor]:
    """Train-time augmentation of [B, T] rows: returns (wave, mask). A row
    is speed-perturbed with probability speed_prob by a factor from
    `speed_factors` (the reference draws U[0.9, 1.1]; a fixed set keeps
    the resamplers few), its mask rebuilt from the new length; then noised
    with probability noise_prob at an SNR drawn from snr_range.

    Per sample, every factor's branch is computed and each row gathers its
    own; with speed_per_batch one factor serves the batch and only its
    branch runs. `draws` (e.g. JAX's own, for a test) replaces the draws
    from `generator` / `host_generator` (see `draw_augmentation`)."""
    B, T = wave.shape
    if draws is None:
        if generator is None:
            raise ValueError("augment_batch needs a generator or draws")
        draws = draw_augmentation(B, T, generator=generator, host_generator=host_generator,
                                  speed_per_batch=speed_per_batch,
                                  num_factors=len(speed_factors), speed_prob=speed_prob,
                                  noise_prob=noise_prob, snr_range=snr_range)
    lengths = mask.to(torch.int32).sum(-1, dtype=torch.int32)
    if isinstance(draws.factor, int):
        f = speed_factors[draws.factor]
        picked = speed_perturb(wave, f, sample_rate)
        picked_len = speed_perturb_length(lengths, f, sample_rate)
    else:
        stacked = torch.stack([speed_perturb(wave, f, sample_rate) for f in speed_factors])
        stacked_len = torch.stack([speed_perturb_length(lengths, f, sample_rate)
                                   for f in speed_factors])
        idx = draws.factor.to(wave.device, torch.int64)
        picked = stacked.gather(0, idx[None, :, None].expand(1, B, T))[0]
        picked_len = stacked_len.gather(0, idx[None, :])[0]
    speed = draws.speed.to(wave.device)
    wave2 = torch.where(speed[:, None], picked, wave)
    len2 = torch.where(speed, picked_len.clamp(max=T), lengths)
    mask2 = (torch.arange(T, device=wave.device)[None, :] < len2[:, None]).to(mask.dtype)
    noised = add_noise_snr(wave2, mask2, draws.snr_db.to(wave.device),
                           noise=draws.normal.to(wave.device))
    wave3 = torch.where(draws.noise.to(wave.device)[:, None], noised, wave2)
    return wave3 * mask2, mask2

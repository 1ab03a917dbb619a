"""Robustness evaluation: controlled noise injection at target SNR
(gaussian / synthetic babble / synthetic music), Hindi/Bengali code-mixing,
OOD-trigger rates, degradation-vs-baseline reporting.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
eval/robustness.py, with the reference's robustness_evaluation.py
semantics:
  * noise generators (:54-96): gaussian white; babble = 100..500 Hz sine
    mix; music = C-major chord (261.63/329.63/392.00 Hz); all scaled to the
    target SNR against the clean-signal power
  * code-mixing by dictionary word substitution at ratios 0..1 (:98-147)
  * default SNR sweep {20, 15, 10, 5, 0, −5} dB (:149)
  * OOD trigger = fraction with max prob < 0.5 (:200-210 semantics)
  * degradation = (baseline − value) / baseline

Noise injection runs batched on the wave's device. Gaussian noise draws
from an explicit torch.Generator there (or takes a passed-in
standard-normal draw); the sweep seeds one generator from `seed` and draws
per batch in order, so a run repeats on one device (the draws are not
JAX's). The evaluation plumbing is host-side numpy like the rest of eval/.
"""

from __future__ import annotations

import math
import random
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..utils import metrics as M

Tensor = torch.Tensor

SNR_LEVELS_DEFAULT = (20.0, 15.0, 10.0, 5.0, 0.0, -5.0)
BABBLE_FREQS = (100.0, 200.0, 300.0, 400.0, 500.0)
CHORD_FREQS = (261.63, 329.63, 392.00)  # C major

HINDI_EQUIVALENTS = {
    'the': 'yeh', 'is': 'hai', 'and': 'aur', 'in': 'mein', 'to': 'ko',
    'of': 'ka', 'a': 'ek', 'that': 'woh', 'it': 'yeh', 'with': 'ke saath',
    'for': 'ke liye', 'on': 'par', 'at': 'par', 'by': 'se', 'from': 'se',
    'up': 'upar', 'down': 'neeche', 'good': 'accha', 'bad': 'bura',
    'big': 'bada', 'small': 'chota',
}
BENGALI_EQUIVALENTS = {
    'the': 'ei', 'is': 'hoy', 'and': 'ebong', 'in': 'modhye', 'to': 'ke',
    'of': 'er', 'a': 'ekta', 'that': 'oi', 'it': 'eta', 'with': 'shathe',
    'for': 'jonno', 'on': 'upor', 'good': 'bhalo', 'bad': 'kharap',
    'big': 'boro', 'small': 'choto',
}


def add_noise_at_snr(wave: Tensor, mask: Tensor, snr_db, *,
                     noise_type: str = "gaussian", sample_rate: int = 16000,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Tensor] = None) -> Tensor:
    """Batched noise injection at target SNR (robustness_evaluation.py:54-96),
    in the wave's dtype on its device. Signal power is measured over valid
    samples; noise is masked. snr_db: a number or a tensor (scalar or [B]).
    Gaussian noise is `noise` (a standard-normal draw shaped like the wave)
    where given, else drawn from `generator`."""
    B, T = wave.shape
    mask = mask.to(wave.dtype)
    signal_power = (wave ** 2 * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)
    snr = torch.as_tensor(snr_db, dtype=wave.dtype, device=wave.device)
    noise_power = signal_power / (10.0 ** (snr / 10.0))

    if noise_type == "gaussian":
        if noise is None:
            noise = torch.randn(wave.shape, generator=generator, device=wave.device,
                                dtype=wave.dtype)
        noise = noise.to(wave.dtype) * torch.sqrt(noise_power)[:, None]
    else:
        freqs = BABBLE_FREQS if noise_type == "babble" else CHORD_FREQS
        amp = 0.1 if noise_type == "babble" else 0.05
        # each sine's phase is n * (2 pi f * 1 / sample_rate), the two
        # factors rounded to the wave's dtype first: the product the JAX
        # function's compiled program takes for 2 pi f * (arange(T) /
        # sample_rate) (XLA folds the constants), so the phases agree
        n = torch.arange(T, dtype=wave.dtype, device=wave.device)
        inv_rate = torch.tensor(1.0 / sample_rate, dtype=wave.dtype)
        base = sum(amp * torch.sin(n * (torch.tensor(2 * math.pi * f, dtype=wave.dtype)
                                         * inv_rate).item())
                   for f in freqs)
        base = base.expand(B, T)
        base_power = (base ** 2 * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)
        noise = base * torch.sqrt(noise_power / base_power.clamp(min=1e-20))[:, None]
    return wave + noise * mask


def code_mix_text(text: str, mixing_ratio: float, *,
                  target_language: str = "hi",
                  rng: Optional[random.Random] = None) -> str:
    """Dictionary word substitution (robustness_evaluation.py:98-147)."""
    if mixing_ratio <= 0.0:
        return text
    table = HINDI_EQUIVALENTS if target_language == "hi" else BENGALI_EQUIVALENTS
    rng = rng or random
    words = text.split()
    n_replace = int(len(words) * mixing_ratio)
    if n_replace == 0:
        return text
    idxs = rng.sample(range(len(words)), n_replace)
    mixed = list(words)
    for i in idxs:
        w = words[i].lower()
        if w in table:
            mixed[i] = table[w]
    return " ".join(mixed)


def ood_trigger_rate(probs: np.ndarray, threshold: float = 0.5) -> float:
    """Fraction of samples whose max probability falls below threshold."""
    if len(probs) == 0:
        return 0.0
    return float((np.max(probs, axis=1) < threshold).mean())


def _degradation(baseline: float, value: float) -> float:
    return (baseline - value) / baseline if baseline > 0 else 0.0


def evaluate_noise_robustness(
        predict_fn: Callable[[Dict, torch.Generator, float, str], Dict],
        batches: Sequence[Dict], *,
        snr_levels: Sequence[float] = SNR_LEVELS_DEFAULT,
        noise_types: Sequence[str] = ("gaussian", "babble", "music"),
        baseline_f1: Optional[float] = None,
        seed: int = 0,
        device: Union[str, torch.device] = "cpu") -> Dict:
    """Noise-robustness sweep. `predict_fn(batch, generator, snr_db,
    noise_type)` must return {"preds": [...], "probs": [...], "labels":
    [...]} for the corrupted batch (the caller owns the model forward so
    this module stays model-agnostic); `generator` is one torch.Generator
    on `device`, seeded from `seed` once, whose draws the batches take in
    order."""
    generator = torch.Generator(device=device).manual_seed(seed)
    results = {}
    for noise_type in noise_types:
        per_snr = {}
        for snr in snr_levels:
            preds, labels, probs = [], [], []
            for batch in batches:
                out = predict_fn(batch, generator, float(snr), noise_type)
                preds.append(np.asarray(out["preds"]))
                labels.append(np.asarray(out["labels"]))
                probs.append(np.asarray(out["probs"]))
            preds = np.concatenate(preds) if preds else np.zeros(0, np.int64)
            labels = np.concatenate(labels) if labels else np.zeros(0, np.int64)
            probs = np.concatenate(probs) if probs else np.zeros((0, 1))
            f1 = M.weighted_f1(preds, labels)
            entry = {
                "weighted_f1": f1,
                "accuracy": M.accuracy(preds, labels),
                "uar": M.unweighted_average_recall(preds, labels),
                "ood_trigger_rate": ood_trigger_rate(probs),
            }
            if baseline_f1 is not None:
                entry["f1_degradation"] = _degradation(baseline_f1, f1)
            per_snr[f"{snr:g}dB"] = entry
        results[noise_type] = per_snr
    return results


def evaluate_code_mixing(
        predict_fn: Callable[[List[str]], Dict],
        texts: List[str], labels: np.ndarray, *,
        ratios: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 1.0),
        target_language: str = "hi",
        baseline_f1: Optional[float] = None,
        seed: int = 0) -> Dict:
    """Code-mixing sweep. `predict_fn(texts)` returns {"preds", "probs"}."""
    rng = random.Random(seed)
    labels = np.asarray(labels)
    results = {}
    for ratio in ratios:
        mixed = [code_mix_text(t, ratio, target_language=target_language,
                               rng=rng) for t in texts]
        out = predict_fn(mixed)
        preds = np.asarray(out["preds"])
        probs = np.asarray(out["probs"])
        f1 = M.weighted_f1(preds, labels)
        entry = {
            "weighted_f1": f1,
            "accuracy": M.accuracy(preds, labels),
            "ood_trigger_rate": ood_trigger_rate(probs),
        }
        if baseline_f1 is not None:
            entry["f1_degradation"] = _degradation(baseline_f1, f1)
        results[f"ratio_{ratio:g}"] = entry
    return results


def robustness_report(noise_results: Dict,
                      code_mix_results: Optional[Dict] = None) -> str:
    lines = ["Robustness Evaluation", "====================="]
    for noise_type, per_snr in noise_results.items():
        lines.append(f"\n{noise_type} noise:")
        for snr, m in per_snr.items():
            deg = f" (degradation {m['f1_degradation']:.1%})" \
                if "f1_degradation" in m else ""
            lines.append(f"  {snr:>6}: F1 {m['weighted_f1']:.4f} "
                         f"acc {m['accuracy']:.4f} "
                         f"OOD {m['ood_trigger_rate']:.2%}{deg}")
    if code_mix_results:
        lines.append("\ncode-mixing:")
        for ratio, m in code_mix_results.items():
            lines.append(f"  {ratio:>10}: F1 {m['weighted_f1']:.4f} "
                         f"OOD {m['ood_trigger_rate']:.2%}")
    return "\n".join(lines)

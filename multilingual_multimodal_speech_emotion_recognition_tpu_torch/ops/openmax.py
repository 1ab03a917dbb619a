"""OpenMax open-set adjustment (Weibull CDF over class distances).

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
ops/openmax.py, with its energy score and the Weibull fit that training
runs on validation features. Weibull state: {"alpha": [C], "beta": [C],
"tau": [C], "activation_vectors": [C, D]}.
"""

from __future__ import annotations

import math

import torch

from ..models.layers import Init

Tensor = torch.Tensor


def init_weibull(init: Init, num_classes: int, feature_dim: int) -> dict:
    return {"alpha": init.ones((num_classes,)), "beta": init.ones((num_classes,)),
            "tau": init.zeros((num_classes,)),
            "activation_vectors": init.zeros((num_classes, feature_dim))}


def weibull_unknown_prob(weibull: dict, features: Tensor) -> Tensor:
    """Max over classes of the Weibull CDF of the distance to each class's
    mean activation vector. features: [B, D] -> [B]."""
    diff = features[:, None, :] - weibull["activation_vectors"][None, :, :]
    dist = torch.linalg.vector_norm(diff, dim=-1)
    safe_beta = weibull["beta"].clamp(min=1e-6)[None, :]
    safe_x = (dist - weibull["tau"][None, :]).clamp(min=0.0)
    cdf = 1.0 - torch.exp(-torch.pow(safe_x / safe_beta, weibull["alpha"][None, :]))
    return cdf.max(dim=-1).values


def openmax_adjust(weibull: dict, features: Tensor, logits: Tensor, *,
                   threshold: float = 0.3, reduction_scale: float = 0.8) -> Tensor:
    """Scale logits by 1 - reduction_scale * unknown_prob where that
    probability exceeds the threshold."""
    unknown = weibull_unknown_prob(weibull, features)
    scale = torch.where(unknown > threshold, 1.0 - reduction_scale * unknown,
                        torch.ones_like(unknown))
    return logits * scale[:, None].to(logits.dtype)


def fit_weibull(features: Tensor, labels: Tensor, num_classes: int, *,
                alpha: float = 2.5, beta_scale: float = 1.5,
                tau_scale: float = 0.8) -> dict:
    """Per-class Weibull parameters from penultimate features [N, D] and
    labels [N], computed on their device (the reference's fit_weibull,
    classifier.py:277-305): each class's mean activation vector; alpha
    fixed; beta = beta_scale * the population std (ddof 0) of the members'
    distances to it; tau = tau_scale * their minimum. A class with no
    sample keeps alpha 1, beta 1, tau 0 and a zero vector."""
    features = features.float()
    onehot = (labels.long()[:, None]
              == torch.arange(num_classes, device=labels.device)).float()   # [N, C]
    counts = onehot.sum(0)
    safe_counts = counts.clamp(min=1.0)
    means = (onehot.T @ features) / safe_counts[:, None]                   # [C, D]
    dists = torch.linalg.vector_norm(features[:, None, :] - means[None, :, :], dim=-1)
    mean_d = (dists * onehot).sum(0) / safe_counts
    var_d = ((dists - mean_d[None, :]).square() * onehot).sum(0) / safe_counts
    min_d = torch.where(onehot > 0, dists, math.inf).amin(0)
    min_d = torch.where(torch.isfinite(min_d), min_d, 0.0)
    present = counts > 0
    return {"alpha": torch.where(present, alpha, 1.0),
            "beta": torch.where(present, beta_scale * torch.sqrt(var_d), 1.0),
            "tau": torch.where(present, tau_scale * min_d, 0.0),
            "activation_vectors": torch.where(present[:, None], means, 0.0)}


def energy_score(logits: Tensor) -> Tensor:
    """-logsumexp(logits) OOD score in f32 (the reference's src/utils.py:12-14)."""
    return -torch.logsumexp(logits.float(), dim=-1)

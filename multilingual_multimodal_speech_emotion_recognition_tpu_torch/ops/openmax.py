"""OpenMax open-set adjustment (Weibull CDF over class distances).

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
ops/openmax.py, with its energy score; `fit_weibull` waits for the
training slice. Weibull state: {"alpha": [C], "beta": [C], "tau": [C],
"activation_vectors": [C, D]}.
"""

from __future__ import annotations

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


def energy_score(logits: Tensor) -> Tensor:
    """-logsumexp(logits) OOD score in f32 (the reference's src/utils.py:12-14)."""
    return -torch.logsumexp(logits.float(), dim=-1)

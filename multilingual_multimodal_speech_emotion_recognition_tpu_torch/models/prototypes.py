"""Prototype memory's pull/push loss.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
models/prototypes.py:prototype_loss. The [C, D] prototypes are
`params["prototypes"]["prototypes"]` (models/model.py:init_model draws them
0.02 * N(0, 1)). loss = mean L2 distance to the own prototype + margin -
mean soft minimum (-logsumexp(-d)) of the distances to the other
prototypes, with the reference's clamps (embeddings to [-10, 10], those
distances capped at 10) and a non-finite loss taken as 0.
"""

from __future__ import annotations

import math

import torch

from ..ops.losses import one_hot

Tensor = torch.Tensor


def prototype_loss(params: dict, embeddings: Tensor, labels: Tensor, *,
                   margin: float = 0.5) -> Tensor:
    protos = params["prototypes"].float()
    emb = embeddings.float().clamp(-10.0, 10.0)
    C = protos.shape[0]
    own_proto = protos[labels.long().clamp(0, C - 1)]
    pos = torch.linalg.vector_norm(emb - own_proto, dim=1).mean()
    sq = (emb[:, None, :] - protos[None, :, :]).square().sum(2)       # [B, C]
    dists = torch.sqrt(sq + 1e-6)
    neg_dists = torch.where(one_hot(labels, C) > 0, math.inf, dists).clamp(max=10.0)
    neg = (-torch.logsumexp(-neg_dists, dim=1)).mean()
    loss = pos + margin - neg
    return torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss))

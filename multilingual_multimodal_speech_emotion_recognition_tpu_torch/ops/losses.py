"""Training losses, in f32 whatever the activation dtype.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
ops/losses.py, with its clamps and guards:
  * label_smoothing_cross_entropy: smoothing 0.1, logits clamped to
    [-10, 10], log-probabilities' -inf to -1e9, the per-row loss's
    non-finite values to 0 / 1e6, a non-finite mean to 0.
  * class_balanced_focal_loss: per-batch class counts -> effective-number
    weights 1 - beta^c in the accurate -expm1(c * log(beta)) form, no
    gradient through the weights, focal factor (1 - p_t)^gamma.
  * supcon_loss: supervised contrastive loss at temperature 0.07 (off in
    the reference's trainer; the train step adds it at supcon_weight > 0).
  * uncertainty_regularizer: mean(uncertainty * 1[pred == target]).

One-hot rows are comparisons with the class index, so a target outside
[0, C) gives a zero row, as jax.nn.one_hot does; a row's max takes
torch.amax, which shares the gradient among ties as JAX's max does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def one_hot(targets: Tensor, num_classes: int) -> Tensor:
    """[N] ints -> [N, C] f32; all zeros where the target is out of range."""
    classes = torch.arange(num_classes, device=targets.device)
    return (targets.long()[:, None] == classes).float()


def _finite_or_zero(x: Tensor) -> Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def label_smoothing_cross_entropy(logits: Tensor, targets: Tensor, *,
                                  smoothing: float = 0.1) -> Tensor:
    logits = logits.float()
    C = logits.shape[-1]
    targets = targets.long().clamp(0, max(0, C - 1))
    log_probs = F.log_softmax(logits.clamp(-10.0, 10.0), dim=-1)
    log_probs = torch.nan_to_num(log_probs, neginf=-1e9)
    true_dist = torch.where(one_hot(targets, C) > 0, 1.0 - smoothing, smoothing / (C - 1))
    loss = (-true_dist * log_probs).sum(-1)
    loss = torch.nan_to_num(loss, nan=0.0, posinf=1e6, neginf=1e6)
    return _finite_or_zero(loss.mean())


def class_balanced_focal_loss(logits: Tensor, targets: Tensor, *, num_classes: int,
                              beta: float = 0.9999, gamma: float = 2.0) -> Tensor:
    logits = logits.float()
    onehot = one_hot(targets, num_classes)
    counts = onehot.sum(0).clamp(min=1.0)
    # log(beta) in f32, as JAX takes it; a Python number, so that no tensor
    # is copied to the card for it
    log_beta = float(np.log(np.float32(beta)))
    effective_num = (-torch.expm1(counts * log_beta)).clamp(min=1e-6)
    weights = (1.0 - beta) / effective_num
    weights = (weights / (weights.sum() + 1e-8) * num_classes).detach()
    log_probs = F.log_softmax(logits.clamp(-10.0, 10.0), dim=-1)
    pt = (log_probs.exp() * onehot).sum(-1).clamp(1e-6, 1.0)
    focal_weight = torch.pow(1.0 - pt, gamma)
    # torch's F.cross_entropy(weight=w, reduction='none') scales a row's
    # NLL by w[target]; an index outside [0, C) reads the nearest class, as
    # JAX's gather clamps
    ce = -(log_probs * onehot).sum(-1) * weights[targets.long().clamp(0, num_classes - 1)]
    return _finite_or_zero((focal_weight * ce).mean())


def supcon_loss(features: Tensor, labels: Tensor, *, temperature: float = 0.07) -> Tensor:
    f = features.float()
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp(min=1e-12)
    logits = (f @ f.T) / temperature
    logits = logits - logits.amax(dim=1, keepdim=True)
    same = (labels[:, None] == labels[None, :]).float()
    not_self = 1.0 - torch.eye(f.shape[0], dtype=torch.float32, device=f.device)
    mask = same * not_self
    exp_logits = logits.exp() * not_self
    log_prob = logits - torch.log(exp_logits.sum(1, keepdim=True) + 1e-12)
    mean_log_prob_pos = (mask * log_prob).sum(1) / (mask.sum(1) + 1e-12)
    return -mean_log_prob_pos.mean()


def uncertainty_regularizer(uncertainty: Tensor, logits: Tensor, targets: Tensor) -> Tensor:
    """mean(uncertainty * 1[pred == target]): low uncertainty on correct
    predictions (the reference's train.py:163-165)."""
    correct = (logits.argmax(-1) == targets).float()
    return (uncertainty.float().squeeze(-1) * correct).mean()

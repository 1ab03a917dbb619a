"""Loss integration: the three-phase weight schedule, the energy-margin,
temporal-consistency and confidence-calibration losses, and the batch
composition check, in plain PyTorch.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
research/loss_integration.py:
  * phases: representation learning from epoch 0, adversarial from 50,
    calibration from 100; LossWeights (CE 1.0, SupCon 0.25, proto 0.3,
    language-adversarial -0.1, energy margin 0.15, temporal 0.2,
    calibration 0.1) with the phase's terms switched off
  * energy margin: mean relu(E) in domain + mean relu(margin - E) out of
    domain, margin 10, as masked means (fixed shapes)
  * temporal consistency: KL(current || previous) only where min(conf_cur,
    conf_prev) < 0.8
  * confidence calibration: sum over 10 bins of (mean conf - mean acc)^2,
    over the bin count
  * the warn-only batch checks (host numpy): batch >= 32, OOD ratio >= 0.2,
    >= 2 languages, >= 2 emotion classes
  * the phase-weighted total over whichever components are given
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

Tensor = torch.Tensor

PHASES = ("representation_learning", "adversarial_training", "calibration")
PHASE_EPOCHS = {"representation_learning": 0, "adversarial_training": 50,
                "calibration": 100}


@dataclasses.dataclass(frozen=True)
class LossWeights:
    ce_loss: float = 1.0
    supcon_loss: float = 0.25
    prototype_loss: float = 0.3
    language_adversarial_loss: float = -0.1
    energy_margin_loss: float = 0.15
    temporal_consistency_loss: float = 0.2
    confidence_calibration_loss: float = 0.1

    def phase_weights(self, phase: str) -> Dict[str, float]:
        base = dataclasses.asdict(self)
        if phase == "representation_learning":
            off = ("language_adversarial_loss", "energy_margin_loss",
                   "temporal_consistency_loss", "confidence_calibration_loss")
        elif phase == "adversarial_training":
            off = ("temporal_consistency_loss", "confidence_calibration_loss")
        elif phase == "calibration":
            off = ()
        else:
            raise ValueError(f"unknown phase {phase!r}")
        return {k: (0.0 if k in off else v) for k, v in base.items()}


def phase_for_epoch(epoch: int) -> str:
    if epoch >= PHASE_EPOCHS["calibration"]:
        return "calibration"
    if epoch >= PHASE_EPOCHS["adversarial_training"]:
        return "adversarial_training"
    return "representation_learning"


# ------------------------------------------------------------------ losses

def _masked_mean(x: Tensor, mask: Tensor) -> Tensor:
    n = mask.sum()
    return torch.where(n > 0, (x * mask).sum() / n.clamp(min=1.0), 0.0)


def energy_margin_loss(logits: Tensor, is_ood: Tensor, *, margin: float = 10.0,
                       temperature: float = 1.0) -> Tensor:
    """relu(E) in domain + relu(margin - E) out of domain."""
    e = -torch.logsumexp(logits / temperature, dim=-1)
    return (_masked_mean(torch.relu(e), (~is_ood).to(e.dtype))
            + _masked_mean(torch.relu(margin - e), is_ood.to(e.dtype)))


def temporal_consistency_loss(current_logits: Tensor, previous_logits: Tensor,
                              current_conf: Tensor, previous_conf: Tensor, *,
                              confidence_threshold: float = 0.8) -> Tensor:
    """KL(current || previous) where min(conf) < threshold."""
    cur_logp = torch.log_softmax(current_logits, dim=-1)
    prev_p = torch.softmax(previous_logits, dim=-1)
    kl = (cur_logp.exp() * (cur_logp - torch.log(prev_p + 1e-8))).sum(-1)
    apply = torch.minimum(current_conf, previous_conf) < confidence_threshold
    return _masked_mean(kl, apply.to(kl.dtype))


def confidence_calibration_loss(predicted_confidence: Tensor, correct: Tensor, *,
                                num_bins: int = 10, weight: float = 1.0) -> Tensor:
    """sum over bins of (mean_conf - mean_acc)^2 / num_bins."""
    edges = torch.linspace(0.0, 1.0, num_bins + 1, device=predicted_confidence.device)
    acc = correct.to(predicted_confidence.dtype)
    err = torch.zeros((), device=predicted_confidence.device)
    for b in range(num_bins):
        in_bin = ((predicted_confidence > edges[b])
                  & (predicted_confidence <= edges[b + 1])).to(acc.dtype)
        n = in_bin.sum()
        bin_conf = (predicted_confidence * in_bin).sum() / n.clamp(min=1.0)
        bin_acc = (acc * in_bin).sum() / n.clamp(min=1.0)
        err = err + torch.where(n > 0, (bin_conf - bin_acc) ** 2, 0.0)
    return weight * err / num_bins


# ---------------------------------------------------------- batch validator

def validate_batch_composition(labels: np.ndarray,
                               language_ids: Optional[np.ndarray] = None,
                               is_ood: Optional[np.ndarray] = None, *,
                               min_batch: int = 32, min_ood_ratio: float = 0.2,
                               min_languages: int = 2, min_classes: int = 2) -> Dict:
    """Warn-only composition checks on host arrays; returns a report dict."""
    labels = np.asarray(labels)
    warnings = []
    if len(labels) < min_batch:
        warnings.append(f"batch size {len(labels)} < {min_batch}")
    if is_ood is not None:
        ratio = float(np.asarray(is_ood).mean())
        if ratio < min_ood_ratio:
            warnings.append(f"OOD ratio {ratio:.2f} < {min_ood_ratio}")
    if language_ids is not None:
        n_lang = len(np.unique(language_ids))
        if n_lang < min_languages:
            warnings.append(f"{n_lang} languages < {min_languages}")
    n_cls = len(np.unique(labels))
    if n_cls < min_classes:
        warnings.append(f"{n_cls} emotion classes < {min_classes}")
    return {"valid": not warnings, "warnings": warnings,
            "batch_size": int(len(labels)), "num_classes": int(n_cls)}


# ------------------------------------------------------------- integration

def compute_total_loss(components: Dict[str, Tensor], epoch: int,
                       weights: Optional[LossWeights] = None) -> Dict:
    """The phase-weighted sum over the components given; an absent one, or
    one the phase switches off, contributes 0 (and reads 0 in the result)."""
    weights = weights or LossWeights()
    phase = phase_for_epoch(epoch)
    ref = next(iter(components.values()), None)
    device = ref.device if ref is not None else None
    total = torch.zeros((), device=device)
    out: Dict = {}
    for name, weight in weights.phase_weights(phase).items():
        comp = components.get(name)
        if comp is None or weight == 0.0:
            out[name] = torch.zeros((), device=device)
            continue
        out[name] = comp
        total = total + weight * comp
    out["total_loss"] = total
    out["phase"] = phase
    return out

"""Dual-gate OOD detection: a quality-based early gate, then an energy ⊕
Mahalanobis late gate with adaptive per-(language x SNR band) thresholds.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
research/dual_gate_ood.py, in plain PyTorch:
  * the OODReason taxonomy
  * early-gate thresholds: SNR < 5, clipping > 30, speech < 0.4, LID
    entropy > 2, language conf < 0.3, music > 0.5, laughter > 0.6,
    denoise gain > 15 dB, vectorized, first match wins
  * energy gate E = -logsumexp(logits / T), its temperature from a grid of
    100 points in [0.1, 10] minimising the energy scores' std
  * diagonal Mahalanobis distance to per-class prototypes, and their update
    from labelled features (class means and unbiased variances)
  * the late gate: softmax-weighted sigmoid(-E) ⊕ exp(-min distance),
    weights initialised (0.6, 0.4), threshold 0.5
  * adaptive thresholds per (language, SNR band), bands (-inf, 10),
    [10, 20), [20, inf), the global threshold where the specific one
    leaves [0.1, 0.9]
  * the outlier-exposure objective CE(in) + 0.5 uniform CE(outliers)
"""

from __future__ import annotations

import enum
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..models import layers

Tensor = torch.Tensor


class OODReason(enum.IntEnum):
    NONE = 0
    LOW_SNR = 1
    HIGH_CLIPPING = 2
    LOW_SPEECH_PROB = 3
    HIGH_LID_ENTROPY = 4
    LOW_LANGUAGE_CONF = 5
    HIGH_MUSIC_PROB = 6
    HIGH_LAUGHTER_PROB = 7
    EXCESSIVE_CONDITIONING = 8
    HIGH_ENERGY = 9
    HIGH_PROTOTYPE_DISTANCE = 10
    COMBINED_THRESHOLD = 11


EARLY_THRESHOLDS = dict(snr=5.0, clipping=30.0, speech_prob=0.4,
                        lid_entropy=2.0, language_conf=0.3, music=0.5,
                        laughter=0.6, conditioning_gain=15.0)

SNR_BANDS = ((-float("inf"), 10.0), (10.0, 20.0), (20.0, float("inf")))
NUM_LANGUAGES = 7


class EarlyOODResult(NamedTuple):
    is_ood: Tensor            # [B] bool
    reason: Tensor            # [B] int32 (OODReason)
    confidence_score: Tensor  # [B]


def early_ood(quality: Dict[str, Tensor]) -> EarlyOODResult:
    """Vectorized early gate. `quality` maps a metric's name to a [B]
    tensor; a missing metric takes its benign default."""
    ref = next(iter(quality.values()))

    def get(name, default):
        v = quality.get(name)
        return v if v is not None else torch.full_like(ref, default)

    snr = get("snr_db", 20.0)
    clip = get("clipping_percent", 0.0)
    speech = get("speech_prob", 1.0)
    ent = get("lid_entropy", 0.0)
    lconf = get("language_conf", 1.0)
    music = get("music_prob", 0.0)
    laugh = get("laughter_prob", 0.0)
    dgain = get("denoise_gain_db", 0.0)

    t = EARLY_THRESHOLDS
    checks = [
        (snr < t["snr"], OODReason.LOW_SNR),
        (clip > t["clipping"], OODReason.HIGH_CLIPPING),
        (speech < t["speech_prob"], OODReason.LOW_SPEECH_PROB),
        (ent > t["lid_entropy"], OODReason.HIGH_LID_ENTROPY),
        (lconf < t["language_conf"], OODReason.LOW_LANGUAGE_CONF),
        (music > t["music"], OODReason.HIGH_MUSIC_PROB),
        (laugh > t["laughter"], OODReason.HIGH_LAUGHTER_PROB),
        (dgain > t["conditioning_gain"], OODReason.EXCESSIVE_CONDITIONING),
    ]
    is_ood = torch.zeros_like(snr, dtype=torch.bool)
    reason = torch.zeros_like(snr, dtype=torch.int32)
    # first match wins, as the reference's elif chain
    for cond, r in reversed(checks):
        reason = torch.where(cond, torch.full_like(reason, int(r)), reason)
        is_ood = is_ood | cond
    # confidence: normalised margin from the nearest threshold
    conf = torch.minimum(snr / (2 * t["snr"]), speech).clamp(0.0, 1.0)
    conf = torch.where(is_ood, 1.0 - conf, conf)
    return EarlyOODResult(is_ood=is_ood, reason=reason, confidence_score=conf)


# ------------------------------------------------------------ energy gate

def energy_scores(logits: Tensor, temperature: Union[Tensor, float] = 1.0) -> Tensor:
    """E(x) = -logsumexp(logits / T)."""
    return -torch.logsumexp(logits / temperature, dim=-1)


def calibrate_energy_temperature(val_logits: Tensor) -> float:
    """T in linspace(0.1, 10, 100) minimising the std of the energy scores
    (population std, as jnp.std), over the grid at once."""
    temps = torch.linspace(0.1, 10.0, 100, device=val_logits.device)
    e = -torch.logsumexp(val_logits[None] / temps[:, None, None], dim=-1)   # [100, N]
    stds = e.std(dim=-1, correction=0)
    return float(temps[torch.argmin(stds)])


# --------------------------------------------------------- prototype gate

def init_prototype_detector(init: layers.Init, num_classes: int, feature_dim: int) -> dict:
    """Xavier prototypes (the JAX module's bound: fan_in = classes, fan_out
    = feature_dim) and unit covariances."""
    return {"prototypes": init.uniform((num_classes, feature_dim),
                                       layers.xavier_bound(num_classes, feature_dim)),
            "covariances": init.ones((num_classes, feature_dim))}


def prototype_distances(params: dict, features: Tensor) -> Tuple[Tensor, Tensor]:
    """Diagonal Mahalanobis distance to each class prototype: (distances
    [B, C], min_distances [B])."""
    diff = features[:, None, :] - params["prototypes"][None]          # [B, C, D]
    inv_cov = 1.0 / (params["covariances"] + 1e-8)                    # [C, D]
    d = torch.sqrt((diff * diff * inv_cov[None]).sum(-1))
    return d, d.amin(-1)


def update_prototypes(params: dict, features: Tensor, labels: Tensor,
                      num_classes: int) -> dict:
    """Class means and unbiased variances from labelled features; a class
    with no sample keeps its prototype and covariance."""
    onehot = F.one_hot(labels.long(), num_classes).to(features.dtype)  # [B, C]
    counts = onehot.sum(0)[:, None]                                    # [C, 1]
    means = (onehot.T @ features) / counts.clamp(min=1.0)
    sq = (onehot.T @ features.square()) / counts.clamp(min=1.0)
    var = (sq - means.square()).clamp(min=0.0) * counts / (counts - 1).clamp(min=1.0)
    has = counts > 0
    return {"prototypes": torch.where(has, means, params["prototypes"]),
            "covariances": torch.where(has, var + 1e-8, params["covariances"])}


# --------------------------------------------------------------- late gate

class LateOODResult(NamedTuple):
    is_ood: Tensor              # [B] bool
    energy_score: Tensor        # [B]
    prototype_distance: Tensor  # [B]
    combined_score: Tensor      # [B]
    reason: Tensor              # [B] int32


def init_late_detector(init: layers.Init, num_classes: int, feature_dim: int,
                       energy_weight: float = 0.6, prototype_weight: float = 0.4) -> dict:
    return {"prototype": init_prototype_detector(init, num_classes, feature_dim),
            "combination_weights": torch.tensor([energy_weight, prototype_weight],
                                                device=init.device),
            "temperature": torch.tensor(1.0, device=init.device)}


def late_ood(params: dict, logits: Tensor, features: Tensor, *,
             threshold: Union[Tensor, float] = 0.5) -> LateOODResult:
    """Combined energy ⊕ prototype gate."""
    e = energy_scores(logits, params["temperature"])
    _, min_d = prototype_distances(params["prototype"], features)
    e_norm = torch.sigmoid(-e)
    d_norm = torch.exp(-min_d)
    w = torch.softmax(params["combination_weights"], dim=-1)
    combined = w[0] * e_norm + w[1] * d_norm
    is_ood = combined < threshold
    code = lambda r: torch.full_like(e, int(r), dtype=torch.int32)
    reason = torch.where(e_norm < 0.3, code(OODReason.HIGH_ENERGY),
                         torch.where(d_norm < 0.3, code(OODReason.HIGH_PROTOTYPE_DISTANCE),
                                     code(OODReason.COMBINED_THRESHOLD)))
    return LateOODResult(is_ood=is_ood, energy_score=e, prototype_distance=min_d,
                         combined_score=combined, reason=reason)


# ------------------------------------------------------ adaptive thresholds

def init_threshold_manager(num_languages: int = NUM_LANGUAGES,
                           device: Union[str, torch.device] = "cpu") -> dict:
    return {"thresholds": torch.full((num_languages, len(SNR_BANDS)), 0.5, device=device),
            "global_threshold": torch.tensor(0.5, device=device)}


def snr_band_index(snr_db: Tensor) -> Tensor:
    idx = torch.zeros_like(snr_db, dtype=torch.int32)
    for i, (low, high) in enumerate(SNR_BANDS):
        idx = torch.where((snr_db >= low) & (snr_db < high), torch.full_like(idx, i), idx)
    return idx


def get_threshold(params: dict, language_id: Tensor, snr_db: Tensor) -> Tensor:
    """Per-sample threshold, the global one where the specific one leaves
    [0.1, 0.9]."""
    lang = language_id.long().clamp(0, params["thresholds"].shape[0] - 1)
    band = snr_band_index(snr_db).long()
    specific = params["thresholds"][lang, band]
    extreme = (specific < 0.1) | (specific > 0.9)
    return torch.where(extreme, params["global_threshold"], specific)


# ---------------------------------------------------------- dual-gate flow

class DualGateResult(NamedTuple):
    is_ood: Tensor                 # [B] bool
    stage: Tensor                  # [B] int32: 0 early, 1 late
    confidence_score: Tensor       # [B]
    reason: Tensor                 # [B] int32
    computational_savings: Tensor  # [B] bool (early short-circuit)


def dual_gate_ood(late_params: dict, threshold_params: dict,
                  quality: Dict[str, Tensor], logits: Tensor, features: Tensor,
                  *, language_id: Optional[Tensor] = None) -> DualGateResult:
    """The early gate, then the late gate with its adaptive threshold. Both
    gates run on every row; an early hit masks the late verdict, and the
    rows it spared show as `computational_savings`."""
    early = early_ood(quality)
    snr = quality.get("snr_db")
    if snr is None:
        snr = torch.full(logits.shape[:1], 20.0, device=logits.device)
    if language_id is None:
        language_id = torch.zeros(logits.shape[:1], dtype=torch.int32, device=logits.device)
    thr = get_threshold(threshold_params, language_id, snr)
    late = late_ood(late_params, logits, features, threshold=thr)

    is_ood = early.is_ood | late.is_ood
    stage = torch.where(early.is_ood, 0, 1).to(torch.int32)
    reason = torch.where(early.is_ood, early.reason, late.reason)
    conf = torch.where(early.is_ood, early.confidence_score, late.combined_score)
    return DualGateResult(is_ood=is_ood, stage=stage, confidence_score=conf,
                          reason=reason, computational_savings=early.is_ood)


def outlier_exposure_loss(in_logits: Tensor, in_labels: Tensor,
                          outlier_logits: Tensor) -> Tensor:
    """CE on in-domain rows + 0.5 x the uniform cross-entropy of the
    outliers (they should be maximally uncertain)."""
    logp = torch.log_softmax(in_logits, dim=-1)
    ce = -logp.gather(1, in_labels.long()[:, None]).mean()
    uniform_ce = -torch.log_softmax(outlier_logits, dim=-1).mean()
    return ce + 0.5 * uniform_ce

"""Cross-lingual variance handling: the gradient-reversal adversarial
language head, Houlsby adapters and the consistency loss, in plain
PyTorch.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
research/cross_lingual.py:
  * gradient reversal: the identity forward, -alpha * grad backward (a
    torch.autograd.Function, where JAX has a custom_vjp)
  * the language head: reversal -> 256 -> 128 -> 64 -> 7 MLP
  * the adapter: LN -> down (64) -> ReLU -> up -> residual
  * the consistency loss: MSE pulling the cosine / temperature similarity
    of same-emotion, different-language pairs toward 1 (temperature 0.1,
    weight 0.05)
  * the combined objective emotion_CE - lambda * language_CE + consistency
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..models import layers
from ..utils.runtime import resolve_device

Tensor = torch.Tensor
Device = Optional[Union[str, torch.device]]

NUM_LANGUAGES = 7   # en es fr de hi bn te
CONSISTENCY_TEMPERATURE = 0.1
CONSISTENCY_WEIGHT = 0.05


# ------------------------------------------------------- gradient reversal

class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, alpha: float) -> Tensor:
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: Tensor):
        return -ctx.alpha * g, None


def gradient_reversal(x: Tensor, alpha: float = 1.0) -> Tensor:
    """x unchanged; its gradient comes back multiplied by -alpha."""
    return _GradientReversal.apply(x, alpha)


# ---------------------------------------------------- adversarial LID head

def init_language_head(feature_dim: int = 256, num_languages: int = NUM_LANGUAGES, *,
                       generator: Optional[torch.Generator] = None,
                       device: Device = None) -> dict:
    """The head's parameters (`generator` on `device`; None seeds one with
    0), the card unless `device` says otherwise."""
    init = layers.Init(generator, resolve_device(device))
    return {"l1": layers.init_linear(init, feature_dim, 128),
            "l2": layers.init_linear(init, 128, 64),
            "l3": layers.init_linear(init, 64, num_languages)}


def language_adversarial_head(params: dict, features: Tensor, *, alpha: float = 1.0,
                              dropout_rate: float = 0.1,
                              generator: Optional[torch.Generator] = None,
                              deterministic: bool = True) -> Tensor:
    """[B, D] emotion features -> [B, num_languages] logits. The gradient
    into `features` is reversed, which makes them language-invariant."""
    x = gradient_reversal(features, alpha)
    x = torch.relu(layers.linear(params["l1"], x))
    x = layers.dropout(generator, x, dropout_rate, deterministic)
    x = torch.relu(layers.linear(params["l2"], x))
    x = layers.dropout(generator, x, dropout_rate, deterministic)
    return layers.linear(params["l3"], x)


# ----------------------------------------------------------------- adapter

def init_adapter(hidden_dim: int, bottleneck: int = 64, *,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None) -> dict:
    init = layers.Init(generator, resolve_device(device))
    return {"ln": layers.init_layer_norm(init, hidden_dim),
            "down": layers.init_linear(init, hidden_dim, bottleneck),
            "up": layers.init_linear(init, bottleneck, hidden_dim)}


def adapter(params: dict, x: Tensor) -> Tensor:
    """Houlsby adapter: LN -> down -> ReLU -> up -> residual."""
    h = layers.layer_norm(params["ln"], x)
    h = torch.relu(layers.linear(params["down"], h))
    return x + layers.linear(params["up"], h)


# -------------------------------------------------------- consistency loss

def consistency_loss(embeddings: Tensor, emotion_labels: Tensor, language_ids: Tensor, *,
                     temperature: float = CONSISTENCY_TEMPERATURE,
                     weight: float = CONSISTENCY_WEIGHT) -> Tensor:
    """weight * MSE((sim / temperature)[same emotion, other language], 1)."""
    B = embeddings.shape[0]
    norm = embeddings / torch.linalg.vector_norm(embeddings, dim=-1,
                                                 keepdim=True).clamp(min=1e-8)
    sim = norm @ norm.T / temperature
    emo = emotion_labels[:, None] == emotion_labels[None, :]
    lang = language_ids[:, None] != language_ids[None, :]
    mask = (emo & lang).to(sim.dtype)
    mask = mask * (1.0 - torch.eye(B, dtype=sim.dtype, device=sim.device))
    n = mask.sum()
    mse = torch.where(n > 0, (((sim - 1.0) ** 2) * mask).sum() / n.clamp(min=1.0), 0.0)
    return weight * mse


# -------------------------------------------------------- combined losses

def cross_lingual_losses(emotion_logits: Tensor, emotion_labels: Tensor,
                         language_logits: Tensor, language_labels: Tensor,
                         consistency: Tensor,
                         lambda_adversarial: float = 0.1) -> Dict[str, Tensor]:
    """total = emotion_CE - lambda * language_CE + consistency. The language
    logits came through the reversal, so the -lambda keeps the reference's
    sign convention."""
    def ce(logits, labels):
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(1, labels.long()[:, None]).mean()

    emotion_loss = ce(emotion_logits, emotion_labels)
    language_loss = ce(language_logits, language_labels)
    total = emotion_loss - lambda_adversarial * language_loss + consistency
    return {"emotion_loss": emotion_loss, "language_loss": language_loss,
            "consistency_loss": consistency, "total_loss": total}

"""Deep residual OpenMax classifier with class-anchor clustering.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
models/classifier.py:

  input_projection (Linear -> LN -> ReLU -> Dropout)
  35 residual layers, x = LN_i(x); x = x + block_i(x), with
      block_i = LN -> Linear -> ReLU -> Dropout -> Linear -> Dropout
  features = Linear(base, base//2) -> LN -> ReLU -> Dropout
  logits   = Linear(base//2, C), optionally OpenMax-adjusted
  anchor similarities and pull loss (anchor_dropout on the projection);
  uncertainty head (Linear -> ReLU -> Dropout -> Linear -> sigmoid)

The route of the residual layers is the JAX package's: the eval forward
(deterministic) takes the residual-stack kernel (ops/residual_stack.py:
the plain version on the CPU), training the plain loop with dropout,
under autograd. The layers stay stacked [L, ...] as the kernel reads them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import openmax as openmax_ops
from ..ops import residual_stack as rs
from ..utils import profiling
from . import layers

Tensor = torch.Tensor


class ClassifierOutput(NamedTuple):
    logits: Tensor               # [B, C]
    features: Tensor             # [B, base_dim//2]
    anchor_similarities: Tensor  # [B, C]
    anchor_loss: Tensor          # scalar
    uncertainty: Tensor          # [B, 1]


def init_classifier(init: layers.Init, input_dim: int, num_labels: int,
                    num_layers: int = 35, base_dim: int = 512) -> dict:
    half = base_dim // 2
    L = (num_layers,)
    return {
        "input_proj": layers.init_linear(init, input_dim, base_dim, xavier=True),
        "input_ln": layers.init_layer_norm(init, base_dim),
        "layers": {
            "ln_pre": layers.init_layer_norm(init, base_dim, stack=L),
            "block_ln": layers.init_layer_norm(init, base_dim, stack=L),
            "block_lin1": layers.init_linear(init, base_dim, base_dim,
                                             xavier=True, stack=L),
            "block_lin2": layers.init_linear(init, base_dim, base_dim,
                                             xavier=True, stack=L),
        },
        "out_proj1": layers.init_linear(init, base_dim, half, xavier=True),
        "out_ln": layers.init_layer_norm(init, half),
        "out_proj2": layers.init_linear(init, half, num_labels, xavier=True),
        "anchor": {
            "class_anchors": init.normal((num_labels, 128)),
            "projection": layers.init_linear(init, half, 128),
            "proj_ln": layers.init_layer_norm(init, 128),
            "temperature": init.ones(()),
        },
        "uncertainty": {
            "lin1": layers.init_linear(init, half, 64),
            "lin2": layers.init_linear(init, 64, 1),
        },
        "weibull": openmax_ops.init_weibull(init, num_labels, half),
    }


def _residual_stack(stacked: dict, x: Tensor, *, dropout_rate: float,
                    generator: Optional[torch.Generator]) -> Tensor:
    """The training route: the L layers as a loop, dropout in each block."""
    h = x
    for i in range(stacked["block_lin1"]["kernel"].shape[0]):
        layer = layers.layer_at(stacked, i)
        y = layers.layer_norm(layer["ln_pre"], h)
        b = layers.layer_norm(layer["block_ln"], y)
        b = torch.relu(layers.linear(layer["block_lin1"], b))
        b = layers.dropout(generator, b, dropout_rate, False)
        b = layers.linear(layer["block_lin2"], b)
        h = y + layers.dropout(generator, b, dropout_rate, False)
    return h


def classifier_features(params: dict, x: Tensor, *, dropout_rate: float = 0.15,
                        generator: Optional[torch.Generator] = None,
                        deterministic: bool = True) -> Tensor:
    """Penultimate [B, base//2] features."""
    h = layers.linear(params["input_proj"], x)
    h = torch.relu(layers.layer_norm(params["input_ln"], h))
    h = layers.dropout(generator, h, dropout_rate, deterministic)
    if deterministic:
        h = rs.residual_stack(params["layers"], h)
    else:
        h = _residual_stack(params["layers"], h, dropout_rate=dropout_rate,
                            generator=generator)
    f = layers.linear(params["out_proj1"], h)
    f = torch.relu(layers.layer_norm(params["out_ln"], f))
    return layers.dropout(generator, f, dropout_rate, deterministic)


def anchor_clustering(params: dict, features: Tensor, *, dropout_rate: float = 0.1,
                      generator: Optional[torch.Generator] = None,
                      deterministic: bool = True):
    """ClassAnchorClustering forward: (similarities [B, C], pull loss)."""
    p = layers.linear(params["projection"], features)
    p = torch.relu(layers.layer_norm(params["proj_ln"], p))
    p = layers.dropout(generator, p, dropout_rate, deterministic)
    eps = 1e-12  # torch F.normalize default
    p_norm = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True).clamp(min=eps)
    a = params["class_anchors"]
    a_norm = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp(min=eps)
    raw = p_norm @ a_norm.T
    sims = raw / params["temperature"]
    # clamp(sim - rowmax(sim), 0) is identically zero; kept for parity
    pull = (raw - raw.amax(dim=1, keepdim=True)).clamp(min=0.0).mean()
    return sims, pull


def classifier_forward(params: dict, x: Tensor, *, use_openmax: bool = False,
                       dropout_rate: float = 0.15, anchor_dropout: float = 0.1,
                       generator: Optional[torch.Generator] = None,
                       deterministic: bool = True) -> ClassifierOutput:
    """Full classifier head; `use_openmax` applies the Weibull adjustment."""
    with profiling.span("classifier"):
        feats = classifier_features(params, x, dropout_rate=dropout_rate,
                                    generator=generator, deterministic=deterministic)
        sims, anchor_loss = anchor_clustering(params["anchor"], feats,
                                              dropout_rate=anchor_dropout,
                                              generator=generator,
                                              deterministic=deterministic)
        logits = layers.linear(params["out_proj2"], feats)
        u = torch.relu(layers.linear(params["uncertainty"]["lin1"], feats))
        u = layers.dropout(generator, u, dropout_rate, deterministic)
        u = torch.sigmoid(layers.linear(params["uncertainty"]["lin2"], u))
        if use_openmax:
            logits = openmax_ops.openmax_adjust(params["weibull"], feats.float(),
                                                logits)
        return ClassifierOutput(logits=logits, features=feats,
                                anchor_similarities=sims, anchor_loss=anchor_loss,
                                uncertainty=u)


# ---------------------------------------------------------------------------
# Legacy heads: the reference's smaller MLP classifiers, kept for backward
# compatibility (on no runtime path of its scripts)
# ---------------------------------------------------------------------------

def init_legacy_mlp(init: layers.Init, input_dim: int, num_labels: int,
                    hidden: int = 128) -> dict:
    """Linear(in, 256) -> ReLU -> Dropout -> Linear(256, hidden) -> ReLU ->
    Dropout -> Linear(hidden, C), and the Weibull state."""
    return {
        "lin1": layers.init_linear(init, input_dim, 256),
        "lin2": layers.init_linear(init, 256, hidden),
        "lin3": layers.init_linear(init, hidden, num_labels),
        "weibull": openmax_ops.init_weibull(init, num_labels, hidden),
    }


def legacy_mlp_forward(params: dict, x: Tensor, *, dropout_rate: float = 0.1,
                       generator: Optional[torch.Generator] = None,
                       deterministic: bool = True):
    """(penultimate activations [B, hidden], logits [B, C])."""
    h = torch.relu(layers.linear(params["lin1"], x))
    h = layers.dropout(generator, h, dropout_rate, deterministic)
    h = torch.relu(layers.linear(params["lin2"], h))
    h = layers.dropout(generator, h, dropout_rate, deterministic)
    return h, layers.linear(params["lin3"], h)


def legacy_classifier_forward(params: dict, x: Tensor, **kw) -> Tensor:
    """The plain legacy classifier: logits only."""
    return legacy_mlp_forward(params, x, **kw)[1]


def legacy_openmax_forward(params: dict, x: Tensor, *, use_openmax: bool = True,
                           dropout_rate: float = 0.1,
                           generator: Optional[torch.Generator] = None,
                           deterministic: bool = True) -> Tensor:
    """The legacy OpenMax classifier: at inference, logits scaled by
    1 - unknown_prob where unknown_prob > 0.5 (threshold 0.5 and scale 1.0,
    not the deep head's 0.3 and 0.8)."""
    acts, logits = legacy_mlp_forward(params, x, dropout_rate=dropout_rate,
                                      generator=generator, deterministic=deterministic)
    if use_openmax and deterministic:
        logits = openmax_ops.openmax_adjust(params["weibull"], acts.float(), logits,
                                            threshold=0.5, reduction_scale=1.0)
    return logits


def legacy_fit_weibull(features: Tensor, labels: Tensor, num_classes: int) -> dict:
    """The legacy parameterisation: alpha 2.0, beta = std(distances), tau =
    min(distances), no 1.5x / 0.8x scaling."""
    return openmax_ops.fit_weibull(features, labels, num_classes,
                                   alpha=2.0, beta_scale=1.0, tau_scale=1.0)

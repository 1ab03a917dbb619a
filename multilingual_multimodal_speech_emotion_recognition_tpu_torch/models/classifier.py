"""Deep residual OpenMax classifier with class-anchor clustering, eval only.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
models/classifier.py:

  input_projection (Linear -> LN -> ReLU)
  35 residual layers, x = LN_i(x); x = x + block_i(x), through the
      residual-stack kernel (ops/residual_stack.py)
  features = Linear(base, base//2) -> LN -> ReLU
  logits   = Linear(base//2, C), optionally OpenMax-adjusted
  anchor similarities and pull loss; uncertainty head

The residual layers stay stacked [L, ...] as the kernel reads them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import openmax as openmax_ops
from ..ops import residual_stack as rs
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


def classifier_features(params: dict, x: Tensor) -> Tensor:
    """Penultimate [B, base//2] features."""
    h = layers.linear(params["input_proj"], x)
    h = torch.relu(layers.layer_norm(params["input_ln"], h))
    h = rs.residual_stack(params["layers"], h)
    f = layers.linear(params["out_proj1"], h)
    return torch.relu(layers.layer_norm(params["out_ln"], f))


def anchor_clustering(params: dict, features: Tensor):
    """ClassAnchorClustering forward: (similarities [B, C], pull loss)."""
    p = layers.linear(params["projection"], features)
    p = torch.relu(layers.layer_norm(params["proj_ln"], p))
    eps = 1e-12  # torch F.normalize default
    p_norm = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True).clamp(min=eps)
    a = params["class_anchors"]
    a_norm = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp(min=eps)
    raw = p_norm @ a_norm.T
    sims = raw / params["temperature"]
    # clamp(sim - rowmax(sim), 0) is identically zero; kept for parity
    pull = (raw - raw.max(dim=1, keepdim=True).values).clamp(min=0.0).mean()
    return sims, pull


def classifier_forward(params: dict, x: Tensor, *,
                       use_openmax: bool = False) -> ClassifierOutput:
    """Full classifier head; `use_openmax` applies the Weibull adjustment."""
    feats = classifier_features(params, x)
    sims, anchor_loss = anchor_clustering(params["anchor"], feats)
    logits = layers.linear(params["out_proj2"], feats)
    u = torch.relu(layers.linear(params["uncertainty"]["lin1"], feats))
    u = torch.sigmoid(layers.linear(params["uncertainty"]["lin2"], u))
    if use_openmax:
        logits = openmax_ops.openmax_adjust(params["weibull"], feats.float(),
                                            logits)
    return ClassifierOutput(logits=logits, features=feats,
                            anchor_similarities=sims, anchor_loss=anchor_loss,
                            uncertainty=u)

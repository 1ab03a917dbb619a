"""The port's plain eval step on a configuration whose audio encoder is
w2v-BERT 2.0 (`Wav2Vec2Config.backbone == "w2v-bert"`): `eval_step`'s
step, per-batch inputs, rows and comparison, judged against the plain
reference of `reference/w2v_bert.py`, whose audio encoder is the
conformer (reference/model.py's is the wav2vec2 family)."""

from __future__ import annotations

import importlib

import torch

from perfbench.harness import registry

_plain = registry.load_module("entries", "eval_step")
prepare, rows, build, compare = _plain.prepare, _plain.rows, _plain.build, _plain.compare


def reference(ref, cfg: dict, weights: dict, batch: dict, extra, args: dict) -> torch.Tensor:
    conformer = importlib.import_module(ref.__name__ + ".w2v_bert")
    logits, uncertainty = conformer.forward(weights, cfg, batch, use_openmax=args["use_openmax"])
    return torch.cat([logits, uncertainty], 1)

"""Remat (activation checkpointing) of the encoder layers.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
models/remat.py. `ModelConfig.remat_encoders` takes the same values:

  True / "full"   keep nothing inside a layer; recompute it in the backward
                  (torch.utils.checkpoint, non-reentrant)
  "dots"          keep the outputs of the plain matmuls (aten.mm / addmm:
                  the projections, which have no batch dimension in the
                  product), recompute the rest: the attention products,
                  softmax, LNs, GELU and dropout (torch's selective
                  checkpoint; JAX's dots_with_no_batch_dims_saveable)
  False / "none"  keep everything

A checkpointed layer runs twice: in the forward and again in the
backward. torch.utils.checkpoint restores the default generators only, so
a layer that draws its dropout masks from an explicit generator would draw
other masks the second time, and its gradients would be wrong with no
error. So the layer draws from a generator of its own, set to the caller's
generator's state before the region, both times; after the forward the
caller's generator moves on to where the layer left it. The draws are the
ones the layer would take from the caller's generator without remat.
Remat applies only while autograd records: without it nothing is kept.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import torch
from torch.utils import checkpoint as ckpt

RematSpec = Union[bool, str, None]

_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpoint_kwargs(remat: RematSpec) -> Optional[dict]:
    if remat is True or remat == "full":
        return {}
    if remat == "dots":
        return {"context_fn": functools.partial(ckpt.create_selective_checkpoint_contexts,
                                                _save_products)}
    if remat is False or remat is None or remat == "none":
        return None
    raise ValueError(f"unknown remat policy: {remat!r}")


def apply_remat(body: Callable, remat: RematSpec) -> Callable:
    """Wrap a layer body(x, layer, generator) -> x by the policy (see the
    module docstring); the wrapper has the same signature."""
    kwargs = _checkpoint_kwargs(remat)
    if kwargs is None:
        return body

    def run(x, layer: dict, generator: Optional[torch.Generator]):
        if not torch.is_grad_enabled():
            return body(x, layer, generator)
        if generator is None:
            return ckpt.checkpoint(body, x, layer, None, use_reentrant=False, **kwargs)
        state = generator.get_state()
        end = {}

        def replay(x, layer):
            g = torch.Generator(device=generator.device)
            g.set_state(state)
            out = body(x, layer, g)
            end["state"] = g.get_state()
            return out

        out = ckpt.checkpoint(replay, x, layer, use_reentrant=False, **kwargs)
        generator.set_state(end["state"])
        return out

    return run

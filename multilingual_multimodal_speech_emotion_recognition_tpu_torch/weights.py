"""Weight bridge: the JAX package's parameter pytree, with numpy leaves,
into the port's nested dict of tensors.

Layout convention: every leaf keeps its key path and its layout, with one
exception. Linear kernels stay [in, out] (y = x @ W + b), stacked layer
parameters stay stacked [L, ...] (the residual-stack kernel reads its
[L, D, D] weights as they are), LayerNorm scale/bias (the large presets'
per-conv `ln` among them), conv biases, embeddings, WavLM's gate
(`gru_lin` [L, Dh, 8], `gru_const` [L, H]) and bias table
(`rel_attn_embed` [buckets, H]), anchors, Weibull state and scalars are
copied as they are. Conv kernels, the
feature-extractor convs (`audio_backbone/convs/<i>/kernel`) and the
positional conv (`audio_backbone/pos_conv/kernel`), and Whisper's two
encoder convs (`whisper_params_from_jax`), go from JAX's WIO
[K, C_in/groups, C_out] to torch's [C_out, C_in/groups, K].

The bridge is strict: a JAX leaf it does not consume, a port parameter it
leaves unfilled and a shape that does not match each raise.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from .config import ModelConfig
from .models import model as model_mod, whisper
from .utils.runtime import resolve_device


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (i,))
    else:
        yield path, tree


def _is_conv_kernel(path: tuple) -> bool:
    return path[-1] == "kernel" and ("convs" in path or "pos_conv" in path)


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes leaves from a bf16 tree
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)  # a writable copy


def tree_from_jax(tree, template, *, device: Union[str, torch.device],
                  is_conv_kernel: Callable[[tuple], bool] = _is_conv_kernel):
    """Fill `template` (the port's tree, e.g. from an init function on the
    meta device) with the leaves of the JAX tree `tree` at the same paths;
    the leaves `is_conv_kernel` names go from WIO to torch's conv layout."""
    device = torch.device(device)
    source = dict(_flatten(tree))
    used = set()

    def fill(node, path):
        if isinstance(node, dict):
            return {k: fill(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [fill(v, path + (i,)) for i, v in enumerate(node)]
        if path not in source:
            raise KeyError(f"the JAX tree has no leaf at {'/'.join(map(str, path))}")
        arr = np.asarray(source[path])
        used.add(path)
        if is_conv_kernel(path):
            arr = arr.transpose(2, 1, 0)
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"{'/'.join(map(str, path))}: JAX leaf of shape "
                             f"{tuple(arr.shape)} for a port parameter of shape "
                             f"{tuple(node.shape)}")
        return _tensor(arr, device)

    out = fill(template, ())
    extra = sorted("/".join(map(str, p)) for p in set(source) - used)
    if extra:
        raise KeyError(f"JAX leaves the port does not consume: {extra}")
    return out


def params_from_jax(tree, cfg: ModelConfig, *,
                    device: Optional[Union[str, torch.device]] = None) -> dict:
    """The port's model parameters from the JAX package's `init_model` /
    checkpoint tree (numpy leaves). The card unless `device` says otherwise."""
    dev = resolve_device(device)
    return tree_from_jax(tree, model_mod.init_model(cfg, device="meta"), device=dev)


def _is_whisper_conv_kernel(path: tuple) -> bool:
    return path[-1] == "kernel" and path[-2] in ("conv1", "conv2")


def whisper_params_from_jax(tree, cfg: whisper.WhisperConfig, *,
                            device: Optional[Union[str, torch.device]] = None) -> dict:
    """The port's Whisper parameters from the JAX package's `init_whisper` /
    `params_from_hf` tree (numpy leaves): the encoder's conv kernels go from
    WIO [3, C_in, d] to [d, C_in, 3], everything else as it is. The card
    unless `device` says otherwise."""
    dev = resolve_device(device)
    return tree_from_jax(tree, whisper.init_whisper(cfg, device="meta"), device=dev,
                         is_conv_kernel=_is_whisper_conv_kernel)

"""Seeded weights in the port's parameter tree, made on the device in one
draw.

The tree's layout (keys and shapes) is the port's, read from its
`init_model` on the meta device, which makes shapes and no values. The
values are the benchmark's: one standard-normal draw over a flat float32
buffer from a generator seeded by the run's seed, each leaf a view of it,
shifted and scaled in place by a rule on its name. Both the port and the
reference read this same tree.

The rules keep every layer's output at the scale of its input (a product's
kernel has standard deviation 1 / sqrt(fan-in); a convolution's that of He
for GELU), give norms scales near 1, and give the Weibull state of the
OpenMax head distances far past its threshold, so that the adjustment
scales every clip and no clip sits on the threshold's edge.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

ALIGN = 64   # floats: every leaf starts on 256 bytes


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield prefix, tuple(tree.shape)


def rule(path: Tuple[str, ...], shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of the leaf at `path`."""
    name = path[-1]
    if path[-2:] == ("weibull", "alpha") or path[-2:] == ("weibull", "beta"):
        return 1.0, 0.0
    if path[-2:] == ("weibull", "tau"):
        return 0.0, 0.0
    if name == "scale" or name == "gru_const" or name == "temperature":
        return 1.0, 0.1
    if name == "bias":
        return 0.0, 0.02
    if name == "kernel" and "convs" in path or path[-2:] == ("pos_conv", "kernel"):
        out_c, in_c, k = shape[-3:]
        return 0.0, math.sqrt(2.0 / (in_c * k))
    if name == "kernel":
        return 0.0, 1.0 / math.sqrt(shape[-2])
    if name == "rel_attn_embed":
        return 0.0, 0.5
    if name == "class_anchors":
        return 0.0, 1.0
    return 0.0, 0.02    # embeddings, prototypes, the OpenMax class means


def make_weights(layout: dict, seed: int, device) -> dict:
    """The tree of `layout` (a tree of tensors whose shapes it takes)
    filled from `seed` on `device`, float32."""
    leaves = list(_paths(layout))
    offsets, total = [], 0
    for _, shape in leaves:
        offsets.append(total)
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, 0x5745]).generate_state(1, np.uint64)[0]))
    flat = torch.randn(total, generator=g, device=device)
    tree: Dict = {}
    for (path, shape), off in zip(leaves, offsets):
        view = flat[off:off + math.prod(shape)].view(shape)
        mean, std = rule(path, shape)
        view.mul_(std).add_(mean)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = view
    return _lists(layout, tree)


def _lists(layout, tree):
    """Rebuild the layout's lists (the conv stack) from the dict of paths."""
    if isinstance(layout, dict):
        return {k: _lists(v, tree[k]) for k, v in layout.items()}
    if isinstance(layout, (list, tuple)):
        return [_lists(v, tree[str(i)]) for i, v in enumerate(layout)]
    return tree

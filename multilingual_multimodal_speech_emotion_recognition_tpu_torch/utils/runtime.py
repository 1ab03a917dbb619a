"""Device policy of the port's entry points."""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The card unless the caller names another device. Asking for CUDA
    where there is none raises: nothing carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev


def to_device(x, device: torch.device) -> Optional[torch.Tensor]:
    """A tensor, numpy array or None on `device` (numpy arrays copied, so
    that a read-only array is safe to hand to torch)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x)).to(device)


def params_on(params: dict, device: torch.device) -> None:
    """Raise unless the parameters live on `device`: a step never moves its
    inputs to wherever the parameters happen to be."""
    have = params["classifier"]["input_proj"]["kernel"].device
    if have.type != device.type or (device.index is not None and have.index != device.index):
        raise ValueError(f"the parameters live on {have}; the step runs on {device}")


def leaves_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) of a nested dict / list tree, paths "/"-joined, in the
    tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def map_leaves(tree, fn: Callable, prefix: str = ""):
    """The tree with each leaf replaced by fn(path, leaf)."""
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(v, fn, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def tree_to(tree, device: Union[str, torch.device]):
    """A nested dict / list of tensors with every leaf on `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)

"""Device policy of the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

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


def tree_to(tree, device: Union[str, torch.device]):
    """A nested dict / list of tensors with every leaf on `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)

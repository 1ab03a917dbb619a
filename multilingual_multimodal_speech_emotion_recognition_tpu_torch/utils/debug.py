"""Numerical-safety tooling: finiteness checks and per-step generators.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
utils/debug.py. JAX's `checked` wraps a function with checkify and returns
an error value that the caller throws; eager PyTorch has no traced program
to instrument, so here `checked` returns a function that runs `fn`, scans
its outputs and raises a FloatingPointError naming the first non-finite
leaf. `assert_finite` raises the same way. Both read the result back from
the device, so they are debugging aids, not part of a hot loop.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch

from .runtime import resolve_device


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) pairs with the JAX package's path format: dict keys
    joined by "/", sequence indices as "[i]"."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]/")
    else:
        yield prefix[:-1], tree


def _floating(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _first_non_finite(tree) -> Optional[str]:
    for path, leaf in _leaves(tree):
        if _floating(leaf) and not bool(torch.isfinite(leaf).all()):
            return path or "output"
    return None


def checked(fn: Callable) -> Callable:
    """`fn` that raises FloatingPointError when any floating output leaf
    holds a NaN or Inf; the message names the first such leaf. Returns
    what `fn` returns (not an (error, output) pair)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = _first_non_finite(out)
        if bad is not None:
            raise FloatingPointError(f"{getattr(fn, '__name__', 'fn')}: {bad} "
                                     "contains NaN/Inf")
        return out
    return run


def assert_finite(x: torch.Tensor, name: str = "value") -> torch.Tensor:
    """x, after raising FloatingPointError if it holds a NaN or Inf."""
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"{name} contains NaN/Inf")
    return x


def tree_finite_report(tree) -> Dict[str, Tuple[bool, float, float]]:
    """path -> (finite?, min, max) of every floating leaf, for post-mortems."""
    out = {}
    for path, leaf in _leaves(tree):
        if _floating(leaf):
            a = leaf.detach().float()
            out[path] = (bool(torch.isfinite(a).all()),
                         float(a.min()) if a.numel() else 0.0,
                         float(a.max()) if a.numel() else 0.0)
    return out


def step_keys(base_seed: int, step: int, n: int = 1, *,
              device: Optional[Union[str, torch.device]] = None
              ) -> Union[torch.Generator, List[torch.Generator]]:
    """Per-step generators on `device` (the card unless it says otherwise),
    seeded by the train loop's rule (train/loop.step_seed): one generator
    seeded with step_seed(base_seed, step), or for n > 1 a list whose i-th
    is seeded with step_seed(that seed, i)."""
    from ..train.loop import step_seed
    dev = resolve_device(device)
    seed = step_seed(base_seed, step)
    if n == 1:
        return torch.Generator(device=dev).manual_seed(seed)
    return [torch.Generator(device=dev).manual_seed(step_seed(seed, i)) for i in range(n)]

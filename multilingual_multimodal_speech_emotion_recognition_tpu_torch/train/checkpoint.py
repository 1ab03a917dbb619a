"""Parameter checkpoints of the port.

A checkpoint is a directory holding `meta.json` (step, epoch, f1 and any
extra entries), `config.json` (the whole Config's JSON, as the JAX package
writes it) and `params.pt`: `torch.save` of the parameter tree as CPU
tensors, in the port's layout (models/model.py:init_model). The format is
the port's own; a JAX checkpoint (orbax or pickle, which need JAX to read)
comes across through scripts/torch_import_jax_checkpoint.py. Optimizer
state waits for the training slice.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..utils.runtime import resolve_device, tree_to

PARAMS_FILE = "params.pt"


def save_checkpoint(path: Union[str, Path], *, params: dict, step: int = 0,
                    epoch: int = 0, f1: float = 0.0,
                    config_json: Optional[str] = None,
                    extra: Optional[Dict[str, Any]] = None) -> Path:
    """Write a checkpoint directory; returns its path."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    meta = {"step": int(step), "epoch": int(epoch), "f1": float(f1)}
    if extra:
        meta.update(extra)
    (path / "meta.json").write_text(json.dumps(meta))
    if config_json is not None:
        (path / "config.json").write_text(config_json)
    torch.save(tree_to(params, "cpu"), path / PARAMS_FILE)
    return path


def restore_checkpoint(path: Union[str, Path], *,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Tuple[dict, dict]:
    """(params on `device`, meta). The card unless `device` says otherwise."""
    path = Path(path)
    dev = resolve_device(device)
    meta_path = path / "meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    params = torch.load(path / PARAMS_FILE, map_location=dev, weights_only=True)
    return params, meta


def load_config_json(path: Union[str, Path]) -> Optional[str]:
    p = Path(path) / "config.json"
    return p.read_text() if p.exists() else None


def best_checkpoint(save_dir: Union[str, Path]) -> Optional[Path]:
    """Highest-F1 checkpoint directory under save_dir."""
    best, best_f1 = None, -1.0
    for meta in Path(save_dir).glob("*/meta.json"):
        try:
            f1 = json.loads(meta.read_text()).get("f1", -1.0)
        except (OSError, json.JSONDecodeError, AttributeError):
            continue
        if f1 > best_f1:
            best, best_f1 = meta.parent, f1
    return best

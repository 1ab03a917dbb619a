"""Checkpoints of the port.

A checkpoint is a directory holding `meta.json` (step, epoch, f1 and any
extra entries), `config.json` (the whole Config's JSON, as the JAX package
writes it), `params.pt` (`torch.save` of the parameter tree as CPU
tensors, in the port's layout, models/model.py:init_model) and, from a
training run, `opt_state.pt` (the AdamW state of train/optimizer.py). The
format is the port's own; a JAX checkpoint (orbax or pickle, which need JAX
to read) comes across through scripts/torch_import_jax_checkpoint.py.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
train/checkpoint.py's dedup_frozen: with frozen backbones, which are most
of a checkpoint's bytes and never change, the backbone subtrees go once to
a shared `frozen_store` directory and each checkpoint keeps the rest and a
`frozen_ref.json` (the store's path relative to it, and the keys). The
store's `DONE` marker holds a fingerprint of the weights it was written
for; a save whose backbones fingerprint otherwise raises instead of
pointing at the wrong weights. A legacy marker without a fingerprint is
checked against the stored weights themselves and rewritten.
`restore_checkpoint` merges the store back, so a reader (the eval CLI)
sees a whole parameter tree either way.

Under a process group every rank calls `save_checkpoint`: sharded leaves
(DTensors) are gathered whole on every rank (a collective), and only rank
0 writes; on resume every rank reads rank 0's files (a shared filesystem).
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.runtime import leaves_with_paths, resolve_device, tree_to

PARAMS_FILE = "params.pt"
OPT_STATE_FILE = "opt_state.pt"
FROZEN_REF = "frozen_ref.json"
FROZEN_SUBTREES = ("audio_backbone", "text_backbone")

Device = Optional[Union[str, torch.device]]


def frozen_fingerprint(frozen_tree: dict) -> str:
    """sha256 of every leaf's path, shape and dtype and of an exact probe
    of its contents: its first and last 4 elements as f32, gathered on the
    leaves' device into one tensor and read back once. The same weights
    give the same fingerprint on the CPU and the card."""
    leaves = list(leaves_with_paths(frozen_tree))
    desc = [(path.split("/"), list(t.shape), str(t.dtype).replace("torch.", ""))
            for path, t in leaves]
    probes = [p for _, t in leaves for p in (t.reshape(-1)[:4], t.reshape(-1)[-4:])]
    probe = (torch.cat([p.float() for p in probes]).cpu().numpy() if probes
             else np.zeros(0, np.float32))
    h = hashlib.sha256()
    h.update(json.dumps(desc, sort_keys=True).encode())
    h.update(probe.astype("<f4").tobytes())
    return h.hexdigest()


def _write_frozen_store(store: Path, frozen: dict) -> None:
    """Write the store once; afterwards hold its fingerprint to `frozen`'s."""
    fp = frozen_fingerprint(frozen)
    done = store / "DONE"
    if not done.exists():
        store.mkdir(parents=True, exist_ok=True)
        torch.save(tree_to(frozen, "cpu"), store / PARAMS_FILE)
        done.write_text(json.dumps({"fingerprint": fp}))
        return
    try:
        stored = json.loads(done.read_text()).get("fingerprint")
    except (json.JSONDecodeError, AttributeError):
        stored = None
    if stored is None:
        # a legacy marker (no fingerprint): check by content, then migrate it
        stored = frozen_fingerprint(
            torch.load(store / PARAMS_FILE, map_location="cpu", weights_only=True))
        if stored == fp:
            done.write_text(json.dumps({"fingerprint": fp}))
    if stored != fp:
        raise ValueError(
            f"frozen_store at {store} was written for other frozen backbone weights "
            f"(fingerprint mismatch: stored={stored!r} current={fp[:16]}...). Delete "
            "the store or use a fresh save_dir / frozen_store.")


def save_checkpoint(path: Union[str, Path], *, params: dict,
                    opt_state: Optional[dict] = None, step: int = 0,
                    epoch: int = 0, f1: float = 0.0,
                    config_json: Optional[str] = None,
                    extra: Optional[Dict[str, Any]] = None,
                    dedup_frozen: bool = False,
                    frozen_store: Optional[Union[str, Path]] = None) -> Path:
    """Write a checkpoint directory; returns its path. With dedup_frozen the
    backbones go to `frozen_store` (default: a `frozen_store` beside the
    checkpoint), written by the first save only. COLLECTIVE under a process
    group: every rank calls it, rank 0 alone writes."""
    from ..parallel import multihost as mh
    params = mh.host_replicated(params)
    if opt_state is not None:
        opt_state = mh.host_replicated(opt_state)
    path = Path(path)
    if not mh.is_coordinator():
        return path
    path.mkdir(parents=True, exist_ok=True)
    meta = {"step": int(step), "epoch": int(epoch), "f1": float(f1)}
    if extra:
        meta.update(extra)
    (path / "meta.json").write_text(json.dumps(meta))
    if config_json is not None:
        (path / "config.json").write_text(config_json)
    to_save = params
    if dedup_frozen:
        frozen = {k: params[k] for k in FROZEN_SUBTREES if k in params}
        if frozen:
            store = Path(frozen_store) if frozen_store is not None \
                else path.parent / "frozen_store"
            _write_frozen_store(store, frozen)
            (path / FROZEN_REF).write_text(json.dumps({
                "store": os.path.relpath(store, path), "keys": sorted(frozen)}))
            to_save = {k: v for k, v in params.items() if k not in frozen}
    torch.save(tree_to(to_save, "cpu"), path / PARAMS_FILE)
    if opt_state is not None:
        torch.save(tree_to(opt_state, "cpu"), path / OPT_STATE_FILE)
    return path


def restore_checkpoint(path: Union[str, Path], *, device: Device = None
                       ) -> Tuple[dict, dict]:
    """(params on `device`, meta), the frozen store merged back where the
    checkpoint refers to one. The card unless `device` says otherwise."""
    path = Path(path)
    dev = resolve_device(device)
    meta_path = path / "meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    params = torch.load(path / PARAMS_FILE, map_location=dev, weights_only=True)
    ref_path = path / FROZEN_REF
    if ref_path.exists():
        ref = json.loads(ref_path.read_text())
        frozen = torch.load((path / ref["store"]).resolve() / PARAMS_FILE,
                            map_location=dev, weights_only=True)
        missing = set(ref["keys"]) - set(frozen)
        if missing:
            raise KeyError(f"frozen store of {path} lacks {sorted(missing)}")
        params = {**params, **{k: frozen[k] for k in ref["keys"]}}
    return params, meta


def restore_opt_state(path: Union[str, Path], *, device: Device = None) -> Optional[dict]:
    """The optimizer state a training checkpoint holds, on `device`, or None."""
    p = Path(path) / OPT_STATE_FILE
    if not p.exists():
        return None
    return torch.load(p, map_location=resolve_device(device), weights_only=True)


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

"""Serving artifacts: the eval forward traced by torch.export, per shape.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
export.py, with torch.export in place of jax.export. The forward
(optionally with the front-end DSP) is traced once for one serving shape
into a program that a serving process loads and runs without the model
code's Python: the residual stack is one `ser_torch::residual_stack` node
(kernel A1 on the card) and the DSP's three gates are `torch.cond`s.

Artifacts are per shape (fixed-shape bucketed serving, like the data
pipeline) and per device (the program holds the device it was traced on;
export on the device you serve on). Layout on disk:

    <dir>/program.pt2    torch.export.save of fn(params, batch)
    <dir>/params.npz     f32 parameter arrays keyed by path (a quantised
                         tree's int8 `kernel_q` stays int8, its `w_scale` f32)
    <dir>/spec.json      batch spec, config JSON, output names, devices and
                         the parameter tree's skeleton
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .config import ModelConfig
from .data import bucketing
from .models import model as mdl
from .ops import quant
from .utils.runtime import resolve_device, tree_to

OUTPUTS = ("logits", "uncertainty", "features")


def _key(path: tuple) -> str:
    """A leaf's npz key, written as jax.tree_util.keystr writes it."""
    return "".join(f"[{p!r}]" if isinstance(p, str) else f"[{p}]" for p in path)


def _leaves(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, path + (i,))
    else:
        yield path, node


def _flatten_params(params) -> Dict[str, np.ndarray]:
    out = {}
    for path, leaf in _leaves(params):
        key = _key(path)
        if key in out:
            raise ValueError(f"duplicate param key path {key!r}")
        leaf = leaf.detach().cpu()
        out[key] = (leaf.float() if leaf.is_floating_point() else leaf).numpy()
    return out


def _skeletonize(node) -> Dict:
    """The parameter tree as JSON: dict / list / tuple structure with the
    npz keys at the leaves (the JAX package's schema), so that the tree is
    rebuilt by walking it, with no parsing of keys."""
    def walk(n, path):
        if isinstance(n, dict):
            return {"kind": "dict",
                    "items": {str(k): walk(v, path + (str(k),)) for k, v in n.items()}}
        if isinstance(n, (list, tuple)):
            return {"kind": "list" if isinstance(n, list) else "tuple",
                    "items": [walk(v, path + (i,)) for i, v in enumerate(n)]}
        return {"kind": "leaf", "key": _key(path)}

    return walk(node, ())


def _rebuild_from_skeleton(skel: Dict, arrays: Dict[str, np.ndarray],
                           device: Union[str, torch.device] = "cpu"):
    kind = skel["kind"]
    if kind == "dict":
        return {k: _rebuild_from_skeleton(v, arrays, device) for k, v in skel["items"].items()}
    if kind in ("list", "tuple"):
        seq = [_rebuild_from_skeleton(v, arrays, device) for v in skel["items"]]
        return seq if kind == "list" else tuple(seq)
    leaf = torch.from_numpy(np.array(arrays[skel["key"]]))
    if leaf.dtype == torch.int8:  # kernel_q: npz keeps it row-major
        leaf = quant.card_layout(leaf)
    return leaf.to(device)


def _batch_spec(batch_size: int, audio_samples: int, text_tokens: int,
                with_dsp: bool, wire: str = "f32") -> Dict[str, Tuple[tuple, str]]:
    if wire == "int16":
        # wire-compact input: int16 PCM and per-row lengths, about 4x fewer
        # host->device bytes than f32 audio and mask; exact for PCM sources
        spec = {
            "audio": ((batch_size, audio_samples), "int16"),
            "audio_len": ((batch_size,), "int32"),
        }
    elif wire == "f32":
        spec = {
            "audio": ((batch_size, audio_samples), "float32"),
            "audio_mask": ((batch_size, audio_samples), "float32"),
        }
    else:
        raise ValueError(f"wire must be 'f32' or 'int16', got {wire!r}")
    spec.update({
        "text_ids": ((batch_size, text_tokens), "int32"),
        "text_mask": ((batch_size, text_tokens), "float32"),
    })
    if with_dsp:
        spec["lid_entropy"] = ((batch_size,), "float32")
        spec["lid_conf"] = ((batch_size,), "float32")
    else:
        spec["quality_feats"] = ((batch_size, 8), "float32")
        spec["cond_feats"] = ((batch_size, 12), "float32")
    return spec


class _Forward(torch.nn.Module):
    """fn(params, batch) -> (logits, uncertainty, features), all f32."""

    def __init__(self, cfg: ModelConfig, use_openmax: bool, audio_samples: int):
        super().__init__()
        self.cfg, self.use_openmax, self.audio_samples = cfg, use_openmax, audio_samples

    def forward(self, params: dict, batch: dict):
        if "audio_len" in batch:  # int16 wire: dequantise and build the mask
            positions = torch.arange(self.audio_samples, dtype=torch.int32,
                                     device=batch["audio"].device)
            mask = (positions[None, :] < batch["audio_len"][:, None]).float()
            batch = {k: v for k, v in batch.items() if k != "audio_len"}
            batch["audio"] = batch["audio"].float() * (mask / 32768.0)
            batch["audio_mask"] = mask
        o = mdl.model_forward(params, self.cfg, batch, deterministic=True,
                              use_openmax=self.use_openmax)
        return o.logits.float(), o.uncertainty.float(), o.features.float()


def export_forward(params: dict, cfg: ModelConfig, out_dir: Union[str, Path], *,
                   batch_size: int = 32, audio_seconds: float = 4.0,
                   text_tokens: int = 32, sample_rate: int = 16000,
                   with_dsp: bool = True, use_openmax: bool = True,
                   wire: str = "f32", config_json: Optional[str] = None,
                   device: Optional[Union[str, torch.device]] = None) -> Path:
    """Trace the forward (optionally with the front-end DSP) for one serving
    shape on `device` (the card unless told otherwise) and write the
    artifact. Returns its directory.

    wire="int16" takes int16 PCM and per-row lengths; the program
    dequantises (x / 32768) and builds the mask on the device."""
    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    T = bucketing.seconds_to_samples(audio_seconds, sample_rate)
    spec = _batch_spec(batch_size, T, text_tokens, with_dsp, wire)

    # the artifact is f32 (npz has no bfloat16); the forward casts to
    # cfg.compute_dtype itself, so the served numbers are the same
    params = tree_to(mdl.cast_floating(params, torch.float32), dev)
    example = {k: torch.zeros(shape, dtype=getattr(torch, dtype), device=dev)
               for k, (shape, dtype) in spec.items()}
    with torch.no_grad():
        program = torch.export.export(_Forward(cfg, use_openmax, T), (params, example),
                                      strict=False)
    # the program keeps its example inputs, the parameters among them, and
    # would save them too: the parameters go to params.npz instead
    program.example_inputs = None
    torch.export.save(program, out / "program.pt2")

    np.savez(out / "params.npz", **_flatten_params(params))
    (out / "spec.json").write_text(json.dumps({
        "batch_spec": {k: [list(s), d] for k, (s, d) in spec.items()},
        "outputs": list(OUTPUTS),
        "with_dsp": with_dsp,
        "use_openmax": use_openmax,
        "wire": wire,
        "sample_rate": int(sample_rate),  # serving resamples requests to this
        "devices": [dev.type],
        "config_json": config_json,
        # serving fails fast on a tokenizer / artifact mismatch: an id past
        # the embedding table is a device-side assert on the card
        "text_vocab_size": int(cfg.text.vocab_size),
        "num_labels": int(cfg.num_labels),
        "params_tree": _skeletonize(params),
    }))
    return out


def export_buckets(params: dict, cfg: ModelConfig, out_dir: Union[str, Path], *,
                   buckets, text_tokens: int = 32, sample_rate: int = 16000,
                   with_dsp: bool = True, use_openmax: bool = True,
                   wire: str = "f32", config_json: Optional[str] = None,
                   device: Optional[Union[str, torch.device]] = None) -> Path:
    """One artifact per (audio_seconds, batch_size) bucket under
    `<out_dir>/b<sec>s_bs<batch>/`, with a top-level `index.json` a router
    reads to pick the bucket for a clip's length."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    index = []
    for audio_seconds, batch_size in buckets:
        name = f"b{audio_seconds:g}s_bs{batch_size}"
        export_forward(params, cfg, out / name, batch_size=batch_size,
                       audio_seconds=float(audio_seconds), text_tokens=text_tokens,
                       sample_rate=sample_rate, with_dsp=with_dsp,
                       use_openmax=use_openmax, wire=wire, config_json=config_json,
                       device=device)
        index.append({"dir": name, "audio_seconds": float(audio_seconds),
                      "audio_samples": bucketing.seconds_to_samples(audio_seconds,
                                                                    sample_rate),
                      "batch_size": int(batch_size)})
    index.sort(key=lambda e: e["audio_seconds"])
    (out / "index.json").write_text(json.dumps({
        "buckets": index, "text_tokens": text_tokens,
        "sample_rate": sample_rate}, indent=2))
    return out


class ServingModel:
    """A loaded artifact: `predict(batch)` runs the traced program, with no
    tracing and none of the model code's Python. It runs on the card unless
    told otherwise, and refuses an artifact traced for another device."""

    def __init__(self, art_dir: Union[str, Path],
                 device: Optional[Union[str, torch.device]] = None):
        art = Path(art_dir)
        self.spec = json.loads((art / "spec.json").read_text())
        want = torch.device("cuda" if device is None else device)
        if want.type not in self.spec["devices"]:
            raise ValueError(
                f"{art}: the program was traced for {self.spec['devices']} and "
                f"cannot run on {want}; export it on the device it serves on")
        self.device = resolve_device(want)
        self.program = torch.export.load(art / "program.pt2")
        self._call = self.program.module()
        loaded = np.load(art / "params.npz")
        self._flat_params = {k: loaded[k] for k in loaded.files}
        self._params_dev = None

    def _params(self) -> dict:
        # on the device once, rebuilt in the traced tree's order
        if self._params_dev is None:
            self._params_dev = _rebuild_from_skeleton(self.spec["params_tree"],
                                                      self._flat_params, self.device)
        return self._params_dev

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        dev_batch = {k: torch.from_numpy(np.array(batch[k], dtype=d)).to(self.device)
                     for k, (_, d) in self.spec["batch_spec"].items()}
        with torch.inference_mode():
            outs = self._call(self._params(), dev_batch)
        return {name: o.cpu().numpy() for name, o in zip(self.spec["outputs"], outs)}

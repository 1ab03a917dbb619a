"""Manifest evaluation: 5-view TTA, temperature calibration, OpenMax and the
full report, on the device.

Counterpart of the JAX package's eval/evaluate.py, with the reference's
eval.py semantics:
  * 5-view TTA (orig, speed .95/1.05, noise 15/20 dB), logits averaged
    over views. The batch expands to [V*B] on the device and one forward
    serves all views; the text encoder runs once at [B] and its output is
    tiled V times, view-major (TTA perturbs only the waveform).
  * temperature scaling by a 100-point logspace grid minimising
    mean|maxprob - correct| on a val manifest, fitted without OpenMax.
  * weighted F1, accuracy, UAR, energy-score statistics, the
    classification report, the confusion matrix, per-class accuracy and a
    confidence summary; per-utterance predictions as JSONL.

Every entry point runs on the card unless the caller passes device="cpu";
without a card it raises. Noise views draw from a torch.Generator on the
step's device, seeded once per `collect_logits` and advanced per batch, so
a run is repeatable on one device (the draws are not JAX's).

Under a process group (parallel/multihost.py), where the JAX package lays
each batch over its mesh, the parameters are laid out on the mesh of
cfg.mesh (or the caller's), each data shard scores its share of every
batch's rows (HostShardedLoader on 'data''s rank and size), the ranks of a
'model' group the same rows with the encoders and the cross-modal
attention split over the group (parallel/tensor.py; nothing gathered over
'model'), and the logits, labels and indices come back onto every rank
over 'data', batch by batch in one process's row order (allgather_rows),
so every rank computes the same report. The TTA noise views then draw per
data shard, so they differ from one process's.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..config import Config, ModelConfig
from ..data import manifest as manifest_lib
from ..data.pipeline import EVAL_HOST_KEYS, BucketedLoader, SERDataset
from ..data.prefetch import device_prefetch
from ..data.tokenizer import Tokenizer, get_tokenizer
from ..models import model as mdl
from ..ops import audio_dsp, openmax as om
from ..parallel import mesh as mesh_lib, multihost as mh, tensor as tensor_lib
from ..utils import metrics as M, profiling
from ..utils.runtime import params_on, resolve_device, to_device, tree_to

Device = Optional[Union[str, torch.device]]

SIX_NAMES = ["angry", "happy", "sad", "neutral", "disgust", "fear"]
MAX_TTA_VIEWS = 5
NOISE_SEED = 0   # the TTA noise generator's seed, set once per collect_logits


def temperature_scaling(logits: np.ndarray, temperature: float) -> np.ndarray:
    return logits / temperature


def find_optimal_temperature(val_logits: np.ndarray, val_labels: np.ndarray) -> float:
    """Grid search (the reference's eval.py:49-67), in numpy f64."""
    temps = np.logspace(-1, 2, 100)
    best_t, best_ece = 1.0, np.inf
    for t in temps:
        scaled = val_logits / t
        e = np.exp(scaled - scaled.max(axis=1, keepdims=True))
        probs = e / e.sum(axis=1, keepdims=True)
        maxp = probs.max(axis=1)
        preds = probs.argmax(axis=1)
        ece = np.mean(np.abs(maxp - (preds == val_labels).astype(np.float64)))
        if ece < best_ece:
            best_ece, best_t = ece, float(t)
    return best_t


def _batch_on(batch: dict, device: torch.device) -> dict:
    return {k: to_device(v, device) for k, v in batch.items()}


def make_eval_step(model_cfg: ModelConfig, *, use_openmax: bool = False,
                   device: Device = None, tp=None):
    """The plain eval step (the JAX package's train/train_step.py:
    make_eval_step): step(params, batch) -> (logits, features,
    uncertainty), under torch.inference_mode(). Under `tp` (a
    parallel/tensor.ModelGroup) `params` is this rank's view
    (parallel/tensor.split) and the forward is tensor-parallel."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(params: dict, batch: dict):
        with profiling.span("step"):
            params_on(params, dev)
            out = mdl.model_forward(params, model_cfg, batch, use_openmax=use_openmax, tp=tp)
            return out.logits, out.features, out.uncertainty

    return step


def make_tta_eval_step(cfg: Config, num_tta: int = 5, use_openmax: bool = True,
                       device: Device = None, tp=None):
    """step(params, batch, generator=None, noise=None) -> logits [B, C]: one
    forward over the [V*B] expanded batch, logits meaned over the views.

    The front-end DSP runs on the expanded batch with the LID scalars tiled;
    the encoders take the compute-dtype parameters and XLM-R runs once at
    [B], its output tiled V times; `model_heads` takes the raw tree (it
    casts inside). `noise`, where given, holds the two noise views'
    standard-normal draws [B, T]; otherwise they come from `generator`.
    The step runs under torch.inference_mode(); tensor-parallel under `tp`,
    as make_eval_step's."""
    if not 1 <= num_tta <= MAX_TTA_VIEWS:
        raise ValueError(f"num_tta must be in 1..{MAX_TTA_VIEWS}, not {num_tta}")
    dev = resolve_device(device)
    mcfg = cfg.model
    dtype = torch.bfloat16 if mcfg.compute_dtype == "bfloat16" else torch.float32

    @torch.inference_mode()
    def step(params: dict, batch: dict, generator: Optional[torch.Generator] = None,
             noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        with profiling.span("step"):
            params_on(params, dev)
            batch = _batch_on(batch, dev)
            V = num_tta
            B = batch["audio"].shape[0]
            tile = lambda x: torch.cat([x] * V, dim=0)
            p = mdl.encoder_params(params, mcfg)

            with profiling.span("tta_expand"):
                wave, mask = audio_dsp.tta_expand(
                    batch["audio"], batch["audio_mask"], num_tta=V,
                    sample_rate=cfg.data.sample_rate, generator=generator,
                    noise=None if noise is None else [to_device(n, dev) for n in noise])
            fbatch = {"audio": wave, "audio_mask": mask}
            for k in ("quality_feats", "cond_feats", "lid_entropy", "lid_conf"):
                if k in batch:
                    fbatch[k] = tile(batch[k])
            wave, quality_feats, cond_feats = mdl.frontend_features(mcfg, fbatch)

            a_seq, a_mask = mdl.encode_audio(p, mcfg, wave.to(dtype), mask,
                                             quality_feats=quality_feats,
                                             cond_feats=cond_feats, tp=tp)
            t_seq, t_mask = mdl.encode_text(p, mcfg, batch["text_ids"], batch["text_mask"],
                                            asr_feats=batch.get("asr_feats"), tp=tp)
            out = mdl.model_heads(params, mcfg, a_seq, a_mask, tile(t_seq), tile(t_mask),
                                  use_openmax=use_openmax, tp=tp)
            return out.logits.reshape(V, B, -1).mean(dim=0)

    return step


def eval_view(params: dict, mesh=None):
    """(params, ModelGroup or None, mesh) for the eval steps: a tree of
    DTensors becomes this rank's view on its own mesh; a plain tree under
    `mesh` is taken as this rank's view already; otherwise (params, None,
    None), or under a group with neither the whole tree on every rank."""
    own = tensor_lib.mesh_of(params)
    if own is not None:
        view, tp = tensor_lib.split(params)
        return view, tp, own
    if mesh is not None:
        return params, tensor_lib.model_group(mesh), mesh
    return mh.host_replicated(params), None, None


def gather_rows(rows: Dict[str, np.ndarray], mesh, batches) -> Dict[str, np.ndarray]:
    """Each rank's host rows gathered over 'data' onto every rank, in one
    process's order (multihost.allgather_rows with `batches`, this rank's
    real rows per batch); as they are on one process. COLLECTIVE."""
    if mh.world_size() == 1:
        return rows
    return {k: mh.allgather_rows(v, mesh=mesh, batches=batches) for k, v in rows.items()}


def collect_logits(params: dict, cfg: Config, loader: BucketedLoader, *,
                   use_tta: bool = False, num_tta: int = 5,
                   use_openmax: bool = True,
                   device: Device = None, mesh=None) -> Dict[str, np.ndarray]:
    """Logits (f64), labels and manifest indices of every real row of the
    loader's epoch 0; each step's host-clock seconds (`step_seconds`: from
    the batch's arrival on the device to its logits on the host) and the
    whole pass's (`pass_seconds`, the loader's start included), whose
    difference is the time the steps waited for the loader. Under a group
    each data shard runs its loader's rows, tensor-parallel over the
    'model' group where `params` are sharded on a mesh (or are a rank's view
    of `mesh`'s), and the rows are gathered onto every rank in one
    process's order (COLLECTIVE); the seconds stay the rank's own."""
    dev = resolve_device(device)
    params, tp, mesh = eval_view(params, mesh)
    if use_tta:
        tta = make_tta_eval_step(cfg, num_tta, use_openmax=use_openmax, device=dev, tp=tp)
        generator = torch.Generator(device=dev).manual_seed(NOISE_SEED)
        step = lambda p, b: tta(p, b, generator)
    else:
        plain = make_eval_step(cfg.model, use_openmax=use_openmax, device=dev, tp=tp)
        step = lambda p, b: plain(p, b)[0]
    logits_all, labels_all, indices_all, seconds = [], [], [], []
    start = time.perf_counter()
    for batch, host in device_prefetch(loader.epoch(0), dev, skip=EVAL_HOST_KEYS):
        t0 = time.perf_counter()
        logits = step(params, batch).float().cpu().numpy().astype(np.float64)
        seconds.append(time.perf_counter() - t0)
        keep = host["example_mask"] > 0
        logits_all.append(logits[keep])
        labels_all.append(host["labels"][keep])
        indices_all.append(host["indices"][keep])
    rows = {
        "logits": (np.concatenate(logits_all) if logits_all
                   else np.zeros((0, cfg.model.num_labels))),
        "labels": np.concatenate(labels_all) if labels_all else np.zeros((0,), np.int64),
        "indices": np.concatenate(indices_all) if indices_all else np.zeros((0,), np.int32),
    }
    rows = gather_rows(rows, mesh, [len(x) for x in labels_all])
    return {**rows, "step_seconds": np.asarray(seconds),
            "pass_seconds": time.perf_counter() - start}


def place_on_mesh(params: dict, cfg: Config, device: torch.device, mesh=None):
    """(params, mesh): on one process the whole tree on `device` and no
    mesh; under a process group the tree laid out on `mesh` (cfg.mesh's
    when None) by the 'model' rule, each rank holding its shards, checked
    against the config's heads and widths (COLLECTIVE)."""
    params = tree_to(mh.host_replicated(params), device)
    if not mh.group_up():
        return params, None
    mesh = mesh or mesh_lib.mesh_from_config(cfg.mesh, device=device)
    tensor_lib.check_model_axis(cfg.model, mesh[mesh_lib.MODEL_AXIS].size())
    return mesh_lib.shard_params(params, mesh), mesh


def evaluate_manifest(params: dict, cfg: Config, manifest: str, *,
                      batch_size: int = 8, use_tta: bool = False,
                      num_tta: int = 5, calibrate: bool = False,
                      val_manifest: Optional[str] = None,
                      tokenizer: Optional[Tokenizer] = None,
                      verbose: bool = True, device: Device = None, mesh=None) -> Dict:
    """Score `manifest`: the JAX package's evaluate_manifest results, plus
    the scored pass's `step_seconds` and `pass_seconds`, the calibration
    pass's `calibration_step_seconds` and the WAV decoder the loader used.
    The parameters go to `device` once; under a process group they are laid
    out on `mesh` (cfg.mesh's by default) by the 'model' rule."""
    dev = resolve_device(device)
    tok = tokenizer or get_tokenizer(vocab_size=cfg.model.text.vocab_size)
    params, mesh = place_on_mesh(params, cfg, dev, mesh)
    Loader = mh.loader_class(mesh)

    optimal_temp = 1.0
    cal_seconds = np.zeros(0)
    if calibrate and val_manifest:
        val_loader = Loader(SERDataset(val_manifest, cfg.data),
                            batch_size=batch_size, tokenizer=tok, shuffle=False)
        # the calibration pass runs without OpenMax (the reference's eval.py:152)
        cal = collect_logits(params, cfg, val_loader, use_openmax=False, device=dev)
        optimal_temp = find_optimal_temperature(cal["logits"], cal["labels"])
        cal_seconds = cal["step_seconds"]
        if verbose:
            print(f"Optimal temperature: {optimal_temp:.3f}")

    loader = Loader(SERDataset(manifest, cfg.data),
                    batch_size=batch_size, tokenizer=tok, shuffle=False)
    out = collect_logits(params, cfg, loader, use_tta=use_tta, num_tta=num_tta,
                         use_openmax=True, device=dev)
    logits, labels = out["logits"], out["labels"]
    # Calibration scales the softmax inputs only: `logits` and the energy
    # OOD score stay raw (temperature-invariant). preds are the argmax of the
    # raw logits, the same as the scaled argmax for any T > 0.
    scaled = temperature_scaling(logits, optimal_temp) if calibrate else logits

    e = np.exp(scaled - scaled.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    preds = logits.argmax(axis=1)
    energies = om.energy_score(torch.from_numpy(logits)).numpy()

    C = cfg.model.num_labels
    names = SIX_NAMES[:C]
    f1 = M.weighted_f1(preds, labels, C)
    cm = M.confusion_matrix(labels, preds, C)
    maxp = probs.max(axis=1)
    results = {
        "weighted_f1": f1,
        "accuracy": M.accuracy(preds, labels),
        "uar": M.unweighted_average_recall(preds, labels, C),
        "temperature": optimal_temp,
        "energy_mean": float(energies.mean()) if len(energies) else 0.0,
        "energy_std": float(energies.std()) if len(energies) else 0.0,
        "confusion_matrix": cm.tolist(),
        "per_class_accuracy": {
            names[i]: float((preds[labels == i] == i).mean())
            for i in range(C) if (labels == i).any()},
        "confidence": {
            "mean": float(maxp.mean()) if len(maxp) else 0.0,
            "std": float(maxp.std()) if len(maxp) else 0.0,
            "high_gt_0.8": float((maxp > 0.8).mean()) if len(maxp) else 0.0,
            "low_lt_0.5": float((maxp < 0.5).mean()) if len(maxp) else 0.0},
        "logits": logits, "labels": labels, "preds": preds,
        "probs": probs, "energies": energies, "indices": out["indices"],
        "step_seconds": out["step_seconds"], "pass_seconds": out["pass_seconds"],
        "calibration_step_seconds": cal_seconds,
        "decoder": loader.decoder,
    }

    if verbose:
        print("\n" + "=" * 50 + "\nEVALUATION RESULTS\n" + "=" * 50)
        print(f"Weighted F1 Score: {f1:.4f}")
        print(f"Energy Score - Mean: {results['energy_mean']:.3f}, "
              f"Std: {results['energy_std']:.3f}")
        print(f"Temperature: {optimal_temp:.3f}")
        print("\nClassification Report:")
        print(M.classification_report(labels, preds, names))
        print("\nConfusion Matrix:")
        print(cm)
        print("\nPer-class Accuracy:")
        for k, v in results["per_class_accuracy"].items():
            print(f"  {k}: {v:.3f}")
        c = results["confidence"]
        print(f"\nConfidence Analysis:\n  Mean confidence: {c['mean']:.3f}"
              f"\n  Std confidence: {c['std']:.3f}"
              f"\n  High confidence (>0.8): {c['high_gt_0.8']:.3f}"
              f"\n  Low confidence (<0.5): {c['low_lt_0.5']:.3f}")
    return results


def write_predictions_jsonl(results: Dict, manifest: str, out_path: str) -> int:
    """Per-utterance predictions JSONL from an `evaluate_manifest` result:
    one line per scored clip, joined back to its manifest row through the
    loader's indices (the loader groups by duration, so eval order is not
    manifest order). Returns the number of lines written."""
    rows = manifest_lib.read_manifest(manifest)
    if len(results["preds"]) and len(results["indices"]) != len(results["preds"]):
        raise ValueError(
            "results carry no per-example manifest indices; the loader "
            "must emit 'indices' to join predictions back to manifest rows")
    names = SIX_NAMES[:results["probs"].shape[1]] if len(results["probs"]) else SIX_NAMES
    n = 0
    with open(out_path, "w") as f:
        for i in range(len(results["preds"])):
            idx = int(results["indices"][i])
            row = rows[idx] if 0 <= idx < len(rows) else {}
            p = results["probs"][i]
            pred = int(results["preds"][i])
            rec = {
                "index": idx,
                "audio": row.get("audio"),
                "dataset": row.get("dataset"),
                "label": int(results["labels"][i]),
                "prediction": pred,
                "emotion": names[pred] if pred < len(names) else str(pred),
                "probabilities": {names[j] if j < len(names) else str(j):
                                  round(float(p[j]), 6) for j in range(len(p))},
                "confidence": round(float(p.max()), 6),
                "energy": round(float(results["energies"][i]), 6),
                "correct": bool(results["preds"][i] == results["labels"][i]),
            }
            f.write(json.dumps(rec) + "\n")
            n += 1
    return n

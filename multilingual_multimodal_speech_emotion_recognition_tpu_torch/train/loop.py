"""The training loop, on one card or one rank per card.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
train/loop.py, with the reference's flow (train.py:26-263): manifest
datasets, per-group AdamW with warmup-cosine (or restarts), online
augmentation in the step, a weighted-F1 validation pass per epoch, a
checkpoint per epoch named epoch_{e}_f1_{f1:.4f} with the optimizer state
(the backbones deduplicated into one frozen store while they are frozen),
resume, early stopping, a resumable checkpoint on SIGTERM and the Weibull
fit on the validation features after the last epoch, into the final and
the best checkpoint. `pretrained` Hugging Face state dicts replace the
fresh backbones (models/model.py:load_pretrained_backbones).

Under a process group (parallel/multihost.initialize: torchrun, or the
train CLI's multi-host flags) the loop takes the JAX package's pod
branches: the ('data', 'model') mesh of cfg.mesh, the parameters sharded on
it after init and after a resume (parallel/mesh.shard_params: the 'model'
rule, FSDP by cfg.mesh.fsdp), the batch sharded on 'data'
(TrainConfig.batch_size is the global batch; each data shard decodes its
share, HostShardedLoader on 'data''s rank and size, and the ranks of a
'model' group the same rows), the step and the validation and Weibull
passes tensor-parallel over the 'model' group (parallel/tensor.py), the
metrics JSONL, the progress lines and the checkpoints (gathered whole) on
rank 0 alone, the validation and Weibull passes' logits, labels and
features gathered over 'data' onto every rank (allgather_rows), so every
rank computes the same F1 and the same fit, and the SIGTERM flag agreed by
every rank (any_process) before any acts on it.

The validation pass and the Weibull fit's feature pass are the eval
forward under torch.inference_mode(), so they run the classifier's kernel
(ops/residual_stack.py) on the card; the train step takes the plain stack.
Each step's randomness is seeded from (TrainConfig.seed, global step), so
a resumed run draws what the straight run drew. The loop reads the card
every 50 steps (the logged metrics) and once per epoch (the mean loss).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..config import Config, to_json
from ..data.pipeline import EVAL_HOST_KEYS, TRAIN_HOST_KEYS, BucketedLoader, SERDataset
from ..data.prefetch import device_prefetch
from ..data.tokenizer import Tokenizer, get_tokenizer
from ..eval.evaluate import eval_view, gather_rows, make_eval_step
from ..models import model as mdl
from ..ops import openmax as om
from ..parallel import mesh as mesh_lib
from ..parallel import multihost as mh
from ..parallel.tensor import check_model_axis
from ..utils.metrics import MetricsWriter, weighted_f1
from ..utils.runtime import map_leaves, resolve_device
from . import checkpoint as ckpt_lib
from . import optimizer as opt_lib
from . import train_step as ts

Device = Optional[Union[str, torch.device]]
LOG_EVERY = 50


def step_seed(seed: int, step: int) -> int:
    """The seed of global step `step`'s generators."""
    return (seed * 2 ** 32 + step) % 2 ** 63


class _NullWriter:
    """The metrics sink of the ranks other than 0 (rank 0 owns the JSONL;
    every rank builds the same records, so their host reads stay in step)."""

    def write(self, *_a, **_k):
        pass


def evaluate(params: dict, cfg: Config, loader: BucketedLoader, *,
             collect_features: bool = False, use_openmax: bool = False,
             device: Device = None) -> Dict[str, np.ndarray]:
    """The eval pass over the loader's epoch 0: logits, labels and preds
    of the real rows (and the penultimate features), as numpy arrays.
    Sharded parameters run the tensor-parallel forward on this rank's view
    (eval/evaluate.eval_view). Under a group each data shard runs its
    loader's rows and the results are gathered over 'data' onto every rank
    in one process's order (COLLECTIVE)."""
    dev = resolve_device(device)
    params, tp, mesh = eval_view(params)
    step = make_eval_step(cfg.model, use_openmax=use_openmax, device=dev, tp=tp)
    logits_all, labels_all, feats_all = [], [], []
    for batch, host in device_prefetch(loader.epoch(0), dev, skip=EVAL_HOST_KEYS):
        logits, feats, _ = step(params, batch)
        keep = host["example_mask"] > 0
        logits_all.append(logits.float().cpu().numpy()[keep])
        labels_all.append(host["labels"][keep])
        if collect_features:
            feats_all.append(feats.float().cpu().numpy()[keep])
    logits = (np.concatenate(logits_all) if logits_all
              else np.zeros((0, cfg.model.num_labels), np.float32))
    labels = np.concatenate(labels_all) if labels_all else np.zeros((0,), np.int32)
    per_batch = [len(x) for x in labels_all]
    out = gather_rows({"logits": logits, "labels": labels}, mesh, per_batch)
    logits = out["logits"]
    out["preds"] = logits.argmax(-1) if len(logits) else np.zeros((0,), np.int64)
    if collect_features:
        # every rank has batches here or none does: the loaders share one plan
        out["features"] = (gather_rows({"f": np.concatenate(feats_all)}, mesh,
                                       per_batch)["f"] if feats_all else None)
    return out


class PreemptionGuard:
    """SIGTERM handler that only sets a flag; the loop polls it after each
    step and writes a resumable checkpoint before it returns. Off the main
    thread it installs nothing and only polls."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = signals
        self._prev = {}
        self.triggered = False

    def _handler(self, signum, frame):
        self.triggered = True

    def __enter__(self):
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:      # not the main thread: poll-only
                pass
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}
        return False


def train_mesh(mcfg, device: torch.device, *model_cfgs):
    """The mesh of `mcfg` (a config.MeshConfig) when a process group is up,
    one rank included (the pod branches), else None. A 'model' axis that
    does not divide the heads, FFN widths or positional-conv groups of each
    of `model_cfgs` (the models the run splits) raises, naming the leaf
    (parallel/tensor.check_model_axis)."""
    if not mh.group_up():
        return None
    for model_cfg in model_cfgs:
        check_model_axis(model_cfg, mcfg.model_axis)
    return mesh_lib.mesh_from_config(mcfg, device=device)



def train(cfg: Config, *, train_manifest: str, val_manifest: str,
          tokenizer: Optional[Tokenizer] = None,
          pretrained: Optional[Dict] = None,
          initial_params: Optional[dict] = None,
          log_path: Optional[str] = None, progress: bool = True,
          guard: Optional[PreemptionGuard] = None, device: Device = None) -> Dict:
    """Train by cfg.train; returns {"params", "opt_state", "history",
    "best_f1", "final_f1", "preempted"} (and "checkpoint" when preempted).
    The card unless `device` says otherwise. `initial_params` (e.g. phase
    1's) is copied to the device; the run updates its own copy. Otherwise
    the parameters are drawn from tcfg.seed, with the backbones of
    `pretrained` ({"wav2vec2_state": ..., "xlmr_state": ...}, Hugging Face
    state dicts) in place of fresh ones."""
    tcfg = cfg.train
    dev = resolve_device(device)
    tok = tokenizer or get_tokenizer(vocab_size=cfg.model.text.vocab_size)
    save_root = Path(tcfg.save_dir)
    mesh = train_mesh(cfg.mesh, dev, cfg.model)
    progress = progress and mh.is_coordinator()
    writer = (MetricsWriter(log_path or str(save_root / "metrics.jsonl"))
              if mh.is_coordinator() else _NullWriter())
    Loader = mh.loader_class(mesh)
    train_loader = Loader(SERDataset(train_manifest, cfg.data),
                          batch_size=tcfg.batch_size, tokenizer=tok,
                          shuffle=True, seed=tcfg.seed, drop_remainder=True)
    val_loader = Loader(SERDataset(val_manifest, cfg.data),
                        batch_size=tcfg.batch_size, tokenizer=tok,
                        shuffle=False, seed=0)

    def shard(p: dict) -> dict:
        if mesh is None:
            return p
        return mesh_lib.shard_params(p, mesh, fsdp=cfg.mesh.fsdp,
                                     fsdp_min_size=cfg.mesh.fsdp_min_size)

    if initial_params is not None:
        params = map_leaves(mh.host_replicated(initial_params),
                            lambda _, t: t.to(dev, copy=True))
    else:
        params = mdl.init_model(cfg.model, torch.Generator(device=dev).manual_seed(tcfg.seed),
                                device=dev)
        if pretrained:
            params = mdl.load_pretrained_backbones(params, **pretrained)
    params = shard(params)

    steps_per_epoch = max(1, train_loader.batches_per_epoch())
    optimizer = opt_lib.make_train_optimizer(
        params, lr=tcfg.lr, total_steps=steps_per_epoch * tcfg.epochs,
        warmup_ratio=tcfg.warmup_ratio, scheduler=tcfg.scheduler,
        restart_steps=steps_per_epoch * tcfg.restart_period_epochs,
        freeze_backbones=tcfg.freeze_backbones, grad_clip=tcfg.grad_clip,
        backbone_moment_dtype=(getattr(torch, tcfg.backbone_moment_dtype)
                               if tcfg.backbone_moment_dtype else None))
    opt_state = optimizer.init(params)

    start_epoch, global_step = 0, 0
    if tcfg.resume_from:
        params, meta = ckpt_lib.restore_checkpoint(tcfg.resume_from, device=dev)
        params = shard(params)
        restored = ckpt_lib.restore_opt_state(tcfg.resume_from, device=dev)
        if restored is not None:
            if set(restored["mu"]) != set(opt_state["mu"]):
                raise ValueError(f"{tcfg.resume_from}: its optimizer state does not "
                                 "match this run's trainable parameters")
            # the moments onto the fresh state's layout (sharded under FSDP)
            opt_state = restored if mesh is None else mesh_lib.shard_like(restored, opt_state)
        start_epoch = int(meta.get("epoch", -1)) + 1
        global_step = int(meta.get("step", 0))
        if progress:
            print(f"Resumed from {tcfg.resume_from} at epoch {start_epoch}")

    step_fn = ts.make_train_step(cfg.model, tcfg, optimizer, device=dev)

    def save(path: Path, p: dict, o: dict, **meta) -> None:
        ckpt_lib.save_checkpoint(path, params=p, opt_state=o, **meta,
                                 config_json=to_json(cfg),
                                 dedup_frozen=tcfg.freeze_backbones,
                                 frozen_store=save_root / "frozen_store")

    def fit_weibull_into(p: dict) -> dict:
        """The Weibull fit on the validation features (train.py:204-245),
        written into p's classifier; p as it was when the set is empty."""
        ev = evaluate(p, cfg, val_loader, collect_features=True, device=dev)
        if ev["features"] is None or not len(ev["features"]):
            return p
        weibull = om.fit_weibull(torch.from_numpy(ev["features"]).to(dev),
                                 torch.from_numpy(ev["labels"]).to(dev), cfg.model.num_labels)
        p["classifier"]["weibull"] = (weibull if mesh is None else mesh_lib.shard_like(
            weibull, p["classifier"]["weibull"]))
        return p

    best_f1, best_epoch, history = -1.0, -1, []
    best_path: Optional[Path] = None
    last_path: Optional[Path] = None
    last_meta: Dict = {}
    f1 = 0.0
    guard = guard or PreemptionGuard()
    guard.__enter__()
    try:
        for epoch in range(start_epoch, tcfg.epochs):
            t0 = time.time()
            losses = []
            t_window, n_window = time.time(), 0
            for batch, _ in device_prefetch(train_loader.epoch(epoch), dev,
                                            skip=TRAIN_HOST_KEYS):
                if mesh is not None:
                    batch = mesh_lib.shard_batch(batch, mesh)
                metrics = step_fn(params, opt_state, batch, step_seed(tcfg.seed, global_step))
                global_step += 1
                n_window += 1
                if mesh is not None:
                    # every rank agrees on the flag before any acts on it: a
                    # rank alone in the checkpoint's collectives would wait
                    # for ranks still in the step's
                    guard.triggered = mh.any_process(guard.triggered)
                if guard.triggered:
                    break
                losses.append(metrics.loss)
                if global_step % LOG_EVERY == 0:
                    now = time.time()
                    writer.write({"kind": "step", "step": global_step, "epoch": epoch,
                                  "loss": float(metrics.loss), "ce": float(metrics.ce),
                                  "focal": float(metrics.focal),
                                  "accuracy": float(metrics.accuracy),
                                  "utt_per_sec": n_window * tcfg.batch_size
                                  / max(now - t_window, 1e-9)})
                    t_window, n_window = time.time(), 0
                    if progress:
                        print(f"epoch {epoch} step {global_step} "
                              f"loss {float(metrics.loss):.4f}")
            if guard.triggered:
                # a resumable checkpoint at the last completed step; epoch - 1
                # in its meta makes --resume_from run the interrupted epoch
                # again, with the step count and optimizer state carried on
                pre_path = save_root / f"preempt_step_{global_step}"
                save(pre_path, params, opt_state, step=global_step, epoch=epoch - 1,
                     f1=max(best_f1, 0.0))
                writer.write({"kind": "preempt", "step": global_step, "epoch": epoch,
                              "checkpoint": str(pre_path)})
                if progress:
                    print(f"Preemption signal: saved {pre_path} at step {global_step}, "
                          "exiting")
                last_path = pre_path
                break

            train_loss = float(torch.stack(losses).mean()) if losses else 0.0
            ev = evaluate(params, cfg, val_loader, device=dev)
            f1 = weighted_f1(ev["preds"], ev["labels"], cfg.model.num_labels)
            dt = time.time() - t0
            history.append({"epoch": epoch, "train_loss": train_loss, "val_f1": f1,
                            "seconds": dt})
            writer.write({"kind": "epoch", **history[-1], "step": global_step})
            if progress:
                print(f"Epoch {epoch} F1: {f1:.4f} (loss {train_loss:.4f}, {dt:.1f}s)")

            last_path = save_root / f"epoch_{epoch}_f1_{f1:.4f}"
            last_meta = {"step": global_step, "epoch": epoch, "f1": f1}
            save(last_path, params, opt_state, **last_meta)

            if f1 > best_f1:
                best_f1, best_epoch, best_path = f1, epoch, last_path
            elif (tcfg.early_stop_patience is not None
                  and epoch - best_epoch >= tcfg.early_stop_patience):
                if progress:
                    print(f"Early stopping at epoch {epoch} (best {best_f1:.4f} "
                          f"@ {best_epoch})")
                break
    finally:
        guard.__exit__()
    if guard.triggered:
        # no validation pass on preemption: the resumed run fits the Weibull
        return {"params": params, "opt_state": opt_state, "history": history,
                "best_f1": best_f1, "final_f1": f1, "preempted": True,
                "checkpoint": str(last_path)}

    # the Weibull fit runs after the last executed epoch (train.py:204-245),
    # and the best checkpoint gets its own: OpenMax with the zero defaults
    # would scale every input's logits
    params = fit_weibull_into(params)
    if last_path is not None:
        save(last_path, params, opt_state, **last_meta)
    if best_path is not None and best_path != last_path:
        b_params, b_meta = ckpt_lib.restore_checkpoint(best_path, device=dev)
        b_opt = ckpt_lib.restore_opt_state(best_path, device=dev)
        save(best_path, fit_weibull_into(shard(b_params)), b_opt,
             step=int(b_meta.get("step", 0)), epoch=int(b_meta.get("epoch", 0)),
             f1=float(b_meta.get("f1", 0.0)))
    return {"params": params, "opt_state": opt_state, "history": history,
            "best_f1": best_f1, "final_f1": f1, "preempted": False}


def phase2_grad_accum(batch_size: int, grad_accum: int, max_microbatch: int = 64) -> int:
    """The smallest grad_accum >= the configured one that divides
    batch_size and keeps the unfrozen microbatch <= max_microbatch: phase 2
    raises accumulation instead of inheriting phase 1's frozen, memory-cheap
    whole batch. Accumulation changes memory and speed, not the update.
    A grad_accum above batch_size divides nothing and raises (the JAX
    package's loop never ends there)."""
    if grad_accum > batch_size:
        raise ValueError(f"grad_accum {grad_accum} exceeds batch_size {batch_size}")
    accum = max(grad_accum, -(-batch_size // max_microbatch))
    while batch_size % accum:
        accum += 1
    return accum


def train_two_phase(cfg: Config, *, train_manifest: str, val_manifest: str,
                    phase1_epochs: int = 3, phase2_epochs: int = 2,
                    phase1_lr: float = 5e-4, phase2_lr: float = 1e-5,
                    tokenizer: Optional[Tokenizer] = None,
                    pretrained: Optional[Dict] = None,
                    progress: bool = True, device: Device = None) -> Dict:
    """Phase 1 trains the heads with frozen backbones at phase1_lr; phase 2
    unfreezes the backbones and fine-tunes everything at phase2_lr (the
    intent of the reference's train_two_phase.py). Phase 1 starts from the
    `pretrained` backbones where given. Each phase writes its
    checkpoints under save_dir/phase{1,2}; phase 2 starts from a copy of
    phase 1's parameters, with grad_accum raised by phase2_grad_accum."""
    base = Path(cfg.train.save_dir)
    cfg1 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=phase1_epochs, lr=phase1_lr, freeze_backbones=True,
        save_dir=str(base / "phase1")))
    r1 = train(cfg1, train_manifest=train_manifest, val_manifest=val_manifest,
               tokenizer=tokenizer, pretrained=pretrained, progress=progress, device=device)
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=phase2_epochs, lr=phase2_lr, freeze_backbones=False,
        save_dir=str(base / "phase2"),
        grad_accum=phase2_grad_accum(cfg.train.batch_size, cfg.train.grad_accum)))
    r2 = train(cfg2, train_manifest=train_manifest, val_manifest=val_manifest,
               tokenizer=tokenizer, initial_params=r1["params"], progress=progress,
               device=device)
    return {"phase1": r1, "phase2": r2, "params": r2["params"],
            "best_f1": max(r1["best_f1"], r2["best_f1"])}

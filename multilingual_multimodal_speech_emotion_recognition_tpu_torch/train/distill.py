"""Knowledge distillation: train a small student from a flagship teacher.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
train/distill.py. The reference has no deployment-scale story beyond its
~380M-parameter two-backbone pipeline; this module distills the trained
flagship into a small randomly-initialized student (Hinton-style soft
targets + hard labels, optional pooled-feature matching), producing an
ordinary checkpoint of the port — the student's config rides in the
checkpoint, so every downstream surface (the eval CLI, the interface, the
export, the serving daemon, int8 quant) works on it unchanged.

One step runs the teacher's eval forward under torch.no_grad() (JAX's
stop_gradient), so its classifier runs the kernel on the card, then the
student's training forward (the plain classifier stack) and the update.
The validation pass after each epoch is train/loop.evaluate: the eval
forward, so the student's classifier runs the kernel too.

Loss (per example, mean over the batch):
  alpha * tau^2 * KL(softmax(t/tau) || softmax(s/tau))   soft targets
  + (1 - alpha) * CE_label_smoothed(s, y)                 hard labels
  + feature_match_weight * MSE(P(fused_s), fused_t)       optional,
    P a learned [student proj_dim -> teacher proj_dim] linear that lives
    only during distillation (stripped from the saved checkpoint).
The tau^2 factor keeps soft-target gradient magnitude independent of
temperature (Hinton et al., 2015).

Each step's dropout is drawn from a torch.Generator on the device seeded
from (TrainConfig.seed, global step), as the train loop's steps are.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, Optional, Union

import torch

from ..config import Config, ModelConfig, TrainConfig, to_json
from ..data.pipeline import TRAIN_HOST_KEYS, BucketedLoader, SERDataset
from ..data.prefetch import device_prefetch
from ..data.tokenizer import Tokenizer, get_tokenizer
from ..models import layers, model as mdl
from ..ops import losses
from ..utils.metrics import MetricsWriter, weighted_f1
from ..utils.runtime import map_leaves, params_on, resolve_device, to_device, tree_to
from . import checkpoint as ckpt_lib, loop as loop_lib, optimizer as opt_lib

Device = Optional[Union[str, torch.device]]


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    temperature: float = 4.0
    alpha: float = 0.9               # soft-target weight; 1-alpha on CE
    feature_match_weight: float = 0.0
    student_preset: str = "small"


STUDENT_PRESETS = ("small", "tiny")


def student_model_config(teacher: ModelConfig,
                         preset: str = "small") -> ModelConfig:
    """A scaled-down ModelConfig that keeps every interface the teacher's
    batches need (tokenizer vocab, front-end flags, label count) while
    shrinking the compute. 'small' is 119M params vs the flagship's 397M
    — 96M of that is the shared 250k-vocab embedding table, so the actual
    per-clip COMPUTE shrinks ~10x; 'tiny' is for tests/edge serving."""
    if preset == "small":
        audio = dataclasses.replace(
            teacher.audio, conv_dim=(256,) * 7, hidden_size=384,
            num_hidden_layers=6, num_attention_heads=6,
            intermediate_size=1536, num_conv_pos_embeddings=64,
            num_conv_pos_embedding_groups=8)
        text = dataclasses.replace(
            teacher.text, hidden_size=384, num_hidden_layers=4,
            num_attention_heads=6, intermediate_size=1536)
        head_kw = dict(adapter_dim=128, shared_dim=128, num_heads=4,
                       proj_dim=256, classifier_layers=8,
                       classifier_base_dim=256)
    elif preset == "tiny":
        audio = dataclasses.replace(
            teacher.audio, conv_dim=(64,) * len(teacher.audio.conv_dim),
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4)
        text = dataclasses.replace(
            teacher.text, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128)
        head_kw = dict(adapter_dim=16, shared_dim=32, num_heads=4,
                       proj_dim=64, classifier_layers=3,
                       classifier_base_dim=64)
    else:
        raise ValueError(f"unknown student preset {preset!r}; "
                         f"choose from {STUDENT_PRESETS}")
    return dataclasses.replace(teacher, audio=audio, text=text, **head_kw)


def _kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
             tau: float) -> torch.Tensor:
    """tau^2 * KL(teacher_soft || student_soft), mean over the batch, in
    f32. Train batches are always full (drop_remainder=True; example_mask
    is a host-only key, pipeline.TRAIN_HOST_KEYS), so the plain mean is the
    masked mean."""
    t = torch.log_softmax(teacher_logits.float() / tau, dim=-1)
    s = torch.log_softmax(student_logits.float() / tau, dim=-1)
    kl = (torch.exp(t) * (t - s)).sum(-1)                      # [B]
    return tau * tau * kl.mean()


def distill_loss(params: dict, teacher_params: dict, batch: dict,
                 generator: torch.Generator, *, teacher_cfg: ModelConfig,
                 student_cfg: ModelConfig, tcfg: TrainConfig, dcfg: DistillConfig):
    """(loss, metrics) of one batch on the batch's device: the teacher's
    eval forward under torch.no_grad(), the student's training forward
    with dropout from `generator`, and the loss of the module docstring.
    The metrics are detached 0-dim tensors."""
    with torch.no_grad():
        t_out = mdl.model_forward(teacher_params, teacher_cfg, batch, deterministic=True)
    t_logits, t_fused = t_out.logits, t_out.fused
    s_out = mdl.model_forward(params, student_cfg, batch, deterministic=False,
                              generator=generator)
    labels = batch["labels"].long()
    kd = _kd_loss(s_out.logits, t_logits, dcfg.temperature)
    ce = losses.label_smoothing_cross_entropy(
        s_out.logits, labels, smoothing=tcfg.label_smoothing)
    loss = dcfg.alpha * kd + (1.0 - dcfg.alpha) * ce
    fm = torch.zeros((), device=loss.device)
    if dcfg.feature_match_weight > 0:
        proj = layers.linear(params["distill_proj"], s_out.fused.float())
        fm = (proj - t_fused.float()).square().mean()
        loss = loss + dcfg.feature_match_weight * fm
    s_pred = s_out.logits.detach().argmax(-1)
    return loss, {"loss": loss.detach(), "kd": kd.detach(), "ce": ce.detach(),
                  "feature_match": fm.detach(),
                  "teacher_agreement": (s_pred == t_logits.argmax(-1)).float().mean(),
                  "accuracy": (s_pred == labels).float().mean()}


def make_distill_step(teacher_cfg: ModelConfig, student_cfg: ModelConfig,
                      tcfg: TrainConfig, dcfg: DistillConfig,
                      optimizer: opt_lib.AdamW, *, device: Device = None):
    """step(params, teacher_params, opt_state, batch, seed) -> metrics (a
    dict of 0-dim tensors on the device): the teacher's inference and one
    update of the student's parameters and opt_state, in place. `seed`
    (an int) seeds the step's dropout generator."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    cfgs = dict(teacher_cfg=teacher_cfg, student_cfg=student_cfg, tcfg=tcfg, dcfg=dcfg)

    def step(params: dict, teacher_params: dict, opt_state: dict, batch: dict,
             seed: int) -> Dict[str, torch.Tensor]:
        params_on(params, dev)
        params_on(teacher_params, dev)
        batch = {k: to_device(v, dev) for k, v in batch.items()}
        generator.manual_seed(seed)
        paths = [p for p, _ in optimizer.trainable(params)]
        wanted, leaves = set(paths), {}

        def alias(path, t):
            if path not in wanted:
                return t
            leaves[path] = t.detach().requires_grad_(True)
            return leaves[path]

        loss, metrics = distill_loss(map_leaves(params, alias), teacher_params, batch,
                                     generator, **cfgs)
        grads = torch.autograd.grad(loss, [leaves[p] for p in paths], allow_unused=True,
                                    materialize_grads=True)
        optimizer.apply_(params, dict(zip(paths, grads)), opt_state)
        return metrics

    return step


def distill(teacher_params: Dict, teacher_cfg: Config, *,
            train_manifest: str, val_manifest: str,
            dcfg: DistillConfig = DistillConfig(),
            train_cfg: Optional[TrainConfig] = None,
            tokenizer: Optional[Tokenizer] = None,
            progress: bool = True, device: Device = None) -> Dict:
    """Run distillation on `device` (the card unless the caller names
    another); returns {'params', 'config', 'history', 'best_f1',
    'best_path'}. The saved checkpoints are ordinary checkpoints of
    the STUDENT (its config embedded), loadable by every serving surface."""
    dev = resolve_device(device)
    tcfg = train_cfg or teacher_cfg.train
    student_mcfg = student_model_config(teacher_cfg.model,
                                        dcfg.student_preset)
    student_cfg = dataclasses.replace(teacher_cfg, model=student_mcfg,
                                      train=tcfg)
    tok = tokenizer or get_tokenizer(
        vocab_size=student_mcfg.text.vocab_size)

    train_loader = BucketedLoader(SERDataset(train_manifest, teacher_cfg.data),
                                  batch_size=tcfg.batch_size, tokenizer=tok,
                                  shuffle=True, seed=tcfg.seed,
                                  drop_remainder=True)
    val_loader = BucketedLoader(SERDataset(val_manifest, teacher_cfg.data),
                                batch_size=tcfg.batch_size, tokenizer=tok,
                                shuffle=False, seed=0)

    generator = torch.Generator(device=dev).manual_seed(tcfg.seed)
    params = mdl.init_model(student_mcfg, generator, device=dev)
    if dcfg.feature_match_weight > 0:
        params["distill_proj"] = layers.init_linear(
            layers.Init(generator, dev), student_mcfg.proj_dim,
            teacher_cfg.model.proj_dim)
    teacher_params = tree_to(teacher_params, dev)

    steps_per_epoch = max(1, train_loader.batches_per_epoch())
    optimizer = opt_lib.make_train_optimizer(
        params, lr=tcfg.lr, total_steps=steps_per_epoch * tcfg.epochs,
        warmup_ratio=tcfg.warmup_ratio, scheduler=tcfg.scheduler,
        restart_steps=steps_per_epoch * tcfg.restart_period_epochs,
        freeze_backbones=False,  # the student trains end-to-end
        grad_clip=tcfg.grad_clip)
    opt_state = optimizer.init(params)
    step_fn = make_distill_step(teacher_cfg.model, student_mcfg, tcfg, dcfg,
                                optimizer, device=dev)

    writer = MetricsWriter(str(Path(tcfg.save_dir) / "distill_metrics.jsonl"))
    history, best_f1, best_path = [], -1.0, None
    global_step = 0

    for epoch in range(tcfg.epochs):
        t0 = time.time()
        last_aux = None
        for batch, _ in device_prefetch(train_loader.epoch(epoch), dev,
                                        skip=TRAIN_HOST_KEYS):
            last_aux = step_fn(params, teacher_params, opt_state, batch,
                               loop_lib.step_seed(tcfg.seed, global_step))
            global_step += 1

        ev = loop_lib.evaluate(params, student_cfg, val_loader, device=dev)
        f1 = weighted_f1(ev["preds"], ev["labels"],
                         student_mcfg.num_labels)
        aux_host = {k: float(v) for k, v in (last_aux or {}).items()}
        rec = {"epoch": epoch, "val_f1": float(f1),
               "epoch_seconds": round(time.time() - t0, 2), **aux_host}
        history.append(rec)
        writer.write(rec)
        if progress:
            print(f"[distill] epoch {epoch}: f1={f1:.4f} "
                  f"kd={aux_host.get('kd', 0):.4f} "
                  f"agree={aux_host.get('teacher_agreement', 0):.3f}")

        if f1 >= best_f1:
            best_f1 = f1
            save_params = {k: v for k, v in params.items()
                           if k != "distill_proj"}
            best_path = ckpt_lib.save_checkpoint(
                Path(tcfg.save_dir) / f"student_epoch_{epoch}",
                params=save_params, step=(epoch + 1) * steps_per_epoch,
                epoch=epoch, f1=float(f1),
                config_json=to_json(student_cfg))

    return {"params": params, "config": student_cfg, "history": history,
            "best_f1": best_f1, "best_path": str(best_path)}

"""Per-group AdamW and its learning-rate schedules, in plain PyTorch.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
train/optimizer.py, which builds optax.multi_transform over one adamw a
group. The groups and their (lr multiplier, weight decay) are the
reference's (train.py:72-83): encoders x0.1 / 0.025, cross-attention,
pooling and fusion x1 / 0.05, deep classifier x1.5 / 0.06, anchors x2 /
0.04, uncertainty head x1 / 0.05, prototypes x1 / 0.05. Frozen leaves (the
backbones under freeze_backbones, and the classifier's Weibull state,
which only the fit writes) get no update and no state.

`AdamW.apply_` follows optax's arithmetic over torch._foreach_* lists, one
set of calls a group:
  * clip_by_global_norm over every gradient first (grad_clip);
  * mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2;
  * the bias corrections with the count after the increment;
  * update = mu_hat / (sqrt(nu_hat) + eps) + wd * p, eps outside the sqrt,
    weight decay on every leaf of the group;
  * p -= lr(count) * update, the schedule at the count before the
    increment;
  * with backbone_moment_dtype, the audio and text groups keep mu in that
    dtype (bf16): b1 mu is taken in bf16 with b1 rounded to bf16, as
    optax takes it, the rest of the update in f32, and mu stored back.
A step is applied only where `ok` (a 0-dim bool tensor on the card) holds:
the moments move by (1 - b) * ok * (g - m), the parameters by lr * ok *
update and the count by ok, so a skipped step leaves all of them as they
were without reading anything back from the card.

The state is {"count": int32 [], "mu": {path: tensor}, "nu": {path:
tensor}} over the trainable leaves, keyed by their "/"-joined paths; it is
what train/checkpoint.py saves.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from ..utils.runtime import leaves_with_paths, map_leaves

Tensor = torch.Tensor
Step = Union[int, float, Tensor]


def _step_f32(step: Step) -> Tensor:
    if isinstance(step, Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine_schedule(base_lr: float, total_steps: int,
                           warmup_ratio: float = 0.1) -> Callable[[Step], Tensor]:
    """Linear warmup from 0, then a cosine to 0 (the reference's
    train.py:114-121 LambdaLR), in f32 on the step's device."""
    warmup_steps = int(total_steps * warmup_ratio)

    def sched(step: Step) -> Tensor:
        step = _step_f32(step)
        warm = step / max(1, warmup_steps)
        progress = (step - warmup_steps) / max(1, total_steps - warmup_steps)
        cos = 0.5 * (1.0 + torch.cos(progress * math.pi))
        return base_lr * torch.where(step < warmup_steps, warm, cos)

    return sched


def warmup_cosine_restarts_schedule(base_lr: float, first_cycle_steps: int,
                                    warmup_steps: int = 0, min_lr_ratio: float = 0.0,
                                    gamma: float = 1.0) -> Callable[[Step], Tensor]:
    """Cosine annealing with warm restarts (train_crema.py:45-69): cycles of
    a fixed length, a warmup in each, the amplitude decayed by gamma a
    cycle."""

    def sched(step: Step) -> Tensor:
        step = _step_f32(step)
        cycle = torch.floor(step / first_cycle_steps)
        in_cycle = step - cycle * first_cycle_steps
        amp = base_lr * torch.pow(gamma, cycle)
        progress = (in_cycle - warmup_steps) / max(1, first_cycle_steps - warmup_steps)
        cos = min_lr_ratio + (1 - min_lr_ratio) * 0.5 * (1 + torch.cos(progress * math.pi))
        if warmup_steps > 0:
            return amp * torch.where(in_cycle < warmup_steps,
                                     in_cycle / max(1, warmup_steps), cos)
        return amp * cos

    return sched


# group name -> (lr multiplier, weight decay); the reference's train.py:72-83
GROUPS = {
    "audio": (0.1, 0.025),
    "text": (0.1, 0.025),
    "mid": (1.0, 0.05),       # cross, pool_a, pool_t, fusion
    "deep": (1.5, 0.06),      # deep classifier backbone + output head
    "anchor": (2.0, 0.04),
    "uncertainty": (1.0, 0.05),
    "proto": (1.0, 0.05),
}
FROZEN = "frozen"

_AUDIO = ("audio_adapter", "combined_fusion", "quality_fusion", "conditioning_fusion",
          "quality_proj", "cond_proj")
_TEXT = ("text_adapter", "asr_fusion", "asr_proj")
_CLASSIFIER = {"anchor": "anchor", "uncertainty": "uncertainty", "weibull": FROZEN}


def param_labels(params: dict, *, freeze_backbones: bool = True) -> dict:
    """The params tree with each leaf replaced by its group's name. The
    front-end feature projections and fusions ride the encoder groups, as
    they live inside the reference's encoder modules; `asr_proj` goes with
    the text group (the reference creates it after its optimizer, so never
    trains it: a documented divergence of the JAX package)."""
    def label_top(name: str, sub):
        if name == "audio_backbone":
            g = FROZEN if freeze_backbones else "audio"
        elif name == "text_backbone":
            g = FROZEN if freeze_backbones else "text"
        elif name in _AUDIO:
            g = "audio"
        elif name in _TEXT:
            g = "text"
        elif name == "prototypes":
            g = "proto"
        elif name == "classifier":
            return {k: map_leaves(v, lambda _p, _t, k=k: _CLASSIFIER.get(k, "deep"))
                    for k, v in sub.items()}
        else:
            g = "mid"   # cross, pool_a, pool_t, fusion
        return map_leaves(sub, lambda _p, _t: g)

    return {k: label_top(k, v) for k, v in params.items()}


class AdamW:
    """AdamW with a schedule and a weight decay per group (see the module
    docstring). `labels` is `param_labels` of the tree it steps; `groups`
    maps each group name to its (lr multiplier, weight decay), GROUPS by
    default (the multiplier is the schedules' to apply)."""

    def __init__(self, labels: dict, schedules: Dict[str, Callable[[Step], Tensor]], *,
                 grad_clip: Optional[float] = None,
                 backbone_moment_dtype: Optional[torch.dtype] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 groups: Dict[str, Tuple[float, float]] = GROUPS):
        self.labels = dict(leaves_with_paths(labels))
        self.schedules = schedules
        self.grad_clip = grad_clip
        self.groups = groups
        self.mu_dtypes = {g: (backbone_moment_dtype if backbone_moment_dtype is not None
                              and g in ("audio", "text") else torch.float32)
                          for g in groups}
        self.b1, self.b2, self.eps = b1, b2, eps

    def trainable(self, params: dict) -> List[Tuple[str, Tensor]]:
        """(path, leaf) of every leaf a group updates, in the tree's order."""
        out = []
        for path, leaf in leaves_with_paths(params):
            label = self.labels.get(path)
            if label is None:
                raise KeyError(f"AdamW: no group for the parameter {path}")
            if label != FROZEN:
                out.append((path, leaf))
        return out

    def init(self, params: dict) -> dict:
        mu, nu = {}, {}
        for path, leaf in self.trainable(params):
            mu[path] = torch.zeros_like(leaf, dtype=self.mu_dtypes[self.labels[path]])
            nu[path] = torch.zeros_like(leaf, dtype=torch.float32)
        device = next(iter(nu.values())).device if nu else torch.device("cpu")
        return {"count": torch.zeros((), dtype=torch.int32, device=device), "mu": mu, "nu": nu}

    @torch.no_grad()
    def apply_(self, params: dict, grads: Dict[str, Tensor], state: dict,
               ok: Optional[Tensor] = None) -> None:
        """One step in place: params, state["mu"], state["nu"] and
        state["count"]. grads: {path: gradient} of every trainable leaf,
        finite; ok: a 0-dim bool tensor (None: always apply)."""
        trainable = self.trainable(params)
        count = state["count"]
        okf = (torch.ones((), device=count.device) if ok is None
               else ok.to(device=count.device, dtype=torch.float32))
        g_all = [grads[p] for p, _ in trainable]
        if self.grad_clip is not None and g_all:
            # optax's (g / norm) * max_norm where norm >= max_norm, else g
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g_all)))
            keep = norm < self.grad_clip
            g_all = torch._foreach_div(g_all, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(g_all, torch.where(keep, 1.0, self.grad_clip))
        grads = dict(zip((p for p, _ in trainable), g_all))
        # optax's coefficients and order of operations, each moment's
        # weight on the old value 1 - (1 - b) * ok: b when the step applies,
        # 1 (the moment unchanged) when it does not
        a1 = (1.0 - self.b1) * okf
        a2 = (1.0 - self.b2) * okf
        c1, c2 = 1.0 - a1, 1.0 - a2
        step_inc = count.to(torch.float32) + 1.0
        bc1 = 1.0 - torch.pow(self.b1, step_inc)
        bc2 = 1.0 - torch.pow(self.b2, step_inc)
        for group, (_, wd) in self.groups.items():
            pairs = [(p, t) for p, t in trainable if self.labels[p] == group]
            if not pairs:
                continue
            paths = [p for p, _ in pairs]
            P = [t for _, t in pairs]
            G = [grads[p] for p in paths]
            mu_store = [state["mu"][p] for p in paths]
            V = [state["nu"][p] for p in paths]
            low_mu = self.mu_dtypes[group] != torch.float32
            if low_mu:
                # b1 m in m's dtype, b1 rounded to it too, as optax multiplies
                # the stored moment by a Python float; the sum and all after
                # it in f32
                M = [m.float() for m in torch._foreach_mul(mu_store, c1.to(mu_store[0].dtype))]
            else:
                M = mu_store
                torch._foreach_mul_(M, c1)                      # m = (1 - b1) g + b1 m
            torch._foreach_add_(M, torch._foreach_mul(G, a1))
            g2 = torch._foreach_mul(G, G)                       # v = (1 - b2) g^2 + b2 v
            torch._foreach_mul_(g2, a2)
            torch._foreach_mul_(V, c2)
            torch._foreach_add_(V, g2)
            den = torch._foreach_div(V, bc2)                    # sqrt(v_hat) + eps
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(M, bc1)                    # m_hat / den + wd p
            torch._foreach_div_(upd, den)
            torch._foreach_add_(upd, torch._foreach_mul(P, wd))
            torch._foreach_mul_(upd, -self.schedules[group](count) * okf)
            torch._foreach_add_(P, upd)
            if low_mu:
                torch._foreach_copy_(mu_store, M)
        count.add_(okf.to(torch.int32))


def build_optimizer(params: dict, base_schedule_factory: Callable[[float], Callable], *,
                    freeze_backbones: bool = True, grad_clip: Optional[float] = None,
                    backbone_moment_dtype: Optional[torch.dtype] = None) -> AdamW:
    """base_schedule_factory(lr multiplier) -> schedule; each group gets its
    own, with the reference's multiplier and weight decay."""
    return AdamW(param_labels(params, freeze_backbones=freeze_backbones),
                 {name: base_schedule_factory(mult) for name, (mult, _) in GROUPS.items()},
                 grad_clip=grad_clip, backbone_moment_dtype=backbone_moment_dtype)


def make_train_optimizer(params: dict, *, lr: float, total_steps: int,
                         warmup_ratio: float = 0.1, scheduler: str = "warmup_cosine",
                         restart_steps: int = 0, freeze_backbones: bool = True,
                         grad_clip: Optional[float] = None,
                         backbone_moment_dtype: Optional[torch.dtype] = None) -> AdamW:
    if scheduler == "warmup_cosine":
        factory = lambda mult: warmup_cosine_schedule(lr * mult, total_steps, warmup_ratio)
    elif scheduler == "cosine_restarts":
        factory = lambda mult: warmup_cosine_restarts_schedule(
            lr * mult, max(1, restart_steps), warmup_steps=int(restart_steps * warmup_ratio))
    else:
        raise ValueError(f"unknown scheduler {scheduler!r}")
    return build_optimizer(params, factory, freeze_backbones=freeze_backbones,
                           grad_clip=grad_clip, backbone_moment_dtype=backbone_moment_dtype)

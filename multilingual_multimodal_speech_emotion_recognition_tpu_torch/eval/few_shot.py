"""Few-shot adaptation: fine-tune fusion/classifier/prototypes on K shots,
measure recovery of the zero-shot → full-fine-tune gap.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
eval/few_shot.py, with the reference's few_shot_adaptation.py semantics:
K ∈ {10, 25, 50, 100, 250, 500} (:171), seeded random shot selection
(seed 42, :61), AdamW lr 1e-4 wd 0.01 over fusion+classifier+prototypes
only with frozen encoders/cross/pools (:83-95), 5 adaptation epochs batch
4 (:71-76), plain CE loss (:120), recovery_rate = max(0, (gap_zero_shot −
gap_K)/gap_zero_shot)·100 (:208-215).

The update is train/optimizer.AdamW with one trained group, whose
arithmetic is optax's adamw(lr, weight_decay=0.01) (b1 0.9, b2 0.999, eps
1e-8, f32 moments, decay on every trained leaf); frozen leaves get no
update and no decay. That optimizer writes in place, so `adapt` first
clones the trained subtrees: the caller's tree stays as it was, and every
K of `run_few_shot_suite` starts from the same base (JAX's trees are
immutable, which gives it the same for free). Dropout draws from a
torch.Generator on the parameters' device seeded from `seed`. The
adaptation forward is the training one, so the classifier takes its plain
stack (the kernel has no backward).

Padded rows are dropped before the adaptation forward, the one departure
from the JAX package's make_adapt_step (its eval/few_shot.py:58-65, which
weighs their CE by example_mask 0). The loader pads a partial batch with
rows of one valid sample; the conv extractor gives such a row zero frames,
its attention masks every key and its logits are NaN, and 0 x NaN is NaN:
weighed in, the row turned the loss and every adapted leaf NaN. A batch
whose rows are all real adapts as before.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..models import model as mdl
from ..train.optimizer import FROZEN, AdamW
from ..utils.runtime import map_leaves, to_device

DEFAULT_SHOTS = (10, 25, 50, 100, 250, 500)
TRAINABLE = ("fusion", "classifier", "prototypes")
TRAIN_GROUP = "train"
WEIGHT_DECAY = 0.01


@dataclass
class FewShotResult:
    num_shots: int
    f1_score: float
    accuracy: float
    recovery_rate: float


def adaptation_labels(params: dict) -> dict:
    """Optimizer labels: train fusion/classifier/prototypes, freeze the rest
    (few_shot_adaptation.py:83-95)."""
    return {k: map_leaves(v, lambda _p, _t, k=k: TRAIN_GROUP if k in TRAINABLE else FROZEN)
            for k, v in params.items()}


def make_adapt_optimizer(params: dict, lr: float) -> AdamW:
    """optax's adamw(lr, weight_decay=0.01) over the trained group."""
    return AdamW(adaptation_labels(params), {TRAIN_GROUP: lambda _count: lr},
                 groups={TRAIN_GROUP: (1.0, WEIGHT_DECAY)})


def real_rows(batch: dict) -> dict:
    """The batch's real rows: every key (all are per row) indexed with the
    rows whose example_mask is above 0, which stays as the rows' CE
    weights. A batch without example_mask, or with no padded row, comes
    back as it is; one with no real row raises ValueError (the loader emits
    none, and a step on it would be a silent zero step)."""
    w = batch.get("example_mask")
    if w is None:
        return batch
    keep = (w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)) > 0
    if not keep.any():
        raise ValueError("few-shot adaptation: a batch with no real row (example_mask all 0)")
    if keep.all():
        return batch
    rows = np.flatnonzero(keep)

    def take(v):
        if isinstance(v, torch.Tensor):
            return v[torch.from_numpy(rows).to(v.device)]
        return np.asarray(v)[rows]

    return {k: take(v) for k, v in batch.items()}


def adapt_loss(params: dict, model_cfg: ModelConfig, batch: dict,
               generator: torch.Generator, tp=None) -> torch.Tensor:
    """The CE of one training forward (dropout from `generator`) over the
    batch's real rows (real_rows: a partial final batch's padded rows never
    reach the forward), weighed by example_mask where the batch has one.
    `tp` (a parallel/tensor.ModelGroup) runs the forward tensor-parallel on
    this rank's view of the parameters; every rank gets the same batch and
    drops the same rows."""
    batch = real_rows(batch)
    fwd = {k: v for k, v in batch.items() if k not in ("labels", "example_mask")}
    out = mdl.model_forward(params, model_cfg, fwd, deterministic=False,
                            generator=generator, use_openmax=False, tp=tp)
    device = out.logits.device
    logp = torch.log_softmax(out.logits, dim=-1)
    labels = to_device(batch["labels"], device).long()
    onehot = torch.nn.functional.one_hot(labels, out.logits.shape[-1]).to(logp.dtype)
    ce = -(onehot * logp).sum(-1)
    w = batch.get("example_mask")
    if w is None:
        return ce.mean()
    w = to_device(w, device).to(ce.dtype)
    return (ce * w).sum() / w.sum().clamp(min=1.0)


def make_adapt_step(model_cfg: ModelConfig, optimizer: AdamW, tp=None):
    """step(params, opt_state, batch, generator) -> loss (a 0-dim tensor):
    adapt_loss, its gradients and one update of the trained leaves, in
    place. The trained leaves are replicated, so under `tp` every rank of
    the group computes their whole gradient."""

    def step(params: dict, opt_state: dict, batch: dict,
             generator: torch.Generator) -> torch.Tensor:
        paths = [p for p, _ in optimizer.trainable(params)]
        wanted, leaves = set(paths), {}

        def alias(path, t):
            if path not in wanted:
                return t
            leaves[path] = t.detach().requires_grad_(True)
            return leaves[path]

        loss = adapt_loss(map_leaves(params, alias), model_cfg, batch, generator, tp)
        grads = torch.autograd.grad(loss, [leaves[p] for p in paths], allow_unused=True,
                                    materialize_grads=True)
        optimizer.apply_(params, dict(zip(paths, grads)), opt_state)
        return loss.detach()

    return step


def adapt(params: dict, model_cfg: ModelConfig,
          batches_fn: Callable[[], Sequence[dict]], *,
          num_epochs: int = 5, lr: float = 1e-4, seed: int = 42, tp=None) -> dict:
    """Run the adaptation loop on the parameters' device; returns the
    adapted tree. The trained subtrees are clones, the frozen ones the
    caller's tensors: `params` itself is left as it was. Under `tp` the
    forward is tensor-parallel on this rank's view `params`."""
    params = {k: (map_leaves(v, lambda _, t: t.clone()) if k in TRAINABLE else v)
              for k, v in params.items()}
    optimizer = make_adapt_optimizer(params, lr)
    opt_state = optimizer.init(params)
    step = make_adapt_step(model_cfg, optimizer, tp)
    device = params["classifier"]["input_proj"]["kernel"].device
    generator = torch.Generator(device=device).manual_seed(seed)
    for _ in range(num_epochs):
        for batch in batches_fn():
            step(params, opt_state, batch, generator)
    return params


def select_shots(n_items: int, num_shots: int, seed: int = 42):
    """(shot_indices, eval_indices) — seeded like the reference (:61-66)."""
    rng = random.Random(seed)
    num_shots = min(num_shots, n_items)
    shots = rng.sample(range(n_items), num_shots)
    shot_set = set(shots)
    return shots, [i for i in range(n_items) if i not in shot_set]


def recovery_rate(zero_shot_f1: float, adapted_f1: float,
                  full_ft_f1: float) -> float:
    """Percent of the zero-shot→full-FT gap recovered (:208-215)."""
    adaptation_gap = full_ft_f1 - zero_shot_f1
    if adaptation_gap <= 0:
        return 0.0
    performance_gap = full_ft_f1 - adapted_f1
    return max(0.0, (adaptation_gap - performance_gap) / adaptation_gap) * 100.0


def run_few_shot_suite(params: dict, model_cfg: ModelConfig, *,
                       make_batches: Callable[[List[int]], Sequence[dict]],
                       evaluate: Callable[[dict, List[int]], Dict[str, float]],
                       n_items: int,
                       shots: Sequence[int] = DEFAULT_SHOTS,
                       zero_shot_f1: Optional[float] = None,
                       full_ft_f1: Optional[float] = None,
                       num_epochs: int = 5, seed: int = 42, tp=None
                       ) -> List[FewShotResult]:
    """Full K-shot sweep, each K adapted from `params`. `make_batches(indices)`
    yields train batches over those items; `evaluate(params, indices)`
    returns {'f1', 'accuracy'} on the held-out items. `tp` as adapt's."""
    results = []
    for k in shots:
        shot_idx, eval_idx = select_shots(n_items, k, seed)
        adapted = adapt(params, model_cfg, lambda: make_batches(shot_idx),
                        num_epochs=num_epochs, seed=seed, tp=tp)
        m = evaluate(adapted, eval_idx)
        rec = 0.0
        if zero_shot_f1 is not None and full_ft_f1 is not None:
            rec = recovery_rate(zero_shot_f1, m["f1"], full_ft_f1)
        results.append(FewShotResult(num_shots=k, f1_score=m["f1"],
                                     accuracy=m["accuracy"],
                                     recovery_rate=rec))
    return results


def few_shot_report(results: List[FewShotResult]) -> str:
    lines = ["Few-Shot Adaptation", "===================",
             f"{'shots':<8} {'F1':<8} {'accuracy':<10} {'recovery':<10}"]
    for r in results:
        rec = f"{r.recovery_rate:.1f}%" if r.recovery_rate > 0 else "N/A"
        lines.append(f"{r.num_shots:<8} {r.f1_score:<8.4f} "
                     f"{r.accuracy:<10.4f} {rec:<10}")
    return "\n".join(lines)

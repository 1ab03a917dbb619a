"""The training step: augmentation, the multi-term loss, its gradients and
the per-group AdamW update, on one device.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
train/train_step.py. The loss mix is the reference's (train.py:151-168):

  loss = label-smoothed CE
       + focal_weight       * class-balanced focal
       + anchor_weight      * anchor pull loss (identically 0, kept)
       + uncertainty_weight * mean(uncertainty * correct)
       + proto_term_weight  * prototype loss      (at proto_weight > 0)
       + supcon_weight      * SupCon               (at supcon_weight > 0)
       + consistency_aug_weight * CE of a second augmented forward, on a
         consistency_aug_fraction of the optimizer steps

Frozen backbones are passed to the forward detached, as JAX stops their
gradient, so their encoders run without autograd (models/model.py). The
trainable leaves enter the forward as detached aliases that want a
gradient: the caller's tensors never carry autograd state, and the update
writes into them in place. Randomness comes from a torch.Generator on the
step's device and, for the per-batch speed factor, a CPU generator, both
seeded from the step's `seed` (an int, the role of JAX's per-step key):
a step reads nothing back from the card for it.

The non-finite guard (the reference's train_crema.py:360-368): where the
gradients' global norm or the loss is not finite, the gradients are
zeroed and the optimizer applies nothing, the step count included
(train/optimizer.py), decided on the card by a 0-dim `ok` flag.

Sharded parameters (DTensors, parallel/mesh.shard_params) and a sharded
batch (parallel/mesh.shard_batch) take the same step on the global batch,
as the JAX step does under GSPMD: each rank takes its view of the
parameters (parallel/tensor.local_params: FSDP's 'data' dimensions gathered
over 'data', the 'model' rule's leaves left as this rank's shards; no
gradient through the gather), the forward and backward run on this rank's
rows, tensor-parallel over the 'model' group (parallel/tensor.py), and the
rows' logits, uncertainty, fused vectors and labels are gathered over
'data' (RowGather: an all-gather whose backward keeps this rank's rows)
before the losses, so the class counts, the anchor pull and every batch
mean are the global batch's; the gradients are then reduced to the
parameters' placements (a reduce-scatter or all-reduce over 'data') and the
update runs on each rank's shards. With grad_accum > 1 the i-th microbatch
is every rank's i-th slice of its rows.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple, Union

import torch

from ..config import ModelConfig, TrainConfig
from ..models import model as mdl
from ..models import prototypes as protos
from ..ops import audio_dsp, losses
from ..parallel import tensor as tensor_lib
from ..utils.runtime import map_leaves, params_on, resolve_device, to_device
from .checkpoint import FROZEN_SUBTREES
from .optimizer import AdamW, global_norm, local

Tensor = torch.Tensor


class StepMetrics(NamedTuple):
    loss: Tensor
    ce: Tensor
    focal: Tensor
    anchor: Tensor
    uncertainty: Tensor
    proto: Tensor
    supcon: Tensor
    accuracy: Tensor


def stop_backbone_gradients(params: dict) -> dict:
    """The tree with the backbones detached (JAX's stop_gradient)."""
    return {k: (map_leaves(v, lambda _, t: t.detach()) if k in FROZEN_SUBTREES else v)
            for k, v in params.items()}


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: Tensor, scale: float) -> Tensor:
        ctx.scale = scale
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g: Tensor):
        return g * ctx.scale, None


class RowGather:
    """The global batch's loss from this rank's rows, under a mesh.

    Calling it on t (this rank's rows) gives the global batch's rows in
    rank order, on every rank: an all-gather over 'data' whose backward
    keeps this rank's rows of the cotangent (every rank computes the same
    loss from them), so a parameter of the forward gets this rank's share
    of its gradient and the reduction over 'data' (reduce_grads) sums the
    shares. A parameter the loss itself uses on the gathered rows (the
    prototypes, distillation's projection) gets the whole gradient on
    every rank instead: `shared` passes it with its gradient divided by
    the 'data' size, so that the same sum counts it once."""

    def __init__(self, mesh):
        from torch.distributed.tensor import Replicate, Shard
        from ..parallel.mesh import DATA_AXIS
        self.mesh = mesh
        self.placements = [Shard(0) if n == DATA_AXIS else Replicate()
                           for n in mesh.mesh_dim_names]
        self.n = mesh[DATA_AXIS].size()

    def __call__(self, t: Tensor) -> Tensor:
        from torch.distributed.tensor import DTensor
        if self.n == 1:
            return t
        return DTensor.from_local(t, self.mesh, self.placements, run_check=False).full_tensor()

    def shared(self, tree):
        return map_leaves(tree, lambda _, t: _ScaleGrad.apply(t, 1.0 / self.n))


Rows = Optional[RowGather]

def compute_loss(params: dict, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 batch: dict, *, generator: Optional[torch.Generator] = None,
                 deterministic: bool = False, rows: Rows = None, tp=None):
    """(loss, StepMetrics) of one batch; training draws dropout and
    SpecAugment from `generator`. The eval forward (deterministic=True)
    takes the classifier's kernel, which has no backward: on the card it
    raises under autograd. `rows` (a RowGather of the mesh) makes the loss
    the global batch's when `batch` holds this rank's rows; the anchor pull,
    a mean over each rank's rows, becomes the mean over the ranks (equal
    row counts). `tp` (a parallel/tensor.ModelGroup) runs the forward
    tensor-parallel on this rank's view of the parameters."""
    if train_cfg.freeze_backbones:
        params = stop_backbone_gradients(params)
    out = mdl.model_forward(params, model_cfg, batch, deterministic=deterministic,
                            generator=generator, use_openmax=False,
                            spec_augment=not deterministic, tp=tp)
    labels = to_device(batch["labels"], out.logits.device).long()
    logits, uncertainty, fused, anchor = out.logits, out.uncertainty, out.fused, out.anchor_loss
    if rows is not None:
        logits, uncertainty, fused, labels = (rows(t) for t in (logits, uncertainty,
                                                                 fused, labels))
        anchor = rows(anchor.reshape(1)).mean()
    zero = torch.zeros((), device=logits.device)
    ce = losses.label_smoothing_cross_entropy(logits, labels,
                                              smoothing=train_cfg.label_smoothing)
    focal = losses.class_balanced_focal_loss(logits, labels,
                                             num_classes=model_cfg.num_labels,
                                             beta=train_cfg.focal_beta,
                                             gamma=train_cfg.focal_gamma)
    unc = losses.uncertainty_regularizer(uncertainty, logits, labels)
    loss = (ce + train_cfg.focal_weight * focal + train_cfg.anchor_weight * anchor
            + train_cfg.uncertainty_weight * unc)
    proto = sup = zero
    if train_cfg.proto_weight > 0:
        emb = fused
        if train_cfg.proto_l2_normalize:
            # train_crema.py:330: the prototype loss on the L2-normalised fused vector
            emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp(min=1e-8)
        proto_params = params["prototypes"] if rows is None else rows.shared(
            params["prototypes"])
        proto = protos.prototype_loss(proto_params, emb, labels)
        loss = loss + train_cfg.proto_term_weight * proto
    if train_cfg.supcon_weight > 0:
        sup = losses.supcon_loss(fused, labels)
        loss = loss + train_cfg.supcon_weight * sup
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, StepMetrics(loss=loss, ce=ce, focal=focal, anchor=anchor,
                             uncertainty=unc, proto=proto, supcon=sup, accuracy=acc)


def trainable_view(params: dict, paths: List[str], mesh) -> Tuple[dict, List[Tensor]]:
    """(the tree with each leaf at `paths` a detached alias that wants a
    gradient, those aliases in `paths` order). Under a mesh the tree is this
    rank's view first (parallel/tensor.local_params: nothing gathered over
    'model'; no gradient through the gather). The caller's tensors never
    carry autograd state."""
    wanted, leaves = set(paths), {}
    if mesh is not None:
        params = tensor_lib.local_params(params, mesh)

    def alias(path, t):
        if path not in wanted:
            return t
        leaves[path] = t.detach().requires_grad_(True)
        return leaves[path]

    view = map_leaves(params, alias)
    return view, [leaves[p] for p in paths]


def reduce_grads(grads: List[Tensor], params: List[Tensor], mesh) -> List[Tensor]:
    """Under a mesh, each gradient of this rank's view (this rank's rows'
    share; a 'model'-sharded leaf's shard, any other leaf whole on every
    rank of the model group) summed over 'data' into its parameter's
    placements (a reduce-scatter where the parameter is sharded on 'data',
    an all-reduce where it is not; nothing where 'data' is one rank);
    otherwise the gradients as they are."""
    if mesh is None:
        return list(grads)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from ..parallel.mesh import MODEL_AXIS
    data = Partial() if tensor_lib.data_shard(mesh)[1] > 1 else Replicate()
    out = []
    for g, p in zip(grads, params):
        own = [pl if n == MODEL_AXIS else data for n, pl in zip(mesh.mesh_dim_names,
                                                                p.placements)]
        d = DTensor.from_local(g, mesh, own, run_check=False)
        out.append(d if own == list(p.placements) else d.redistribute(mesh, p.placements))
    return out


@torch.no_grad()
def _zero_unless(ok: Tensor, g: Tensor) -> Tensor:
    """g where ok holds, else zeros (on the local shard of a DTensor)."""
    loc = local(g)
    if loc is g:
        return torch.where(ok, g, 0.0)
    loc.copy_(torch.where(ok, loc, 0.0))
    return g


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig, optimizer: AdamW, *,
                    device: Optional[Union[str, torch.device]] = None):
    """step(params, opt_state, batch, seed) -> StepMetrics (0-dim tensors on
    the device). Updates params and opt_state in place. With
    train_cfg.augment the reference's online augmentation (train.py:
    130-143) runs inside the step, on the device. grad_accum > 1 runs the
    batch as that many microbatches, one backward each (the focal loss's
    class weights per microbatch), gradients and metrics averaged; a batch
    they do not divide raises. The consistency CE's gate is drawn once per
    optimizer batch, so microbatches never disagree on it."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    host_generator = torch.Generator()
    accum = max(1, int(train_cfg.grad_accum))
    consistency = train_cfg.consistency_aug_weight > 0

    def augment(mb: dict) -> dict:
        wave, mask = audio_dsp.augment_batch(
            mb["audio"], mb["audio_mask"], generator=generator,
            host_generator=host_generator,
            speed_per_batch=train_cfg.augment_speed_per_batch)
        return {**mb, "audio": wave, "audio_mask": mask}

    def loss_fn(p: dict, mb: dict, gate: Optional[Tensor], rows: Rows, tp):
        loss, metrics = compute_loss(p, model_cfg, train_cfg, mb, generator=generator,
                                     rows=rows, tp=tp)
        if consistency:
            # train_crema_final.py:283-292: a second forward on another
            # augmented view, its CE added on the gated steps
            fwd = stop_backbone_gradients(p) if train_cfg.freeze_backbones else p
            out2 = mdl.model_forward(fwd, model_cfg, augment(mb), deterministic=False,
                                     generator=generator, tp=tp)
            logits2, labels2 = out2.logits, mb["labels"]
            if rows is not None:
                logits2, labels2 = rows(logits2), rows(labels2)
            ce2 = losses.label_smoothing_cross_entropy(
                logits2, labels2, smoothing=train_cfg.label_smoothing)
            loss = loss + torch.where(gate, train_cfg.consistency_aug_weight * ce2, 0.0)
            metrics = metrics._replace(loss=loss)
        return loss, metrics

    def step(params: dict, opt_state: dict, batch: dict, seed: int) -> StepMetrics:
        params_on(params, dev)
        mesh = tensor_lib.mesh_of(params)
        gather_rows = RowGather(mesh) if mesh is not None else None
        tp = tensor_lib.model_group(mesh) if mesh is not None else None
        batch = {k: to_device(local(v), dev) for k, v in batch.items()}
        generator.manual_seed(seed)
        host_generator.manual_seed(seed)
        if train_cfg.augment:
            batch = augment(batch)
        gate = (torch.rand((), generator=generator, device=dev)
                < train_cfg.consistency_aug_fraction) if consistency else None
        trainable = optimizer.trainable(params)
        paths = [p for p, _ in trainable]
        view, inputs = trainable_view(params, paths, mesh)

        def grads_of(mb):
            loss, metrics = loss_fn(view, mb, gate, gather_rows, tp)
            return torch.autograd.grad(loss, inputs, allow_unused=True,
                                       materialize_grads=True), metrics

        if accum == 1:
            grads, metrics = grads_of(batch)
            grads = list(grads)
        else:
            b0 = batch["labels"].shape[0]
            if b0 % accum != 0:
                raise ValueError(f"batch size {b0} not divisible by grad_accum {accum}")
            m = b0 // accum
            rows = {k for k, v in batch.items() if v.ndim >= 1 and v.shape[0] == b0}
            grads, per_micro = None, []
            for i in range(accum):
                mb = {k: (v[i * m:(i + 1) * m] if k in rows else v) for k, v in batch.items()}
                g, metrics = grads_of(mb)
                per_micro.append(metrics)
                if grads is None:
                    grads = list(g)
                else:
                    torch._foreach_add_(grads, g)
            torch._foreach_div_(grads, float(accum))
            metrics = StepMetrics(*(torch.stack(v).mean() for v in zip(*per_micro)))
        grads = reduce_grads(grads, [p for _, p in trainable], mesh)
        ok = torch.isfinite(global_norm(grads)) & torch.isfinite(metrics.loss)
        grads = [_zero_unless(ok, g) for g in grads]
        optimizer.apply_(params, dict(zip(paths, grads)), opt_state, ok)
        return StepMetrics(*(v.detach() for v in metrics))

    return step


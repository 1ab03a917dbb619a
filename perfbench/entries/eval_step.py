"""The port's plain eval step, `eval/evaluate.py:make_eval_step(cfg.model,
use_openmax=True)`: one forward a batch; its logits and uncertainty are
what a labelling pipeline writes, so both go to the host.

Compared with the reference, each in units of the spread of the
reference's answers across the batch's clips (the root mean square of
their departure from the batch's mean): `logit_gap`, the root mean square
of program - reference over the batch's logits; `uncertainty_gap`, the
same of the uncertainty; `worst_row_gap`, the largest over the clips of
one clip's root mean square over its logits and its uncertainty, each in
its own units, so that one clip answered wrong shows whatever the batch
size."""

from __future__ import annotations

import torch


def prepare(batches, seed: int, device, args: dict):
    """Per-batch inputs beside the batch itself: none."""
    return [None] * len(batches)


def rows(batch: dict, args: dict):
    """(audio rows, text rows) the step runs for a batch."""
    return batch["clips"], batch["clips"]


def build(port, model_cfg, params: dict, args: dict, device):
    """fn(device batch, extra) -> [B, C + 1] logits and uncertainty on the device."""
    step = port.evaluate.make_eval_step(model_cfg, use_openmax=args["use_openmax"],
                                        device=device)

    def run(batch: dict, extra) -> torch.Tensor:
        logits, _, uncertainty = step(params, batch)
        return torch.cat([logits.float(), uncertainty.float()], 1)

    return run


def reference(ref, cfg: dict, weights: dict, batch: dict, extra, args: dict) -> torch.Tensor:
    logits, uncertainty = ref.forward(weights, cfg, batch, use_openmax=args["use_openmax"])
    return torch.cat([logits, uncertainty], 1)


def _spread(expected: torch.Tensor) -> torch.Tensor:
    """rms(expected - its mean over the rows), over all its columns."""
    return (expected - expected.mean(0)).square().mean().sqrt().clamp(min=1e-30)


def gap(out: torch.Tensor, expected: torch.Tensor) -> float:
    """rms(out - expected) / rms(expected - its mean over the rows)."""
    out, expected = out.double(), expected.double()
    return float(((out - expected).square().mean().sqrt() / _spread(expected))
                 .nan_to_num(float("inf")))


def worst_row(out: torch.Tensor, expected: torch.Tensor, groups) -> float:
    """max over rows of the rms over the row's columns of (out - expected),
    each column group (a slice) in units of its own spread."""
    out, expected = out.double(), expected.double()
    z = torch.cat([(out[:, g] - expected[:, g]) / _spread(expected[:, g]) for g in groups], 1)
    return float(z.square().mean(1).sqrt().max().nan_to_num(float("inf")))


def compare(out: torch.Tensor, expected: torch.Tensor) -> dict:
    return {"logit_gap": gap(out[:, :-1], expected[:, :-1]),
            "uncertainty_gap": gap(out[:, -1], expected[:, -1]),
            "worst_row_gap": worst_row(out, expected, (slice(0, -1), slice(-1, None)))}

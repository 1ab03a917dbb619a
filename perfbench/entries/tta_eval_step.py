"""The port's 5-view TTA eval step, `eval/evaluate.py:make_tta_eval_step(
cfg, num_tta=5, use_openmax=True)`, the reference repository's eval mode:
the batch expands on the card to [orig, speed 0.95, speed 1.05, noise
15 dB, noise 20 dB], one forward serves the V * B rows with the text side
run once at B, and the logits are meaned over the views. The two noise
views' standard-normal draws [2, B, T] are the benchmark's, made from the
seed in set-up, kept on the card and passed as `noise`.

Compared with the reference, in units of the spread of the reference's
view-averaged logits across the batch's clips: `logit_gap`, the root mean
square of program - reference over the batch's logits (eval_step.gap),
and `worst_row_gap`, the largest over the clips of one clip's
(eval_step.worst_row)."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.entries.eval_step import gap, worst_row


def prepare(batches, seed: int, device, args: dict):
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, 0x5454]).generate_state(1, np.uint64)[0]))
    return [torch.randn((2, *b["audio"].shape), generator=g, device=device) for b in batches]


def rows(batch: dict, args: dict):
    return batch["clips"] * args["num_tta"], batch["clips"]


def build(port, model_cfg, params: dict, args: dict, device):
    step = port.evaluate.make_tta_eval_step(port.config.Config(model=model_cfg),
                                            num_tta=args["num_tta"],
                                            use_openmax=args["use_openmax"], device=device)

    def run(batch: dict, extra) -> torch.Tensor:
        return step(params, batch, noise=extra).float()

    return run


def reference(ref, cfg: dict, weights: dict, batch: dict, extra, args: dict) -> torch.Tensor:
    return ref.tta_forward(weights, cfg, batch, extra, num_tta=args["num_tta"],
                           use_openmax=args["use_openmax"])


def compare(out: torch.Tensor, expected: torch.Tensor) -> dict:
    return {"logit_gap": gap(out, expected),
            "worst_row_gap": worst_row(out, expected, (slice(None),))}

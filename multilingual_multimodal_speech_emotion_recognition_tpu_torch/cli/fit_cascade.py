"""Fit CascadeServer thresholds from per-utterance prediction files.

Pipeline (both tiers scored on the SAME manifest so rows join by index):

    python -m multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.eval \\
        --checkpoint ckpt_student --manifest val.jsonl --predictions_out student_preds.jsonl
    python -m multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.eval \\
        --checkpoint ckpt_teacher --manifest val.jsonl --predictions_out teacher_preds.jsonl
    python -m multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.fit_cascade \\
        --student_predictions student_preds.jsonl \\
        --teacher_predictions teacher_preds.jsonl --escalation_budget 0.15

The flags and output are those of the repo's cli/fit_cascade.py: the
fitted operating point as JSON and the serve CLI's flags to run it. Host
numpy only (eval/cascade.py): no device, no model.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

SERVE = "python -m multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.serve"


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--student_predictions", required=True,
                   help="the eval CLI's --predictions_out JSONL for the "
                        "student (the first tier)")
    p.add_argument("--teacher_predictions", default=None,
                   help="same file for the teacher; with it the fit "
                        "optimizes CASCADE accuracy (escalated rows take "
                        "the teacher's correctness), without it selective "
                        "accuracy on the answered set")
    p.add_argument("--escalation_budget", type=float, default=None,
                   help="max fraction of traffic allowed to escalate")
    p.add_argument("--min_accuracy", type=float, default=None,
                   help="required accuracy; escalations are minimized")
    p.add_argument("--energy_quantile", type=float, default=None,
                   help="also fit --energy_threshold as this quantile of "
                        "energy over student-correct rows (e.g. 0.99)")
    p.add_argument("--out", default=None, help="write the fit as JSON")
    args = p.parse_args(argv)
    if args.escalation_budget is None and args.min_accuracy is None:
        p.error("set --escalation_budget and/or --min_accuracy")
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns the fit."""
    args = parse_args(argv)
    from ..eval import cascade

    student = cascade.read_predictions(args.student_predictions)
    teacher = (cascade.read_predictions(args.teacher_predictions)
               if args.teacher_predictions else None)
    fit = cascade.fit_from_predictions(
        student, teacher, escalation_budget=args.escalation_budget,
        min_accuracy=args.min_accuracy,
        energy_quantile=args.energy_quantile)

    print(json.dumps(fit, indent=2))
    if not fit["feasible"]:
        print("\nWARNING: the accuracy target is infeasible within the "
              "escalation budget; reporting the best point within budget.",
              file=sys.stderr)
    flags = f"--confidence_threshold {fit['confidence_threshold']:.6f}"
    if "energy_threshold" in fit:
        flags += f" --energy_threshold {fit['energy_threshold']:.6f}"
    print(f"\nserve with:\n  {SERVE} --artifact <student_art> "
          f"--cascade_teacher <teacher_art> {flags}")
    if args.out:
        Path(args.out).write_text(json.dumps(fit, indent=2))
    return fit


if __name__ == "__main__":
    main(sys.argv[1:])

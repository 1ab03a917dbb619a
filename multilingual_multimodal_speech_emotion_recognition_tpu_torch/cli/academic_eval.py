"""Academic evaluation CLI of the port: the 8-part battery over a checkpoint, on the card.

    python -m multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.academic_eval \\
        --checkpoint ckpt_dir --manifest test.jsonl --output_dir evaluation_results \\
        --few_shot_shots 10 25 --snr_levels 20 10 0 --zero_shot_langs hi bn te \\
        --open_set_unknown_class neutral

The flags are those of the repo's cli/academic_eval.py (the reference's
evaluate_academic_complete.py:467-547: baseline, cross-lingual,
calibration, ASR tracking, inference benchmark, risk-coverage, few-shot,
robustness, per-class + confusion, text + JSON reports), with `--device`
(default cuda) in place of `--platform`. The checkpoint is a directory in
the port's format (train/checkpoint.py); its config.json restores the
model and data configuration. Without a card the CLI exits non-zero unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--manifest", required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--output_dir", default="evaluation_results")
    p.add_argument("--dataset_root", default=None)
    p.add_argument("--no_benchmark", action="store_true")
    p.add_argument("--no_few_shot", action="store_true")
    p.add_argument("--no_robustness", action="store_true")
    p.add_argument("--few_shot_shots", type=int, nargs="*", default=None,
                   help="K values for few-shot adaptation (default: the "
                        "reference's 10/25/50/100/250/500, clipped to the "
                        "manifest size)")
    p.add_argument("--few_shot_epochs", type=int, default=5)
    p.add_argument("--full_ft_f1", type=float, default=None,
                   help="full-fine-tune F1 for recovery-rate computation")
    p.add_argument("--snr_levels", type=float, nargs="*", default=None,
                   help="robustness SNR sweep (default 20 15 10 5 0 -5)")
    p.add_argument("--zero_shot_langs", nargs="*", default=None,
                   choices=["hi", "bn", "te"],
                   help="zero-shot cross-lingual eval: render manifest "
                        "texts into these native scripts (same audio), "
                        "report per-language slices + transfer ratios")
    p.add_argument("--open_set_unknown_class", type=str, default=None,
                   help="leave-one-class-out open-set protocol: treat this "
                        "class (index or emotion name, e.g. 'disgust') as "
                        "unknown at eval and report OSCR/AUROC/AUPR/FPR@95 "
                        "for MSP, energy, and OpenMax unknown scores")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "plain versions of the kernels)")
    return p.parse_args(argv)


def unknown_class_index(value: Optional[str], num_labels: int) -> Optional[int]:
    """--open_set_unknown_class as a class index (an index or an emotion
    name); exits on one out of range or unknown."""
    from ..eval import academic
    if value is None:
        return None
    try:
        index = int(value)
    except ValueError:
        names = academic.EMOTIONS_6[:num_labels]
        if value not in names:
            raise SystemExit(f"--open_set_unknown_class must be an index < "
                             f"{num_labels} or one of {names}")
        index = names.index(value)
    if not 0 <= index < num_labels:
        raise SystemExit(f"--open_set_unknown_class index out of range "
                         f"(num_labels={num_labels})")
    return index


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns run_academic_evaluation's results."""
    args = parse_args(argv)
    from ..utils.runtime import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"academic_eval: {e} (--device cpu)") from e

    from .. import config as cfg_lib
    from ..eval import academic
    from ..train import checkpoint as ckpt

    cfg_json = ckpt.load_config_json(args.checkpoint)
    cfg = cfg_lib.config_from_json(cfg_json) if cfg_json else cfg_lib.Config()
    if args.dataset_root:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, dataset_root=args.dataset_root))
    unknown_class = unknown_class_index(args.open_set_unknown_class, cfg.model.num_labels)
    params, meta = ckpt.restore_checkpoint(args.checkpoint, device=device)
    print(f"Loaded checkpoint: {args.checkpoint} "
          f"(epoch {meta.get('epoch')}, f1 {meta.get('f1')}) on {device}")
    return academic.run_academic_evaluation(
        params, cfg, args.manifest, batch_size=args.batch_size, device=device,
        output_dir=args.output_dir, run_benchmark=not args.no_benchmark,
        run_few_shot=not args.no_few_shot,
        run_robustness=not args.no_robustness,
        few_shot_shots=args.few_shot_shots,
        few_shot_epochs=args.few_shot_epochs,
        full_ft_f1=args.full_ft_f1,
        robustness_snr_levels=args.snr_levels,
        zero_shot_languages=tuple(args.zero_shot_langs or ()),
        open_set_unknown_class=unknown_class)


if __name__ == "__main__":
    main(sys.argv[1:])

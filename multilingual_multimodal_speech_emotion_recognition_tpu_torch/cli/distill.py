"""Distillation CLI of the port: distill a flagship checkpoint into a small student, on the card.

    python -m multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.distill \\
        --teacher_checkpoint ckpts/best --train_manifest crema_train_70.jsonl \\
        --val_manifest crema_val_20.jsonl --student_preset small --epochs 10 \\
        --batch_size 32 --lr 3e-4 --save_dir ckpts_student

The flags are those of the repo's cli/distill.py, with `--device` (default
cuda) in place of `--platform`. `--prng_impl` selects JAX's random-number
backend and has no counterpart here: the port's draws come from torch
generators seeded by the teacher's TrainConfig seed. The student
checkpoint this writes is an ordinary checkpoint of the port (its config
embedded), so the eval, export and serve CLIs and `--int8` work on it
unchanged. The 'small' preset is 119M params vs the flagship's 397M (96M
of it the shared 250k-vocab embedding table: per-clip compute shrinks
~10x). Without a card the CLI exits non-zero unless `--device cpu` is
given.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="--prng_impl (JAX's random-number backend) is not a flag of the port: "
               "its draws come from torch generators.")
    p.add_argument("--teacher_checkpoint", type=str, required=True)
    p.add_argument("--train_manifest", type=str, required=True)
    p.add_argument("--val_manifest", type=str, required=True)
    p.add_argument("--student_preset", default="small",
                   choices=["small", "tiny"])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--temperature", type=float, default=4.0)
    p.add_argument("--alpha", type=float, default=0.9,
                   help="soft-target weight (1-alpha goes to hard-label CE)")
    p.add_argument("--feature_match_weight", type=float, default=0.0,
                   help=">0 adds MSE between a learned projection of the "
                        "student's fused features and the teacher's")
    p.add_argument("--save_dir", type=str, default="checkpoints_student")
    p.add_argument("--dataset_root", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu for tiny models)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns distill's result."""
    args = parse_args(argv)
    from ..utils.runtime import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"distill: {e} (--device cpu)") from e

    from .. import config as cfg_lib
    from ..train import checkpoint as ckpt_lib, distill as dst

    cfg_json = ckpt_lib.load_config_json(args.teacher_checkpoint)
    teacher_cfg = cfg_lib.config_from_json(cfg_json) if cfg_json else cfg_lib.Config()
    if args.dataset_root:
        teacher_cfg = dataclasses.replace(
            teacher_cfg, data=dataclasses.replace(teacher_cfg.data,
                                                  dataset_root=args.dataset_root))
    teacher_params, meta = ckpt_lib.restore_checkpoint(args.teacher_checkpoint,
                                                       device=device)
    print(f"Teacher: {args.teacher_checkpoint} "
          f"(epoch {meta.get('epoch')}, f1 {meta.get('f1')}) on {device}")

    train_cfg = dataclasses.replace(
        teacher_cfg.train, epochs=args.epochs, batch_size=args.batch_size,
        lr=args.lr, save_dir=args.save_dir)
    dcfg = dst.DistillConfig(temperature=args.temperature, alpha=args.alpha,
                             feature_match_weight=args.feature_match_weight,
                             student_preset=args.student_preset)
    out = dst.distill(teacher_params, teacher_cfg,
                      train_manifest=args.train_manifest,
                      val_manifest=args.val_manifest,
                      dcfg=dcfg, train_cfg=train_cfg, device=device)
    print(f"Best student F1: {out['best_f1']:.4f} -> {out['best_path']}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])

"""Evaluation CLI of the port: score a jsonl manifest on the card.

    python -m multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.eval \\
        --manifest test.jsonl --checkpoint ckpt_dir --use_tta \\
        --calibrate --val_manifest val.jsonl --predictions_out preds.jsonl

The flags are those of the repo's cli/eval.py that the port honours, with
`--device` (default cuda) in place of `--platform`. The checkpoint is a
directory in the port's format (train/checkpoint.py); convert a JAX
checkpoint first with scripts/torch_import_jax_checkpoint.py. Its
config.json restores the model and data configuration. Without a card the
CLI exits non-zero unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--manifest", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--use_tta", action="store_true")
    p.add_argument("--num_tta", type=int, default=5)
    p.add_argument("--calibrate", action="store_true")
    p.add_argument("--val_manifest", type=str, default=None)
    p.add_argument("--dataset_root", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "plain versions of the kernels)")
    p.add_argument("--use_asr", action="store_true",
                   help="force the ASR feature path on (normally restored from the "
                        "checkpoint's embedded config)")
    p.add_argument("--int8", action="store_true",
                   help="int8-quantise the backbones' encoder matmuls (ops/quant.py)")
    p.add_argument("--gates_no_text", action="store_true",
                   help="the gates see no text (the reference's plain eval "
                        "loop), so LID enters as the no-text constants (1.0, 0.0)")
    p.add_argument("--zero_non_accept", action="store_true",
                   help="zero audio unless the abstain decision is 'accept', "
                        "as the reference encoder does; default zeroes on "
                        "'reject' only")
    p.add_argument("--ref_pad_semantics", action="store_true",
                   help="the reference's padding: audio padded to the batch's "
                        "longest clip in one bucket, and zero-padded feature "
                        "frames treated as valid in cross-attention and pooling")
    p.add_argument("--predictions_out", type=str, default=None,
                   help="write per-utterance predictions as JSONL")
    p.add_argument("--save_temperature", action="store_true",
                   help="persist the fitted temperature as calibration.json "
                        "inside the checkpoint directory")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns evaluate_manifest's results."""
    args = parse_args(argv)
    # flag checks before the (possibly long) run
    if args.save_temperature and not (args.calibrate and args.val_manifest):
        raise SystemExit("--save_temperature requires --calibrate AND --val_manifest "
                         "to fit one (without the val manifest no temperature is "
                         "fitted and 1.0 would be persisted as if calibrated)")
    if args.use_tta and not 1 <= args.num_tta <= 5:
        raise SystemExit(f"--num_tta must be in 1..5, not {args.num_tta}")

    from ..utils.runtime import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"eval: {e} (--device cpu)") from e

    from .. import config as cfg_lib
    from ..eval import evaluate
    from ..train import checkpoint as ckpt

    cfg_json = ckpt.load_config_json(args.checkpoint)
    cfg = cfg_lib.config_from_json(cfg_json) if cfg_json else cfg_lib.Config()
    if args.dataset_root:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, dataset_root=args.dataset_root))
    if args.use_asr:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, use_asr=True),
            data=dataclasses.replace(cfg.data, emit_asr_feats=True))
    if args.gates_no_text:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, gates_see_text=False))
    if args.zero_non_accept:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, zero_non_accept=True))
    if args.ref_pad_semantics:
        # one bucket: the reference batches manifest-consecutive rows and pads
        # each batch to its own longest clip
        cfg = dataclasses.replace(
            cfg,
            model=dataclasses.replace(cfg.model, pad_frames_valid=True),
            data=dataclasses.replace(cfg.data, pad_to_batch_max=True,
                                     audio_buckets=(cfg.data.max_audio_seconds,)))

    params, meta = ckpt.restore_checkpoint(args.checkpoint, device=device)
    if args.int8:
        from ..ops import quant
        params = quant.quantize_backbones(params)
    print(f"Loaded checkpoint: {args.checkpoint} "
          f"(epoch {meta.get('epoch')}, f1 {meta.get('f1')}) on {device}")

    results = evaluate.evaluate_manifest(
        params, cfg, args.manifest, batch_size=args.batch_size,
        use_tta=args.use_tta, num_tta=args.num_tta, calibrate=args.calibrate,
        val_manifest=args.val_manifest, device=device)

    if args.predictions_out:
        n = evaluate.write_predictions_jsonl(results, args.manifest, args.predictions_out)
        print(f"Wrote {n} per-utterance predictions to {args.predictions_out}")
    if args.save_temperature:
        cal_path = Path(args.checkpoint) / "calibration.json"
        cal_path.write_text(json.dumps({"temperature": results["temperature"],
                                        "fitted_on": args.val_manifest}, indent=2))
        print(f"Saved temperature {results['temperature']:.3f} -> {cal_path}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])

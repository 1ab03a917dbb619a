"""Export CLI of the port: a checkpoint as serving artifacts (torch.export
programs and their parameters, export.py), traced on the device they will
serve on.

    python -m multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.export \\
        --checkpoint ckpt_dir --out_dir export --buckets 4:32,8:16

The flags are the repo's cli/export.py's, with `--device` (default cuda)
in place of `--platform`. The checkpoint is a directory in the port's
format (train/checkpoint.py). A calibration.json in it is shipped with the
artifacts. Without a card the CLI exits non-zero unless `--device cpu` is
given.
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import sys
from pathlib import Path
from typing import Optional, Sequence

NOT_PORTED = {
    "int8": "--int8: int8 serving is not ported yet, ROADMAP Queue A item 13",
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--audio_seconds", type=float, default=4.0)
    p.add_argument("--buckets", default=None,
                   help="multi-bucket export: comma-separated audio_seconds:batch_size "
                        "pairs (e.g. '4:32,8:16,30:8'), one artifact per bucket under "
                        "out_dir plus an index.json; overrides --batch_size/--audio_seconds")
    p.add_argument("--autotune_buckets", type=int, default=None,
                   help="derive N bucket caps from --manifest's duration distribution "
                        "(data/bucketing.py) and export one artifact per cap at "
                        "--batch_size; alternative to --buckets")
    p.add_argument("--manifest", default=None,
                   help="jsonl manifest probed for --autotune_buckets")
    p.add_argument("--dataset_root", default=None,
                   help="override the checkpoint config's dataset_root when probing "
                        "--manifest durations")
    p.add_argument("--text_tokens", type=int, default=32)
    p.add_argument("--no_dsp", action="store_true",
                   help="expect precomputed quality/cond feats instead of running the "
                        "front-end DSP in the program")
    p.add_argument("--no_openmax", action="store_true")
    p.add_argument("--int8", action="store_true", help="not ported yet")
    p.add_argument("--wire", choices=["f32", "int16"], default="f32",
                   help="int16: the program takes raw int16 PCM + per-row lengths "
                        "(~4x fewer host->device bytes; exact for PCM sources)")
    p.add_argument("--device", default="cuda",
                   help="torch device to trace on and serve on (default cuda)")
    return p.parse_args(argv)


def parse_buckets(spec: str):
    try:
        return [(float(s), int(b)) for s, b in (pair.split(":") for pair in spec.split(","))]
    except ValueError:
        raise SystemExit("--buckets must look like '4:32,8:16' "
                         "(audio_seconds:batch_size pairs)") from None


def main(argv: Optional[Sequence[str]] = None) -> Path:
    """Run the CLI; returns the artifact directory."""
    args = parse_args(argv)
    for flag, message in NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(message)
    if args.autotune_buckets:
        if args.buckets:
            raise SystemExit("--autotune_buckets and --buckets are exclusive")
        if not args.manifest:
            raise SystemExit("--autotune_buckets needs --manifest")
    buckets = parse_buckets(args.buckets) if args.buckets else None

    from ..utils.runtime import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"export: {e} (--device cpu)") from e

    from .. import config as cfg_lib, export as ex
    from ..train import checkpoint as ckpt

    cfg_json = ckpt.load_config_json(args.checkpoint)
    cfg = cfg_lib.config_from_json(cfg_json) if cfg_json else cfg_lib.Config()
    params, meta = ckpt.restore_checkpoint(args.checkpoint, device=device)

    if args.autotune_buckets:
        from ..data import bucketing
        dcfg = cfg.data
        if args.dataset_root is not None:
            dcfg = dataclasses.replace(dcfg, dataset_root=args.dataset_root)
        caps, report = bucketing.autotune_from_manifest(args.manifest, dcfg,
                                                        args.autotune_buckets)
        print(report, f"caps={caps}")
        buckets = [(float(c), args.batch_size) for c in caps]

    common = dict(text_tokens=args.text_tokens, with_dsp=not args.no_dsp,
                  use_openmax=not args.no_openmax, wire=args.wire, config_json=cfg_json,
                  device=device)
    if buckets:
        art = ex.export_buckets(params, cfg.model, args.out_dir, buckets=buckets, **common)
        print(f"Exported {args.checkpoint} (epoch {meta.get('epoch')}) -> {art} "
              f"({len(buckets)} buckets, {device})")
    else:
        art = ex.export_forward(params, cfg.model, args.out_dir,
                                batch_size=args.batch_size,
                                audio_seconds=args.audio_seconds, **common)
        print(f"Exported {args.checkpoint} (epoch {meta.get('epoch')}) -> {art} ({device})")

    # ship the fitted temperature (the eval CLI's --save_temperature) with
    # the artifact, so the server serves calibrated probabilities
    cal = Path(args.checkpoint) / "calibration.json"
    if cal.exists():
        shutil.copy(cal, Path(args.out_dir) / "calibration.json")
        print(f"Shipped {cal} with the artifact")
    return Path(art)


if __name__ == "__main__":
    main(sys.argv[1:])

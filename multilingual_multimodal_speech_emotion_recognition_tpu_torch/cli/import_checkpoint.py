"""Import a reference checkpoint (torch .pt) into the port's format.

    python -m multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.import_checkpoint \\
        --reference_checkpoint epoch_5_f1_0.4884.pt --out checkpoints/imported

The port's counterpart of the repo's cli/import_checkpoint.py, with its
flags. The reference's trainers save one flat dict of 8 module state dicts
(plus optimizer, scheduler, epoch and f1); this writes a checkpoint
directory (train/checkpoint.py) that the port's eval, infer, export and
serve CLIs load, and `import_report.json` beside it. The model config is
read from the checkpoint's shapes and keys (models/ref_convert.py:
infer_model_config); head counts and conv strides are not in the shapes,
so the family's values are assumed, printed and recorded, and
--audio_heads / --text_heads / --conv_stride override them. The
conversion reads and writes files on the host and touches no device.
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
    p.add_argument("--reference_checkpoint", type=str, required=True,
                   help="the reference's .pt file")
    p.add_argument("--out", type=str, required=True,
                   help="the checkpoint directory to write (the port's format)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="compute dtype written into the imported config")
    p.add_argument("--use_asr", action="store_true",
                   help="enable the ASR feature path in the imported config")
    p.add_argument("--audio_heads", type=int, default=None,
                   help="the audio encoder's head count (not in the shapes)")
    p.add_argument("--text_heads", type=int, default=None,
                   help="the text encoder's head count (not in the shapes)")
    p.add_argument("--conv_stride", type=str, default=None,
                   help="the conv extractor's strides, e.g. '5,2,2,2,2,2,2' "
                        "(not in the shapes)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns the import report."""
    args = parse_args(argv)
    import torch

    from .. import config as cfg_lib
    from ..models import model as mdl, ref_convert
    from ..train import checkpoint as ckpt_lib

    ckpt = ref_convert.load_reference_checkpoint(args.reference_checkpoint)
    missing = [k for k in ref_convert.REFERENCE_MODULES if k not in ckpt]
    if missing:
        raise SystemExit(f"not a reference 8-module checkpoint (missing {missing}); "
                         "the legacy OpenMaxClassifier / Classifier-only checkpoints "
                         "are not supported")
    model_cfg = dataclasses.replace(ref_convert.infer_model_config(ckpt),
                                    compute_dtype=args.compute_dtype,
                                    use_asr=args.use_asr)
    audio_kw = {}
    if args.audio_heads is not None:
        audio_kw["num_attention_heads"] = args.audio_heads
    if args.conv_stride is not None:
        audio_kw["conv_stride"] = tuple(int(s) for s in args.conv_stride.split(","))
    if audio_kw:
        model_cfg = dataclasses.replace(
            model_cfg, audio=dataclasses.replace(model_cfg.audio, **audio_kw))
    if args.text_heads is not None:
        model_cfg = dataclasses.replace(
            model_cfg, text=dataclasses.replace(model_cfg.text,
                                                num_attention_heads=args.text_heads))
    if len(model_cfg.audio.conv_stride) != len(model_cfg.audio.conv_dim):
        raise SystemExit(f"conv_stride has {len(model_cfg.audio.conv_stride)} entries but "
                         f"the checkpoint carries {len(model_cfg.audio.conv_dim)} conv "
                         "layers: pass --conv_stride with one stride per layer")
    cfg = cfg_lib.Config(model=model_cfg)

    init = mdl.init_model(model_cfg, torch.Generator().manual_seed(0), device="cpu")
    params, report = ref_convert.params_from_reference_checkpoint(ckpt, model_cfg, init)
    report["assumed"] = {
        "audio_heads": model_cfg.audio.num_attention_heads,
        "text_heads": model_cfg.text.num_attention_heads,
        "conv_stride": list(model_cfg.audio.conv_stride),
        "note": "head counts and conv strides are not derivable from the "
                "checkpoint's tensor shapes; these are the family-rule "
                "values (or your overrides) — wrong heads change attention "
                "math, wrong strides change frame geometry",
    }
    out = ckpt_lib.save_checkpoint(
        args.out, params=params, epoch=report["epoch"], f1=report["f1"],
        config_json=cfg_lib.to_json(cfg),
        extra={"imported_from": str(args.reference_checkpoint)})
    (Path(out) / "import_report.json").write_text(json.dumps(report, indent=2))

    print(f"Imported {args.reference_checkpoint} -> {out}")
    print(f"  epoch={report['epoch']} f1={report['f1']:.4f} "
          f"num_labels={model_cfg.num_labels} "
          f"classifier_layers={model_cfg.classifier_layers} "
          f"audio_hidden={model_cfg.audio_hidden}")
    print(f"  imported subtrees: {len(report['imported'])}")
    print(f"  assumed (not shape-derivable, override via flags): "
          f"audio_heads={report['assumed']['audio_heads']} "
          f"text_heads={report['assumed']['text_heads']} "
          f"conv_stride={report['assumed']['conv_stride']}")
    if report["left_at_init"]:
        print(f"  left at fresh init (absent in the reference checkpoint): "
              f"{report['left_at_init']}")
    if report["skipped"]:
        print(f"  skipped reference tensors (dead/unmappable): {report['skipped'][:6]}"
              f"{' ...' if len(report['skipped']) > 6 else ''}")
    return report


if __name__ == "__main__":
    main(sys.argv[1:])

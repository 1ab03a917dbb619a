"""Export a port checkpoint in the reference's torch .pt layout.

    python -m multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.export_torch \\
        --checkpoint checkpoints/epoch_4_f1_0.7123 --out reference_format.pt

The port's counterpart of the repo's cli/export_torch.py (the file keeps
that name), and the inverse of cli/import_checkpoint.py: one flat dict of
the reference's 8 module state dicts, with empty optimizer and scheduler
state and the checkpoint's epoch and f1, which the reference's own eval
and interface load. Tensors the reference needs and the port does not
carry (the encoders' dead pools, the sibling fusions beside
combined_fusion, the XLM-R pooler) are written as zeros: they never reach
a reference forward. Runs on the host.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from ..models.ref_convert import POS_CONV_STYLES
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", type=str, required=True,
                   help="checkpoint directory in the port's format")
    p.add_argument("--out", type=str, required=True, help="the .pt file to write")
    p.add_argument("--pos_conv_style", default="parametrizations",
                   choices=list(POS_CONV_STYLES),
                   help="how the positional conv's weight norm is written "
                        "(torch >= 2.1 loads 'parametrizations'; older torch "
                        "'weight_norm')")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns the dict it saved."""
    args = parse_args(argv)
    import torch

    from .. import config as cfg_lib
    from ..models import ref_convert
    from ..train import checkpoint as ckpt_lib

    cfg_json = ckpt_lib.load_config_json(args.checkpoint)
    cfg = cfg_lib.config_from_json(cfg_json) if cfg_json else cfg_lib.Config()
    params, meta = ckpt_lib.restore_checkpoint(args.checkpoint, device="cpu")
    ckpt = ref_convert.reference_state_dicts_from_params(
        params, cfg.model, pos_conv_style=args.pos_conv_style)
    ckpt["optimizer"] = {"state": {}, "param_groups": []}
    ckpt["scheduler"] = {}
    ckpt["epoch"] = int(meta.get("epoch", 0))
    ckpt["f1"] = float(meta.get("f1", 0.0))
    torch.save(ckpt, args.out)
    n = sum(len(sd) for sd in ckpt.values() if isinstance(sd, dict))
    print(f"Exported {args.checkpoint} -> {args.out} "
          f"({n} tensors, epoch={ckpt['epoch']}, f1={ckpt['f1']:.4f})")
    return ckpt


if __name__ == "__main__":
    main(sys.argv[1:])

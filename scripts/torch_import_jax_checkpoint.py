#!/usr/bin/env python3
"""Convert a JAX package checkpoint into the PyTorch port's format.

    python scripts/torch_import_jax_checkpoint.py JAX_CHECKPOINT_DIR OUT_DIR

Runs where JAX is installed (as the tests do): it reads the checkpoint with
the JAX package's train/checkpoint.py:restore_checkpoint (orbax or pickle),
moves the parameters through the port's weight bridge
(weights.params_from_jax, strict: every leaf consumed, every shape
checked) and writes them with the port's save_checkpoint, copying
config.json and meta.json. Optimizer state is not carried over. The port
itself imports no JAX; score the result on the card with

    python -m multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.eval \\
        --checkpoint OUT_DIR --manifest test.jsonl ...
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

ROOT = Path(__file__).resolve().parents[1]


def convert(jax_dir: str, out_dir: str) -> Path:
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import jax
    import numpy as np

    from multilingual_multimodal_speech_emotion_recognition_tpu.train import (
        checkpoint as jckpt)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch import (
        config as tcfg, weights)
    from multilingual_multimodal_speech_emotion_recognition_tpu_torch.train import (
        checkpoint as tckpt)

    config_json = jckpt.load_config_json(jax_dir)
    cfg = tcfg.config_from_json(config_json) if config_json else tcfg.Config()
    params, _, meta = jckpt.restore_checkpoint(jax_dir)
    params = jax.tree.map(np.asarray, params)
    tparams = weights.params_from_jax(params, cfg.model, device="cpu")
    extra = {k: v for k, v in meta.items() if k not in ("step", "epoch", "f1")}
    extra["converted_from"] = str(Path(jax_dir).resolve())
    return tckpt.save_checkpoint(out_dir, params=tparams, step=meta.get("step", 0),
                                 epoch=meta.get("epoch", 0), f1=meta.get("f1", 0.0),
                                 config_json=config_json, extra=extra)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("jax_checkpoint")
    p.add_argument("out")
    args = p.parse_args(argv)
    out = convert(args.jax_checkpoint, args.out)
    print(json.dumps({"converted": args.jax_checkpoint, "to": str(out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving CLI of the port: a long-lived HTTP server over export artifacts.

    python -m multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.export \\
        --checkpoint ckpt_dir --out_dir export --buckets 4:32,8:16
    python -m multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.serve \\
        --artifact export --port 8080

    curl -s localhost:8080/healthz
    curl -s -X POST localhost:8080/predict \\
        -d '{"audio": [0.0, 0.01, ...], "sample_rate": 16000, "text": "I am so happy today"}'

The flags are the repo's cli/serve.py's, with `--device` (default cuda) in
place of `--platform`: it must be the device the artifacts were exported
on. Without a card the CLI exits non-zero unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--artifact", required=True,
                   help="single artifact dir (spec.json) or bucketed export dir "
                        "(index.json)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max_wait_ms", type=float, default=15.0,
                   help="micro-batch deadline: a lone request waits at most this long "
                        "for co-batching")
    p.add_argument("--tokenizer", default="xlm-roberta-base")
    p.add_argument("--vocab_size", type=int, default=250002,
                   help="hash-fallback tokenizer vocab; must match the artifact's "
                        "embedding table")
    p.add_argument("--no_preload", action="store_true",
                   help="load bucket programs lazily on first hit instead of at startup")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda); the artifacts' own")
    p.add_argument("--cascade_teacher", default=None,
                   help="teacher artifact dir: --artifact becomes the (distilled) "
                        "student tier and low-confidence requests escalate to the "
                        "teacher (CascadeServer)")
    p.add_argument("--confidence_threshold", type=float, default=0.8,
                   help="cascade: escalate when student max-prob is below")
    p.add_argument("--energy_threshold", type=float, default=None,
                   help="cascade: also escalate when the raw-logit energy OOD score is "
                        "above this")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    from ..utils.runtime import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"serve: {e} (--device cpu)") from e

    from .. import serving
    from ..data.tokenizer import get_tokenizer

    serving.serve(args.artifact, host=args.host, port=args.port,
                  max_wait_ms=args.max_wait_ms, preload=not args.no_preload,
                  tokenizer=get_tokenizer(args.tokenizer, vocab_size=args.vocab_size),
                  cascade_teacher_dir=args.cascade_teacher,
                  confidence_threshold=args.confidence_threshold,
                  energy_threshold=args.energy_threshold, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])

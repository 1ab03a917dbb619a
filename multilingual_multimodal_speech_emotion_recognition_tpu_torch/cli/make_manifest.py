"""Make and split jsonl manifests from dataset folders.

    python -m multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.make_manifest \\
        --root datasets --datasets crema ravdess --split speaker --out_prefix manifest

The port's counterpart of the repo's cli/make_manifest.py, with its flags,
over data/manifest.py: labels from CREMA-D / RAVDESS / TESS file names, an
optional size filter, and a stratified or a speaker-disjoint 70/20/10
split (or none) into {out_prefix}_{train,val,test}.jsonl. The size filter
looks the entries up where they are, under the root's parent (the repo's
CLI joins them to the root itself, so its filter drops every entry).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True, help="datasets root directory")
    p.add_argument("--datasets", nargs="+", default=["crema"],
                   choices=["crema", "ravdess", "tess"])
    p.add_argument("--num_classes", type=int, default=4, choices=[4, 6])
    p.add_argument("--out_prefix", default="manifest")
    p.add_argument("--split", choices=["none", "stratified", "speaker"], default="stratified")
    p.add_argument("--ratios", nargs=3, type=float, default=[0.7, 0.2, 0.1])
    p.add_argument("--min_bytes", type=int, default=None,
                   help="drop files smaller than this (corruption filter)")
    p.add_argument("--seed", type=int, default=42)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, list]:
    """Run the CLI; returns {path written: its items}."""
    args = parse_args(argv)
    from ..data import manifest as man

    items = []
    for ds in args.datasets:
        found = man.scan_dataset(args.root, ds, num_classes=args.num_classes)
        print(f"{ds}: {len(found)} items")
        items.extend(found)
    if args.min_bytes:
        # the entries' paths are relative to the root's parent (scan_dataset)
        items = man.filter_by_size(items, Path(args.root).parent, min_bytes=args.min_bytes)
        print(f"after size filter: {len(items)}")
    print(f"class distribution: {man.class_distribution(items)}")
    if args.split == "none":
        outputs = {f"{args.out_prefix}.jsonl": items}
    else:
        split = man.stratified_split if args.split == "stratified" else man.speaker_disjoint_split
        subsets = split(items, ratios=tuple(args.ratios), seed=args.seed)
        outputs = {f"{args.out_prefix}_{name}.jsonl": subset
                   for name, subset in zip(("train", "val", "test"), subsets)}
    for path, subset in outputs.items():
        man.write_manifest(path, subset)
        print(f"wrote {path} ({len(subset)})")
    return outputs


if __name__ == "__main__":
    main(sys.argv[1:])

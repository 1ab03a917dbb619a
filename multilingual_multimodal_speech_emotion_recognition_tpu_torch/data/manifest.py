"""Manifest (jsonl) I/O, label maps, and manifest-creation tooling.

A copy of the JAX package's data/manifest.py (numpy and the standard
library only), kept here so that the port imports nothing of that package.
Parity targets of the reference:
  * jsonl schema {"audio", "text", "label", ["dataset"]} —
    src/data/dataset.py:5-23 and the shipped
    crema_{train_70,val_20,test_10}.jsonl fixtures.
  * 6-class CREMA map — src/create_crema_manifest.py:19-27
    (0 angry, 1 happy, 2 sad, 3 neutral, 4 disgust, 5 fear).
  * 4-class comprehensive map (TESS/CREMA/RAVDESS collapsed) —
    src/data/create_comprehensive_manifest.py:15-80.
  * speaker-disjoint splits — src/data/dataset_loader.py:162-189.
  * stratified 70/20/10 split — src/data/split_manifests.py:14-57.
"""

from __future__ import annotations

import json
import random
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

# ---------------------------------------------------------------------------
# label maps
# ---------------------------------------------------------------------------

CREMA_SIX_CLASS = {"ANG": 0, "HAP": 1, "SAD": 2, "NEU": 3, "DIS": 4, "FEA": 5}
SIX_CLASS_NAMES = ["angry", "happy", "sad", "neutral", "disgust", "fear"]
FOUR_CLASS_NAMES = ["angry", "happy", "sad", "neutral"]

# 4-class collapse used by the comprehensive manifest
CREMA_FOUR_CLASS = {"ANG": 0, "DIS": 0, "FEA": 0, "HAP": 1, "SAD": 2, "NEU": 3}
TESS_FOUR_CLASS = {"angry": 0, "disgust": 0, "fear": 0, "happy": 1,
                   "pleasant_surprised": 1, "sad": 2, "neutral": 3}
RAVDESS_CODE_FOUR_CLASS = {"01": 3, "02": 1, "03": 1, "04": 2,
                           "05": 0, "06": 0, "07": 0, "08": 1}


def read_manifest(path: str | Path) -> List[dict]:
    items = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                items.append(json.loads(line))
    return items


def write_manifest(path: str | Path, items: Iterable[dict]) -> None:
    with open(path, "w") as f:
        for item in items:
            f.write(json.dumps(item) + "\n")


# ---------------------------------------------------------------------------
# filename parsing
# ---------------------------------------------------------------------------

def crema_label(filename: str, num_classes: int = 6) -> int:
    """CREMA filename: ActorID_Sentence_Emotion_Intensity.wav."""
    parts = Path(filename).name.split("_")
    code = parts[2].upper() if len(parts) >= 3 else "NEU"
    table = CREMA_SIX_CLASS if num_classes == 6 else CREMA_FOUR_CLASS
    return table.get(code, 3)


def crema_speaker(filename: str) -> str:
    return Path(filename).name.split("_")[0]


def ravdess_label(filename: str) -> int:
    """RAVDESS filename: 03-01-<emotion>-01-01-01-<actor>.wav (4-class)."""
    parts = Path(filename).stem.split("-")
    return RAVDESS_CODE_FOUR_CLASS.get(parts[2], 3) if len(parts) >= 3 else 3


def ravdess_speaker(filename: str) -> str:
    parts = Path(filename).stem.split("-")
    return parts[-1] if parts else "unknown"


def tess_label(filename: str) -> int:
    name = Path(filename).name.lower()
    for emotion, label in TESS_FOUR_CLASS.items():
        if emotion in name:
            return label
    return 3


# ---------------------------------------------------------------------------
# manifest creation
# ---------------------------------------------------------------------------

def scan_dataset(root: str | Path, dataset: str, *, num_classes: int = 4,
                 text_template: str = "Audio sample from {dataset} dataset") -> List[dict]:
    """Scan `root` for wavs of a known dataset and build manifest entries."""
    root = Path(root)
    entries = []
    parse = {
        "crema": lambda f: crema_label(f, num_classes),
        "ravdess": ravdess_label,
        "tess": tess_label,
    }[dataset]
    speaker = {
        "crema": crema_speaker,
        "ravdess": ravdess_speaker,
        "tess": lambda f: Path(f).name.split("_")[0],
    }[dataset]
    for wav in sorted(root.rglob("*.wav")):
        entries.append({
            "audio": str(wav.relative_to(root.parent)) if root.parent != wav.parent
            else wav.name,
            "text": text_template.format(dataset=dataset.upper()),
            "label": parse(wav.name),
            "dataset": dataset,
            "speaker": speaker(wav.name),
        })
    return entries


def stratified_split(items: Sequence[dict], *, ratios=(0.7, 0.2, 0.1),
                     seed: int = 42,
                     strata_keys: Tuple[str, ...] = ("dataset", "label")
                     ) -> Tuple[List[dict], List[dict], List[dict]]:
    """Balanced split stratified by dataset x emotion (split_manifests.py:14-57)."""
    rng = random.Random(seed)
    groups: Dict[tuple, List[dict]] = defaultdict(list)
    for it in items:
        groups[tuple(it.get(k) for k in strata_keys)].append(it)
    train, val, test = [], [], []
    for _, files in sorted(groups.items(), key=lambda kv: str(kv[0])):
        files = list(files)
        rng.shuffle(files)
        n = len(files)
        a = int(ratios[0] * n)
        b = int((ratios[0] + ratios[1]) * n)
        train.extend(files[:a])
        val.extend(files[a:b])
        test.extend(files[b:])
    for part in (train, val, test):
        rng.shuffle(part)
    return train, val, test


def speaker_disjoint_split(items: Sequence[dict], *, ratios=(0.7, 0.2, 0.1),
                           seed: int = 42, speaker_key: str = "speaker"
                           ) -> Tuple[List[dict], List[dict], List[dict]]:
    """Split by whole speakers so no speaker crosses partitions
    (dataset_loader.py:162-189)."""
    rng = random.Random(seed)
    speakers = sorted({it.get(speaker_key, "unknown") for it in items})
    rng.shuffle(speakers)
    n = len(speakers)
    a = int(ratios[0] * n)
    b = int((ratios[0] + ratios[1]) * n)
    sets = (set(speakers[:a]), set(speakers[a:b]), set(speakers[b:]))
    parts: Tuple[List[dict], ...] = ([], [], [])
    for it in items:
        s = it.get(speaker_key, "unknown")
        for i, ss in enumerate(sets):
            if s in ss:
                parts[i].append(it)
                break
    return parts


def class_distribution(items: Sequence[dict]) -> Dict[int, int]:
    dist: Dict[int, int] = defaultdict(int)
    for it in items:
        dist[int(it["label"])] += 1
    return dict(sorted(dist.items()))


def filter_by_size(items: Sequence[dict], root: str | Path,
                   min_bytes: int = 1000) -> List[dict]:
    """Drop entries whose audio file is missing or suspiciously small
    (create_filtered_manifest.py:14-49 corrupted-file filtering)."""
    root = Path(root)
    out = []
    for it in items:
        p = root / it["audio"]
        try:
            if p.stat().st_size >= min_bytes:
                out.append(it)
        except OSError:
            pass
    return out

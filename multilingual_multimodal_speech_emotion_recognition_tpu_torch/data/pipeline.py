"""Host input pipeline: manifest -> bucketed, padded, fixed-shape batches.

Counterpart of the JAX package's data/pipeline.py, with the same batches
row for row: clips are bucketed by duration into DataConfig.audio_buckets
and padded to the bucket cap, text is tokenized to a fixed length, audio
is decoded on background threads (one native call per batch where the
native decoder builds), and the final partial batch is padded with masked
rows (`example_mask`) so that eval sees every clip exactly once. Batches
are dicts of numpy arrays; data/prefetch.py moves them to the device.
"""

from __future__ import annotations

import concurrent.futures as cf
import wave
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..config import DataConfig
from ..frontend import lid as lid_mod
from . import audio_io, bucketing, manifest as manifest_lib, native
from .tokenizer import Tokenizer, get_tokenizer

# batch keys that stay on the host: eval steps also drop labels
TRAIN_HOST_KEYS = ("example_mask", "indices")
EVAL_HOST_KEYS = ("labels", "example_mask", "indices")


class SERDataset:
    """Manifest-backed dataset (the reference's src/data/dataset.py:5-23)."""

    def __init__(self, manifest_path: str, data_cfg: Optional[DataConfig] = None):
        self.cfg = data_cfg or DataConfig()
        self.items = manifest_lib.read_manifest(manifest_path)

    def __len__(self) -> int:
        return len(self.items)

    def audio_length(self, idx: int) -> int:
        """Duration probe for bucketing. Fast path: the WAV header. Non-WAV
        or unreadable files fall back to the decoded length via load_audio,
        whose zeros-on-error fallback is what load() later returns, so the
        bucket always matches the data and no clip is truncated by a
        mis-probed bucket."""
        cfg = self.cfg
        p = Path(self.items[idx]["audio"])
        if cfg.dataset_root and not p.is_absolute() \
                and not str(p).startswith(cfg.dataset_root):
            p = Path(cfg.dataset_root) / p
        info = native.wav_info(p) if native.available() else None
        if info is None:
            try:
                with wave.open(str(p), "rb") as w:
                    info = w.getnframes(), w.getframerate()
            except (OSError, EOFError, wave.Error):
                wav, _, _ = self.load(idx)
                return len(wav)
        n, sr = info
        n = int(n * cfg.sample_rate / sr)
        n = min(n, int(cfg.sample_rate * cfg.max_audio_seconds))
        return max(n, int(cfg.sample_rate * cfg.min_audio_seconds))

    def load(self, idx: int):
        it = self.items[idx]
        audio = audio_io.load_audio(
            it["audio"], sr=self.cfg.sample_rate,
            max_length=self.cfg.max_audio_seconds,
            min_length=self.cfg.min_audio_seconds,
            dataset_root=self.cfg.dataset_root)
        return audio, it.get("text", ""), int(it["label"])


class BucketedLoader:
    """Epoch iterator yielding dicts of fixed-shape numpy arrays.

    `decoder` records which WAV decoder the last epoch used: "native" (the
    repo's native/wav_decoder.cc, built by data/native.py) or "python"
    (audio_io's stdlib decoder, where the native one does not build)."""

    def __init__(self, dataset: SERDataset, *, batch_size: int,
                 tokenizer: Optional[Tokenizer] = None,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = False,
                 num_workers: int = 8):
        self.ds = dataset
        self.batch_size = batch_size
        # rows of each yielded batch: batch_size, or a rank's share of it
        # (parallel/multihost.HostShardedLoader)
        self.batch_rows = batch_size
        self.tokenizer = tokenizer or get_tokenizer()
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.num_workers = num_workers
        self.decoder: Optional[str] = None
        self._asr_integration = None
        cfg = dataset.cfg
        self.bucket_samples = [bucketing.seconds_to_samples(b, cfg.sample_rate)
                               for b in cfg.audio_buckets]
        self._lengths = [dataset.audio_length(i) for i in range(len(dataset))]

    def _bucket_of(self, length: int) -> int:
        for bi, cap in enumerate(self.bucket_samples):
            if length <= cap:
                return bi
        return len(self.bucket_samples) - 1

    def batches_per_epoch(self) -> int:
        counts: Dict[int, int] = {}
        for L in self._lengths:
            b = self._bucket_of(L)
            counts[b] = counts.get(b, 0) + 1
        return sum(c // self.batch_size if self.drop_remainder else -(-c // self.batch_size)
                   for c in counts.values())

    def _plan(self, epoch_idx: int) -> List[tuple]:
        """Deterministic epoch plan [(bucket_idx, [dataset indices])]: it
        depends only on the manifest order, the seed and the epoch."""
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch_idx)
            rng.shuffle(order)

        buckets: Dict[int, List[int]] = {}
        for i in order:
            buckets.setdefault(self._bucket_of(self._lengths[i]), []).append(int(i))

        # interleave batches from all buckets in shuffled order
        batch_plans = []
        for bi, idxs in buckets.items():
            for s in range(0, len(idxs), self.batch_size):
                chunk = idxs[s:s + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_remainder:
                    continue
                batch_plans.append((bi, chunk))
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 7919 + epoch_idx)
            rng.shuffle(batch_plans)
        return batch_plans

    def epoch(self, epoch_idx: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        return self._iter_plans(self._plan(epoch_idx))

    def _iter_plans(self, batch_plans: List[tuple]) -> Iterator[Dict[str, np.ndarray]]:
        use_native = native.available()
        self.decoder = "native" if use_native else "python"

        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            # two-deep pipelining: the next batch decodes while the current
            # one is consumed. With the native decoder a batch is one C call
            # (its own threads, no GIL between files); otherwise one Python
            # decode per file.
            def submit(plan):
                bi, idxs = plan
                if use_native:
                    return [pool.submit(self._load_rows_native, bi, idxs)]
                return [pool.submit(self.ds.load, i) for i in idxs]

            def collect(futs):
                if use_native:
                    return futs[0].result()
                return [f.result() for f in futs]

            pending = None
            for plan in batch_plans:
                nxt = (plan[0], plan[1], submit(plan))
                if pending is not None:
                    bi, idxs, futs = pending
                    yield self._assemble(bi, collect(futs), idxs)
                pending = nxt
            if pending is not None:
                bi, idxs, futs = pending
                yield self._assemble(bi, collect(futs), idxs)

    def _load_rows_native(self, bucket_idx: int, idxs: List[int]) -> list:
        """Decode a whole batch with one native call; rows the C decoder
        cannot handle (non-WAV container, resampling, a corrupt file) go to
        the Python loader, with the same semantics."""
        cfg = self.ds.cfg
        T = self.bucket_samples[bucket_idx]
        sr = cfg.sample_rate
        paths = [audio_io.resolve_path(self.ds.items[i]["audio"], cfg.dataset_root)
                 for i in idxs]
        audio = np.zeros((len(idxs), T), np.float32)
        lens, sts = native.decode_batch(
            [str(p) for p in paths], audio, target_sr=sr,
            min_samples=int(sr * cfg.min_audio_seconds),
            n_threads=self.num_workers)
        out = []
        for r, i in enumerate(idxs):
            it = self.ds.items[i]
            if sts[r] == native.OK:
                wav = audio[r, : int(lens[r])]
            elif sts[r] == native.OPEN_FAILED and not paths[r].exists():
                print(f"Error loading {paths[r]}: file not found")
                wav = np.zeros(sr, np.float32)  # the reference's preprocess.py:44-47
            else:
                wav, _, _ = self.ds.load(i)
            out.append((wav, it.get("text", ""), int(it["label"])))
        return out

    def _assemble(self, bucket_idx: int, loaded: list, idxs: List[int]) -> dict:
        T = self.bucket_samples[bucket_idx]
        if self.ds.cfg.pad_to_batch_max and loaded:
            # the reference's eager padding: the batch's longest clip, not the cap
            T = min(T, max(len(w) for w, _, _ in loaded))
        B = self.batch_rows

        audio = np.zeros((B, T), np.float32)
        audio_mask = np.zeros((B, T), np.float32)
        labels = np.zeros((B,), np.int32)
        example_mask = np.zeros((B,), np.float32)
        indices = np.full((B,), -1, np.int32)
        texts = [""] * B
        for r, (wav, text, label) in enumerate(loaded):
            L = min(len(wav), T)
            audio[r, :L] = wav[:L]
            audio_mask[r, :L] = 1.0
            labels[r] = label
            texts[r] = text
            example_mask[r] = 1.0
            indices[r] = idxs[r]
        # padded rows stay valid inputs (a fully masked row would give NaN in
        # a masked softmax): one valid audio sample and BOS/EOS text
        for r in range(len(loaded), B):
            audio_mask[r, 0] = 1.0

        # host-side language ID scalars for the device quality gates;
        # gates_see_text=False gives every row the no-text constants
        if self.ds.cfg.gates_see_text:
            ents, _, confs = lid_mod.batch_lid(texts)
        else:
            ents, confs = [1.0] * B, [0.0] * B
        ids, tmask = self.tokenizer.encode_batch(texts, self.ds.cfg.max_text_tokens)
        batch = {
            "audio": audio, "audio_mask": audio_mask,
            "text_ids": ids, "text_mask": tmask,
            "lid_entropy": np.asarray(ents, np.float32),
            "lid_conf": np.asarray(confs, np.float32),
            "labels": labels, "example_mask": example_mask,
            "indices": indices,
        }
        if self.ds.cfg.emit_asr_feats:
            # the 8-dim ASR features on the host (frontend/asr.py); with
            # manifest text present no transcription backend is invoked
            asr = self._asr()
            feats = np.zeros((B, 8), np.float32)
            for r in range(len(loaded)):
                valid = int(audio_mask[r].sum())
                res = asr.process(audio[r, :valid], self.ds.cfg.sample_rate,
                                  text=texts[r] or None)
                feats[r] = res.asr_features
            batch["asr_feats"] = feats
        return batch

    def _asr(self):
        if self._asr_integration is None:
            from ..frontend import asr as asr_mod
            self._asr_integration = asr_mod.EnhancedASRIntegration()
        return self._asr_integration

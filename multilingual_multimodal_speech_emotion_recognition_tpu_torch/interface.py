"""Single-sample / batched inference over a checkpoint of the port.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
interface.py: `EmotionRecognitionInterface` loads a checkpoint
(train/checkpoint.py) once; `predict_emotion(audio_path, text, use_tta,
return_detailed)` gives predictions, probabilities, confidence,
uncertainty, raw logits, labels and modality flags, with the detailed
analysis (top-k, entropy, margin, calibration error, confidence flags),
the missing-modality fill (1 s of silence, empty text), feature-averaging
TTA, the matplotlib figure, the JSON export and the CLI (`main`).

Every forward is the eval forward under torch.inference_mode(), on the
card unless the caller passes device="cpu"; the classifier's residual
stack launches kernel A1 there.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .config import Config, config_from_json
from .data import audio_io
from .data.tokenizer import Tokenizer, get_tokenizer
from .frontend import lid as lid_mod
from .models import model as mdl
from .ops import audio_dsp
from .train import checkpoint as ckpt_lib
from .utils.runtime import resolve_device, to_device

EMOTION_LABELS_4 = ["angry", "happy", "sad", "neutral"]
EMOTION_LABELS_6 = ["angry", "happy", "sad", "neutral", "disgust", "fear"]
INT8_NOT_PORTED = "int8 serving is not ported yet, ROADMAP Queue A item 13"


class EmotionRecognitionInterface:
    """Loads a checkpoint once; `predict_emotion` runs single samples,
    `predict_batch` runs lists."""

    def __init__(self, checkpoint_path: str, *, config: Optional[Config] = None,
                 tokenizer: Optional[Tokenizer] = None, quantize_int8: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        if quantize_int8:
            raise NotImplementedError(INT8_NOT_PORTED)
        self.device = resolve_device(device)
        cfg_json = ckpt_lib.load_config_json(checkpoint_path)
        self.cfg = config or (config_from_json(cfg_json) if cfg_json else Config())
        self.params, self.meta = ckpt_lib.restore_checkpoint(checkpoint_path,
                                                             device=self.device)
        self.tokenizer = tokenizer or get_tokenizer(
            vocab_size=self.cfg.model.text.vocab_size)
        # calibration persisted by the eval CLI (`--calibrate
        # --save_temperature`): it divides the logits before the softmax, so
        # reported probabilities are calibrated (the serving daemon's rule)
        self.temperature = 1.0
        cal = Path(checkpoint_path) / "calibration.json"
        if cal.exists():
            t = float(json.loads(cal.read_text()).get("temperature", 1.0))
            if not (np.isfinite(t) and t > 0.0):
                raise ValueError(f"{cal}: temperature must be a positive finite "
                                 f"number, got {t}")
            self.temperature = t
        n = self.cfg.model.num_labels
        self.emotion_labels = (EMOTION_LABELS_6 if n == 6 else EMOTION_LABELS_4)[:n]

    # ------------------------------------------------------------ forward

    @torch.inference_mode()
    def _fwd(self, batch: dict):
        out = mdl.model_forward(self.params, self.cfg.model, batch, deterministic=True,
                                use_openmax=True)
        return out.logits, out.uncertainty, out.anchor_loss

    @torch.inference_mode()
    def _fwd_tta(self, batch: dict, num_tta: int, generator: torch.Generator,
                 noise: Optional[Sequence] = None):
        """Feature-averaging TTA: encode the audio views (original, speed
        0.9 / 1.1, noise at 15 / 20 dB; the interface's factors, not the
        eval step's), average the audio sequence features over the views,
        then run cross-attention, pooling, fusion and the classifier once
        on the average, with view 0's frame mask. The text is encoded once.
        `noise`, where given, holds the noise views' standard-normal draws."""
        cfg = self.cfg.model
        wave, mask = audio_dsp.tta_expand(
            batch["audio"], batch["audio_mask"], num_tta=num_tta, speed_factors=(0.9, 1.1),
            generator=generator,
            noise=None if noise is None else [to_device(n, self.device) for n in noise])
        tile = lambda x: torch.cat([x] * num_tta, dim=0)
        big = {**{k: tile(v) for k, v in batch.items() if k not in ("audio", "audio_mask")},
               "audio": wave, "audio_mask": mask}
        wave, qf, cf = mdl.frontend_features(cfg, big)

        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        p = mdl.encoder_params(self.params, cfg)
        a_seq, a_fm = mdl.encode_audio(p, cfg, wave.to(dtype), mask, quality_feats=qf,
                                       cond_feats=cf, deterministic=True)
        B = batch["audio"].shape[0]
        a_seq = a_seq.reshape(num_tta, B, *a_seq.shape[1:]).mean(0)
        a_fm = a_fm.reshape(num_tta, B, -1)[0]
        t_seq, t_mask = mdl.encode_text(p, cfg, batch["text_ids"], batch["text_mask"],
                                        asr_feats=batch.get("asr_feats"), deterministic=True)
        out = mdl.model_heads(self.params, cfg, a_seq, a_fm, t_seq, t_mask,
                              deterministic=True, use_openmax=True)
        return out.logits, out.uncertainty, out.anchor_loss

    # ------------------------------------------------------- preprocessing

    def preprocess_audio(self, audio_path: Optional[str]) -> np.ndarray:
        """Load, mono, resample, peak-normalise; a missing modality becomes
        1 s of silence."""
        if audio_path is None:
            return np.zeros(self.cfg.data.sample_rate, np.float32)
        wav = audio_io.load_audio(audio_path, sr=self.cfg.data.sample_rate,
                                  max_length=self.cfg.data.max_audio_seconds,
                                  min_length=self.cfg.data.min_audio_seconds,
                                  dataset_root=None)
        peak = np.abs(wav).max()
        return (wav / peak).astype(np.float32) if peak > 0 else wav

    def _make_batch(self, waves: List[np.ndarray], texts: List[str]) -> Dict:
        T = max(len(w) for w in waves)
        B = len(waves)
        audio = np.zeros((B, T), np.float32)
        mask = np.zeros((B, T), np.float32)
        for i, w in enumerate(waves):
            audio[i, :len(w)] = w
            mask[i, :len(w)] = 1.0
        ids, tmask = self.tokenizer.encode_batch(texts, self.cfg.data.max_text_tokens)
        ents, _, confs = lid_mod.batch_lid(texts)
        host = {"audio": audio, "audio_mask": mask, "text_ids": np.asarray(ids),
                "text_mask": np.asarray(tmask, np.float32),
                "lid_entropy": np.asarray(ents, np.float32),
                "lid_conf": np.asarray(confs, np.float32)}
        return {k: to_device(v, self.device) for k, v in host.items()}

    # ----------------------------------------------------------- prediction

    def predict_emotion(self, audio_path: Optional[str] = None,
                        text: Optional[str] = None, *, use_tta: bool = False,
                        num_tta: int = 5, return_detailed: bool = True,
                        seed: int = 0) -> Dict:
        return self.predict_batch([audio_path], [text], use_tta=use_tta, num_tta=num_tta,
                                  return_detailed=return_detailed, seed=seed)

    def predict_batch(self, audio_paths: List[Optional[str]], texts: List[Optional[str]],
                      *, use_tta: bool = False, num_tta: int = 5,
                      return_detailed: bool = True, seed: int = 0,
                      noise: Optional[Sequence] = None) -> Dict:
        """`seed` seeds the TTA noise views' generator; `noise` gives their
        draws instead."""
        waves = [self.preprocess_audio(p) for p in audio_paths]
        batch = self._make_batch(waves, [t or "" for t in texts])
        if use_tta:
            generator = torch.Generator(device=self.device).manual_seed(seed)
            logits, uncertainty, anchor = self._fwd_tta(batch, num_tta, generator, noise)
        else:
            logits, uncertainty, anchor = self._fwd(batch)
        # the temperature divides only the softmax input; "logits" stay the
        # raw model logits (energy scores, re-fitting a temperature, the
        # figure's raw-logit panel read them)
        logits = logits.double().cpu().numpy()
        scaled = logits / self.temperature
        uncertainty = uncertainty.double().cpu().numpy()
        e = np.exp(scaled - scaled.max(axis=1, keepdims=True))
        probs = e / e.sum(axis=1, keepdims=True)
        preds = scaled.argmax(axis=1)
        results = {
            "predictions": preds,
            "probabilities": probs,
            "confidence": probs.max(axis=1),
            "uncertainty": uncertainty,
            "logits": logits,
            "anchor_loss": float(anchor),
            "emotion_labels": [self.emotion_labels[p] for p in preds],
            "modalities": {
                "audio": any(p is not None for p in audio_paths),
                "text": any(t for t in texts),
            },
        }
        if return_detailed:
            results.update(self._detailed_analysis(probs, uncertainty))
        return results

    def _detailed_analysis(self, probs: np.ndarray, uncertainty: np.ndarray) -> Dict:
        """Top-k, entropy, margin and calibration flags."""
        k = min(2, probs.shape[1])
        top_idx = np.argsort(-probs, axis=1)[:, :k]
        top_probs = np.take_along_axis(probs, top_idx, axis=1)
        entropy = -np.sum(probs * np.log(probs + 1e-8), axis=1)
        margin = (top_probs[:, 0] - top_probs[:, 1]) if k > 1 else np.ones(len(probs))
        conf_from_unc = 1.0 - uncertainty.squeeze(-1)
        calibration_error = float(np.mean(np.abs(probs.max(1) - conf_from_unc)))
        return {
            "top_k_predictions": {
                "indices": top_idx,
                "probabilities": top_probs,
                "labels": [[self.emotion_labels[i] for i in row] for row in top_idx],
            },
            "entropy": entropy,
            "margin": margin,
            "calibration_error": calibration_error,
            "analysis": {
                "high_confidence": conf_from_unc > 0.8,
                "low_confidence": conf_from_unc < 0.5,
                "high_entropy": entropy > 1.0,
                "low_margin": margin < 0.3,
            },
        }

    # --------------------------------------------------------------- output

    def visualize_results(self, results: Dict, save_path: Optional[str] = None):
        """6-panel analysis figure of the first row."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        probs = results["probabilities"][0]
        fig, axes = plt.subplots(2, 3, figsize=(18, 12))
        fig.suptitle("Emotion Recognition Analysis", fontsize=16, fontweight="bold")
        axes[0, 0].bar(self.emotion_labels, probs)
        axes[0, 0].set_title("Class Probabilities")
        axes[0, 1].bar(["confidence", "uncertainty"],
                       [float(results["confidence"][0]),
                        float(np.reshape(results["uncertainty"][0], -1)[0])])
        axes[0, 1].set_title("Confidence vs Uncertainty")
        axes[0, 2].bar(self.emotion_labels, results["logits"][0])
        axes[0, 2].set_title("Raw Logits")
        if "entropy" in results:
            axes[1, 0].bar(["entropy"], [float(results["entropy"][0])])
            axes[1, 0].axhline(1.0, color="r", linestyle="--")
            axes[1, 0].set_title("Prediction Entropy")
            axes[1, 1].bar(["margin"], [float(results["margin"][0])])
            axes[1, 1].axhline(0.3, color="r", linestyle="--")
            axes[1, 1].set_title("Top-2 Margin")
        axes[1, 2].text(0.1, 0.5,
                        f"Prediction: {results['emotion_labels'][0]}\n"
                        f"Confidence: {float(results['confidence'][0]):.3f}",
                        fontsize=14)
        axes[1, 2].axis("off")
        if save_path:
            fig.savefig(save_path, dpi=120, bbox_inches="tight")
            plt.close(fig)
        return fig

    def export_results(self, results: Dict, path: str) -> None:
        """The results as JSON."""
        def default(o):
            if isinstance(o, np.ndarray):
                return o.tolist()
            if isinstance(o, (np.integer, np.floating, np.bool_)):
                return o.item()
            return str(o)

        Path(path).write_text(json.dumps(results, default=default, indent=2))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """The single-sample CLI; returns predict_emotion's results."""
    import argparse
    p = argparse.ArgumentParser(description="Single-sample SER inference")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--audio", default=None)
    p.add_argument("--text", default=None)
    p.add_argument("--use_tta", action="store_true")
    p.add_argument("--num_tta", type=int, default=5)
    p.add_argument("--visualize", default=None, help="path to save the analysis figure")
    p.add_argument("--export", default=None, help="path to save JSON results")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    p.add_argument("--int8", action="store_true", help="not ported yet")
    args = p.parse_args(argv)
    if args.int8:
        raise SystemExit(f"--int8: {INT8_NOT_PORTED}")
    if args.use_tta and not 1 <= args.num_tta <= 5:
        raise SystemExit(f"--num_tta must be in 1..5, not {args.num_tta}")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"infer: {e} (--device cpu)") from e

    iface = EmotionRecognitionInterface(args.checkpoint, device=device)
    results = iface.predict_emotion(args.audio, args.text, use_tta=args.use_tta,
                                    num_tta=args.num_tta)
    print(f"Prediction: {results['emotion_labels'][0]} "
          f"(confidence {float(results['confidence'][0]):.3f}, "
          f"uncertainty {float(results['uncertainty'][0, 0]):.3f})")
    for name, prob in zip(iface.emotion_labels, results["probabilities"][0]):
        print(f"  {name:>8}: {prob:.4f}")
    if args.visualize:
        iface.visualize_results(results, args.visualize)
        print(f"figure -> {args.visualize}")
    if args.export:
        iface.export_results(results, args.export)
        print(f"results -> {args.export}")
    return results


if __name__ == "__main__":
    main()

"""Academic evaluation: the 8-part battery over a frozen checkpoint.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
eval/academic.py, with the reference's
evaluate_academic_complete.py:91-137 parts:
  1. baseline weighted-F1/accuracy on the manifest (:139-173)
  2. cross-lingual transfer analysis (:175-198; the reference SIMULATES
     multilingual texts at :185 — here language tags come from frontend.lid
     over the real texts, falling back to 'en')
  3. calibration ECE/MCE (:200-240)
  4. ASR performance tracking (:242-261; reference simulates hyp=ref —
     replicated when no ASR hypotheses are supplied)
  5. inference benchmarking (:263-304)
  6. few-shot adaptation: K-shot fine-tune of fusion/classifier/prototypes,
     recovery-rate sweep (:306-325 -> evaluation/few_shot_adaptation.py)
  7. robustness: noise SNR sweep (gaussian/babble/music) + Hindi/Bengali
     code-mixing with degradation vs baseline (:327-348 ->
     evaluation/robustness_evaluation.py)
  8. per-class accuracy + confusion matrix + report (:350-465)

Plus per-SNR-band performance slicing (enhanced_evaluation.py:369-489)
over the front-end SNR estimates computed on the device, and, where asked,
the leave-one-class-out open-set protocol and zero-shot cross-lingual
evaluation.

Every forward is the eval forward (eval/evaluate.py) under
torch.inference_mode(), so the classifier runs its kernel on the card;
few-shot adaptation trains through the plain stack. The parameters go to
`device` once. Everything funnels into one JSON-serializable dict, with
the JAX battery's keys and layout, plus a text report.

Under a process group, where the JAX package lays the battery's batches
over its mesh, the parameters are laid out on the mesh (`mesh`, or
cfg.mesh's) by the 'model' rule and every forward runs tensor-parallel over
the 'model' group; each data shard's batch cache holds its rows of every
batch (HostShardedLoader on 'data''s rank and size) and every pass (the
baseline, the open-set protocol, the per-SNR estimates, the robustness
sweep, code-mixing, zero-shot and the few-shot evaluations) gathers its
rows over 'data' batch by batch, so every rank computes one process's
results. The Gaussian noise of a batch is drawn for the whole global batch
and each shard keeps its rows, as one process draws it; the few-shot batch
is rounded up to a multiple of the 'data' size, as JAX rounds it. The
few-shot adaptation itself runs on every rank over the whole K-shot
batches: AdamW's first steps turn a gradient's rounding into steps of
about lr, so summing the shards' gradients would not give one process's
adapted heads. The timings (the benchmark and `part_seconds`) are rank
0's, sent to every rank; rank 0 writes the JSON and the report.
"""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..data.manifest import SIX_CLASS_NAMES
from ..data.pipeline import EVAL_HOST_KEYS, SERDataset
from ..data.prefetch import device_prefetch
from ..data.tokenizer import Tokenizer, get_tokenizer
from ..frontend import lid as lid_mod
from ..frontend import quality_gates as qg
from ..ops import openmax as om
from ..parallel import multihost as mh, tensor as tensor_lib
from ..utils import metrics as M
from ..utils.runtime import resolve_device
from . import benchmark as bench
from . import calibration as cal
from . import enhanced_pipeline as ep
from . import evaluate as ev
from . import few_shot as fs
from . import openset as osr
from . import robustness as rob
from . import slicing
from . import wer as wer_mod
from . import zero_shot as zs

EMOTIONS_6 = SIX_CLASS_NAMES  # one canonical label ordering (data/manifest.py)
FEW_SHOT_BATCH = 4            # the reference adapts with batch 4 (:71-76)

Device = Optional[Union[str, torch.device]]


class _BatchCache:
    """Decode-once, disk-backed batch cache for the multi-pass battery.

    The battery re-reads the same batches across the baseline pass, the SNR
    slicing pass, and every (noise_type x SNR) robustness sweep. Fully
    materializing them in RAM (a list of decoded batches) is multi-GB at the
    reference's 5,205-clip train manifest with 30 s buckets; here the first
    pass streams each batch to an .npz in a scratch directory and later
    passes stream them back one at a time, so host residency stays O(one
    batch) regardless of manifest size. `close()` removes the scratch files
    (run_academic_evaluation does this on exit)."""

    def __init__(self, loader, cache_dir: Optional[str] = None):
        import tempfile
        self._loader = loader
        self._own_dir = cache_dir is None
        self._dir = Path(cache_dir or tempfile.mkdtemp(prefix="ser_acad_"))
        self._dir.mkdir(parents=True, exist_ok=True)
        self._files = None

    def epoch(self, _=0):
        if self._files is None:
            return self._build()
        return self._replay()

    def _build(self):
        files = []
        for i, b in enumerate(self._loader.epoch(0)):
            f = self._dir / f"batch_{i:05d}.npz"
            np.savez(f, **b)
            files.append(f)
            yield b
        self._files = files  # only mark complete after a full pass

    def _replay(self):
        for f in self._files:
            with np.load(f, allow_pickle=False) as z:
                yield {k: z[k] for k in z.files}

    @property
    def batches(self):
        """Re-iterable view (each iteration is a fresh disk stream)."""
        return _Reiterable(self)

    def close(self):
        import shutil
        if self._own_dir:
            shutil.rmtree(self._dir, ignore_errors=True)


class _Reiterable:
    def __init__(self, cache):
        self._cache = cache

    def __iter__(self):
        return self._cache.epoch(0)


def _softmax(logits: np.ndarray) -> np.ndarray:
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def _open_set_protocol(params, cfg: Config, loader, device: torch.device,
                       unknown_class: int, mesh=None, tp=None) -> Dict:
    """Leave-one-class-out open-set recognition protocol.

    The reference builds the machinery (OpenSetEvaluator OSCR/AUROC/AUPR/
    FPR@95, enhanced_evaluation.py:199-296; OpenMax Weibull calibration,
    classifier.py:240-305; energy scores, utils.py:12-14) but never
    constructs unknowns to run it on. This protocol does: samples whose true
    label == `unknown_class` are treated as open-set unknowns, and the
    classifier is evaluated as if it did not know that class — its logit
    column is dropped before prediction/confidence, and the Weibull model is
    refitted on the remaining classes' penultimate features (fitting on the
    eval manifest's known-class samples; a self-contained protocol choice,
    documented here).

    Three unknown-detection scores are reported, each with AUROC / AUPR /
    FPR@95TPR (known = positive class):
      * msp     — max softmax probability over the known classes (also
                  drives the OSCR battery via enhanced_pipeline)
      * energy  — logsumexp of known-class logits (−energy_score)
      * openmax — 1 − Weibull unknown probability
    """
    step = ev.make_eval_step(cfg.model, use_openmax=False, device=device, tp=tp)
    lg, ft, lb = [], [], []
    for batch, host in device_prefetch(loader.epoch(0), device, skip=EVAL_HOST_KEYS):
        logits, feats, _ = step(params, batch)
        keep = host["example_mask"] > 0
        lg.append(logits.float().cpu().numpy().astype(np.float64)[keep])
        ft.append(feats.float().cpu().numpy().astype(np.float64)[keep])
        lb.append(host["labels"][keep])
    C = cfg.model.num_labels
    rows = ev.gather_rows({"logits": np.concatenate(lg) if lg else np.zeros((0, C)),
                           "feats": np.concatenate(ft) if ft else np.zeros((0, 1)),
                           "labels": np.concatenate(lb) if lb else np.zeros((0,), np.int64)},
                          mesh, [len(x) for x in lb])
    logits, feats, labels = rows["logits"], rows["feats"], rows["labels"]

    known_classes = np.array([c for c in range(C) if c != unknown_class])
    unknown_mask = labels == unknown_class

    # the "doesn't-know-class-k" view: drop its logit column
    k_logits = logits[:, known_classes]
    preds = known_classes[k_logits.argmax(axis=1)]
    probs = _softmax(k_logits)
    msp = probs.max(axis=1)
    energy_known = -om.energy_score(torch.from_numpy(k_logits)).numpy()  # logsumexp: high=known

    # refit Weibull without the unknown class (rows restricted to knowns so
    # the unfit default row cannot dominate the CDF max)
    remap = np.full(C, -1)
    remap[known_classes] = np.arange(len(known_classes))
    fit_feats = feats[~unknown_mask]
    fit_labels = remap[labels[~unknown_mask]]
    with torch.inference_mode():
        weibull = om.fit_weibull(
            torch.from_numpy(fit_feats).float().to(device),
            torch.from_numpy(fit_labels).to(device), len(known_classes))
        unknown_prob = om.weibull_unknown_prob(
            weibull, torch.from_numpy(feats).float().to(device))
    openmax_known = 1.0 - unknown_prob.cpu().numpy().astype(np.float64)

    # OSCR battery through the enhanced-pipeline orchestrator (the same
    # entry the reference's EnhancedEvaluationPipeline exposes)
    enhanced = ep.run_enhanced_evaluation(
        y_true=labels, y_pred=preds, confidence_scores=msp,
        unknown_mask=unknown_mask)
    om_res = enhanced["open_set_metrics"]

    scores = {"msp": msp, "energy": energy_known, "openmax": openmax_known}
    per_score = {}
    for name, s in scores.items():
        ks, us = s[~unknown_mask], s[unknown_mask]
        per_score[name] = {
            "auroc": osr.auroc(ks, us),
            "aupr": osr.aupr(ks, us),
            "fpr_at_95tpr": osr.fpr_at_95_tpr(ks, us),
        }

    return {
        "protocol": "leave-one-class-out",
        "unknown_class": int(unknown_class),
        "num_known": int((~unknown_mask).sum()),
        "num_unknown": int(unknown_mask.sum()),
        "oscr_score": om_res["oscr_score"],
        "oscr_optimal_threshold": om_res["optimal_threshold"],
        "auroc": om_res["auroc"],
        "aupr": om_res["aupr"],
        "fpr_at_95tpr": om_res["fpr_at_95tpr"],
        "scores": per_score,
        "known_weighted_f1": M.weighted_f1(
            preds[~unknown_mask], labels[~unknown_mask], C),
    }


def run_academic_evaluation(params, cfg: Config, manifest: str, *,
                            batch_size: int = 8,
                            tokenizer: Optional[Tokenizer] = None,
                            device: Device = None,
                            asr_hypotheses: Optional[list] = None,
                            output_dir: Optional[str] = None,
                            run_benchmark: bool = True,
                            run_few_shot: bool = True,
                            run_robustness: bool = True,
                            few_shot_shots: Optional[list] = None,
                            few_shot_epochs: int = 5,
                            full_ft_f1: Optional[float] = None,
                            robustness_snr_levels: Optional[list] = None,
                            robustness_noise_types: tuple = ("gaussian",
                                                             "babble", "music"),
                            code_mix_languages: tuple = ("hi", "bn"),
                            zero_shot_languages: tuple = (),
                            open_set_unknown_class: Optional[int] = None,
                            verbose: bool = True, mesh=None) -> Dict:
    """The battery over `manifest` on `device` (the card unless the caller
    names another); returns the results dict, and writes
    academic_evaluation.json and academic_report.txt under `output_dir`
    where given (rank 0 under a group). Under a process group the battery
    runs on `mesh` (cfg.mesh's when None), as the module docstring says;
    every rank returns the same dict. COLLECTIVE under a group."""
    dev = resolve_device(device)
    tok = tokenizer or get_tokenizer(vocab_size=cfg.model.text.vocab_size)
    size = bench.count_params(params)
    params, mesh = ev.place_on_mesh(params, cfg, dev, mesh)
    ds = SERDataset(manifest, cfg.data)
    loader = _BatchCache(mh.loader_class(mesh)(ds, batch_size=batch_size, tokenizer=tok,
                                               shuffle=False))
    view, tp, _ = ev.eval_view(params)
    try:
        return _run_academic_evaluation(
            view, cfg, ds, loader, tok, dev, mesh=mesh, tp=tp, param_count=size,
            asr_hypotheses=asr_hypotheses, output_dir=output_dir,
            run_benchmark=run_benchmark, run_few_shot=run_few_shot,
            run_robustness=run_robustness, few_shot_shots=few_shot_shots,
            few_shot_epochs=few_shot_epochs, full_ft_f1=full_ft_f1,
            robustness_snr_levels=robustness_snr_levels,
            robustness_noise_types=robustness_noise_types,
            code_mix_languages=code_mix_languages,
            zero_shot_languages=zero_shot_languages,
            open_set_unknown_class=open_set_unknown_class,
            batch_size=batch_size, verbose=verbose)
    finally:
        loader.close()


def _rss() -> str:
    """The process's resident set from /proc (Linux), or '?'."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return f"{int(line.split()[1]) // 1024} MB"
    except OSError:
        pass
    return "?"


def _run_academic_evaluation(params, cfg: Config, ds, loader, tok, device, *,
                             mesh, tp, param_count, asr_hypotheses, output_dir, run_benchmark,
                             run_few_shot, run_robustness, few_shot_shots,
                             few_shot_epochs, full_ft_f1,
                             robustness_snr_levels, robustness_noise_types,
                             code_mix_languages, zero_shot_languages,
                             open_set_unknown_class, batch_size,
                             verbose) -> Dict:
    # per-part wall-clock: the battery's cost profile is itself a deliverable
    part_seconds: Dict[str, float] = {}
    _t0 = time.perf_counter()

    def _mark(name: str) -> None:
        nonlocal _t0
        now = time.perf_counter()
        part_seconds[name] = round(now - _t0, 2)
        _t0 = now
        if verbose and mh.is_coordinator():
            # host RSS alongside per-part wall-clock: the RSS trace catches
            # host-side leaks that a single end-of-run number would hide
            print(f"[academic] {name}: {part_seconds[name]}s rss={_rss()}", flush=True)

    # 1. baseline pass (single forward, logits + probs)
    out = ev.collect_logits(params, cfg, loader, use_openmax=True, device=device, mesh=mesh)
    logits, labels = out["logits"], out["labels"]
    probs = _softmax(logits)
    preds = logits.argmax(axis=1)
    conf = probs.max(axis=1)

    results: Dict = {"baseline": {
        "weighted_f1": M.weighted_f1(preds, labels, cfg.model.num_labels),
        "accuracy": M.accuracy(preds, labels),
        "uar": M.unweighted_average_recall(preds, labels),
        "macro_f1": M.macro_f1(preds, labels),
        "num_samples": int(len(labels)),
    }}

    _mark("baseline")
    # 2. cross-lingual slices + transfer ratios over detected language tags
    # (aligned to loader order via the per-example manifest indices)
    idx = out["indices"]
    texts = [ds.items[i].get("text", "") if i >= 0 else "" for i in idx]
    langs = [lid_mod.detect_language(t) or "en" for t in texts]
    per_lang = slicing.slice_by_language(labels, preds, conf, langs)
    results["cross_lingual"] = {
        "per_language": {k: vars(v) for k, v in per_lang.items()}}
    if "en" in per_lang and len(per_lang) > 1:
        results["cross_lingual"]["transfer"] = slicing.transfer_ratios(
            per_lang, "en")

    _mark("cross_lingual")
    # 3. calibration
    cm_cal = cal.compute_calibration_metrics(preds, labels, probs)
    results["calibration"] = {
        "ece": cm_cal.ece, "mce": cm_cal.mce,
        "quality": cal.calibration_quality(cm_cal.ece)}

    _mark("calibration")
    # 4. ASR tracking (hyp = ref simulation when none supplied, :250-253)
    tracker = wer_mod.ASRPerformanceTracker()
    hyps = asr_hypotheses if asr_hypotheses is not None else texts
    for ref, hyp, lang in zip(texts, hyps, langs):
        if ref:
            tracker.add_result(ref, hyp, language=lang, confidence=1.0)
    results["asr_tracking"] = tracker.summary()

    # open-set + risk-coverage on the closed set (no unknowns -> risk-cov only)
    results["risk_coverage"] = {
        k: v for k, v in osr.risk_coverage_curve(conf, labels, preds).items()
        if k in ("risk_coverage_auc", "optimal_threshold", "optimal_coverage",
                 "optimal_risk")}

    # open-set recognition protocol: leave-one-class-out unknowns
    if open_set_unknown_class is not None:
        results["open_set"] = _open_set_protocol(
            params, cfg, loader, device, int(open_set_unknown_class), mesh, tp)

    _mark("asr_risk_coverage")
    # 5. inference benchmark on the loaded model
    if run_benchmark:
        step = ev.make_eval_step(cfg.model, use_openmax=False, device=device, tp=tp)
        first = next(iter(loader.epoch(0)))
        dev = {k: torch.from_numpy(np.array(v)).to(device) for k, v in first.items()
               if k not in EVAL_HOST_KEYS}

        def fwd(bs):
            sub = {k: v[:bs] for k, v in dev.items()}
            return step(params, sub)[0]

        B = first["audio"].shape[0]
        sizes = sorted({1, min(4, B), min(8, B), B})
        results["inference_benchmark"] = bench.benchmark_fn(
            fwd, batch_sizes=sizes, warmup=2, runs=5)
        results["inference_benchmark"]["params"] = param_count

    # per-SNR performance slicing (enhanced_evaluation.py:369-489): the SNR
    # each utterance sees is the front-end estimate
    # (frontend/quality_gates.py:estimate_snr), computed on the device
    snr_all = []
    with torch.inference_mode():
        for batch, host in device_prefetch(loader.epoch(0), device,
                                           skip=EVAL_HOST_KEYS):
            keep = host["example_mask"] > 0
            snr = qg.estimate_snr(batch["audio"], batch["audio_mask"])
            snr_all.append(snr.float().cpu().numpy()[keep])
    snrs = ev.gather_rows({"snr": np.concatenate(snr_all) if snr_all else np.zeros((0,))},
                          mesh, [len(x) for x in snr_all])["snr"]
    per_snr = slicing.slice_by_snr(labels, preds, conf, snrs)
    results["per_snr"] = {k: vars(v) for k, v in per_snr.items()}

    eval_step = None
    if run_few_shot or run_robustness or zero_shot_languages:
        eval_step = ev.make_eval_step(cfg.model, use_openmax=True, device=device, tp=tp)

    def _predict_with_texts(new_texts):
        """Re-run the model over the same audio with substituted texts
        (aligned with the collected `texts`/`idx` order). Streams straight
        from the batch cache — no full-manifest materialization."""
        by_idx = {int(i): t for i, t in zip(idx, new_texts)}

        def rebatched():
            for batch in loader.batches:
                row_texts = [by_idx.get(int(i), "") for i in batch["indices"]]
                ids, tmask = tok.encode_batch(row_texts,
                                              cfg.data.max_text_tokens)
                yield {**batch, "text_ids": ids, "text_mask": tmask}

        preds_m, probs_m, _ = _forward_batches(rebatched())
        return {"preds": preds_m, "probs": probs_m}

    def _forward_batches(batches):
        """Plain eval forward over host batches -> (preds, probs, labels)."""
        lg, lb = [], []
        for batch, host in device_prefetch(batches, device, skip=EVAL_HOST_KEYS):
            logits = eval_step(params, batch)[0].float().cpu().numpy().astype(np.float64)
            keep = host["example_mask"] > 0
            lg.append(logits[keep])
            lb.append(host["labels"][keep])
        rows = ev.gather_rows(
            {"lg": np.concatenate(lg) if lg else np.zeros((0, cfg.model.num_labels)),
             "lb": np.concatenate(lb) if lb else np.zeros((0,), np.int64)},
            mesh, [len(x) for x in lb])
        lg, lb = rows["lg"], rows["lb"]
        pr = _softmax(lg) if len(lg) else lg
        return lg.argmax(axis=1) if len(lg) else np.zeros(0, np.int64), pr, lb

    _mark("benchmark_per_snr")
    # 6. few-shot adaptation (evaluate_academic_complete.py:306-325): K-shot
    # fine-tune of fusion/classifier/prototypes with everything else frozen
    if run_few_shot:
        n_items = len(ds)
        shots = few_shot_shots or [k for k in fs.DEFAULT_SHOTS
                                   if k < n_items] or [max(1, n_items // 2)]
        # rounded up to a multiple of the data axis so batches shard, as JAX does
        data_n = 1 if mesh is None else tensor_lib.data_shard(mesh)[1]
        sub_bs = -(-min(FEW_SHOT_BATCH, batch_size) // data_n) * data_n

        def _subset_loader(indices, shuffle, sharded=False):
            sub = copy.copy(ds)
            sub.items = [ds.items[i] for i in indices]
            return mh.loader_class(mesh if sharded else None)(
                sub, batch_size=sub_bs, tokenizer=tok, shuffle=shuffle, seed=42)

        def make_batches(indices):
            # the whole K-shot batches on every rank (the module docstring)
            return [{k: v for k, v in b.items() if k != "indices"}
                    for b in _subset_loader(indices, True).epoch(0)]

        def evaluate_subset(p, indices):
            sub_out = ev.collect_logits(
                p, cfg, _subset_loader(indices, False, sharded=True), use_openmax=True,
                device=device, mesh=mesh)
            sp = sub_out["logits"].argmax(axis=1)
            return {"f1": M.weighted_f1(sp, sub_out["labels"],
                                        cfg.model.num_labels),
                    "accuracy": M.accuracy(sp, sub_out["labels"])}

        fs_results = fs.run_few_shot_suite(
            params, cfg.model, make_batches=make_batches,
            evaluate=evaluate_subset, n_items=n_items, shots=shots,
            zero_shot_f1=results["baseline"]["weighted_f1"],
            full_ft_f1=full_ft_f1, num_epochs=few_shot_epochs, tp=tp)
        results["few_shot"] = [vars(r) for r in fs_results]

    _mark("few_shot")
    # 7. robustness (evaluate_academic_complete.py:327-348): noise SNR sweep
    # + Hindi/Bengali code-mixing, degradation vs the part-1 baseline
    if run_robustness:
        baseline_f1 = results["baseline"]["weighted_f1"]

        def noise_predict(batch, generator, snr_db, noise_type):
            dev = {k: torch.from_numpy(np.array(v)).to(device) for k, v in batch.items()
                   if k not in EVAL_HOST_KEYS}
            audio, noise = dev["audio"], None
            if noise_type == "gaussian" and mesh is not None:
                # the global batch's draw, as one process takes it; this shard's rows
                index, count = tensor_lib.data_shard(mesh)
                rows = audio.shape[0]
                noise = torch.randn((rows * count, audio.shape[1]), generator=generator,
                                    device=audio.device, dtype=audio.dtype
                                    )[index * rows:(index + 1) * rows]
            noisy = rob.add_noise_at_snr(audio, dev["audio_mask"], snr_db,
                                         noise_type=noise_type, generator=generator,
                                         noise=noise)
            logits = eval_step(params, {**dev, "audio": noisy})[0]
            logits = logits.float().cpu().numpy().astype(np.float64)
            keep = batch["example_mask"] > 0
            rows = ev.gather_rows({"logits": logits[keep], "labels": batch["labels"][keep]},
                                  mesh, [int(keep.sum())])
            return {"preds": rows["logits"].argmax(axis=1),
                    "probs": _softmax(rows["logits"]),
                    "labels": rows["labels"]}

        noise_res = rob.evaluate_noise_robustness(
            noise_predict, loader.batches,
            snr_levels=tuple(robustness_snr_levels or rob.SNR_LEVELS_DEFAULT),
            noise_types=tuple(robustness_noise_types),
            baseline_f1=baseline_f1, device=device)

        code_mix = {}
        for lang in code_mix_languages:
            code_mix[lang] = rob.evaluate_code_mixing(
                _predict_with_texts, texts, labels, target_language=lang,
                baseline_f1=baseline_f1)
        results["robustness"] = {"noise": noise_res, "code_mixing": code_mix}

    # zero-shot cross-lingual: same audio, native-script hi/bn/te texts,
    # per-language slices + transfer ratios vs the English baseline
    # (the reference simulates translations at
    # evaluate_academic_complete.py:185)
    if zero_shot_languages:
        results["zero_shot"] = zs.evaluate_zero_shot(
            _predict_with_texts, texts, labels, conf, preds,
            languages=tuple(zero_shot_languages))

    _mark("robustness")
    # 8. per-class + confusion
    names = EMOTIONS_6[:cfg.model.num_labels]
    results["per_class_accuracy"] = {
        names[i]: float((preds[labels == i] == i).mean())
        for i in range(cfg.model.num_labels) if (labels == i).any()}
    results["confusion_matrix"] = M.confusion_matrix(
        labels, preds, cfg.model.num_labels).tolist()

    _mark("per_class_report")
    results["part_seconds"] = part_seconds
    if mh.world_size() > 1:
        # the timings are rank 0's on every rank, so every rank's dict is one
        timed = [{k: results[k] for k in ("part_seconds", "inference_benchmark")
                  if k in results}]
        dist.broadcast_object_list(timed, src=0)
        results.update(timed[0])
    report = generate_report(results, names)
    results["report"] = report
    if output_dir and mh.is_coordinator():
        outp = Path(output_dir)
        outp.mkdir(parents=True, exist_ok=True)
        (outp / "academic_evaluation.json").write_text(
            json.dumps({k: v for k, v in results.items() if k != "report"},
                       default=_json_default, indent=2))
        (outp / "academic_report.txt").write_text(report)
    if verbose and mh.is_coordinator():
        print(report)
    return results


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def generate_report(results: Dict, class_names) -> str:
    b = results["baseline"]
    lines = [
        "=" * 60, "ACADEMIC EVALUATION REPORT", "=" * 60, "",
        f"Samples: {b['num_samples']}",
        f"Weighted F1: {b['weighted_f1']:.4f}",
        f"Accuracy:    {b['accuracy']:.4f}",
        f"UAR:         {b['uar']:.4f}",
        f"Macro F1:    {b['macro_f1']:.4f}", "",
        f"Calibration: ECE {results['calibration']['ece']:.4f} "
        f"MCE {results['calibration']['mce']:.4f} "
        f"({results['calibration']['quality']})", "",
        "Per-class accuracy:"]
    for k, v in results["per_class_accuracy"].items():
        lines.append(f"  {k}: {v:.3f}")
    if "transfer" in results.get("cross_lingual", {}):
        tr = results["cross_lingual"]["transfer"]
        lines.append("")
        lines.append(f"Cross-lingual transfer (source {tr['source_language']}, "
                     f"F1 {tr['source_f1']:.4f}): overall ratio "
                     f"{tr['overall_transfer_ratio']:.3f}")
    rc = results.get("risk_coverage", {})
    if rc:
        lines.append("")
        lines.append(f"Risk-coverage AUC: {rc['risk_coverage_auc']:.4f} "
                     f"(optimal: thr {rc['optimal_threshold']:.2f} "
                     f"cov {rc['optimal_coverage']:.2f} "
                     f"risk {rc['optimal_risk']:.3f})")
    os_res = results.get("open_set")
    if os_res:
        uc = os_res["unknown_class"]
        name = class_names[uc] if uc < len(class_names) else str(uc)
        lines.append("")
        lines.append(f"Open-set recognition (leave-one-class-out, unknown = "
                     f"'{name}', {os_res['num_unknown']} unknown / "
                     f"{os_res['num_known']} known):")
        lines.append(f"  OSCR {os_res['oscr_score']:.4f} "
                     f"(thr {os_res['oscr_optimal_threshold']:.2f})  "
                     f"known-class wF1 {os_res['known_weighted_f1']:.4f}")
        lines.append(f"  {'score':>8} {'AUROC':>7} {'AUPR':>7} {'FPR@95':>7}")
        for sname, s in os_res["scores"].items():
            lines.append(f"  {sname:>8} {s['auroc']:7.4f} {s['aupr']:7.4f} "
                         f"{s['fpr_at_95tpr']:7.4f}")
    if results.get("per_snr"):
        lines.append("")
        lines.append("Per-SNR-band performance:")
        lines.append(f"  {'band':>10} {'n':>6} {'wF1':>7} {'acc':>7} {'UAR':>7}")
        for band, s in results["per_snr"].items():
            lines.append(f"  {band:>10} {s['sample_count']:>6} "
                         f"{s['weighted_f1']:7.3f} {s['accuracy']:7.3f} "
                         f"{s['uar']:7.3f}")
    if results.get("few_shot"):
        lines.append("")
        lines.append("Few-shot adaptation:")
        lines.append(f"  {'shots':>6} {'F1':>8} {'acc':>8} {'recovery':>9}")
        for r in results["few_shot"]:
            rec = (f"{r['recovery_rate']:.1f}%"
                   if r["recovery_rate"] > 0 else "N/A")
            lines.append(f"  {r['num_shots']:>6} {r['f1_score']:8.4f} "
                         f"{r['accuracy']:8.4f} {rec:>9}")
    robres = results.get("robustness")
    if robres:
        lines.append("")
        lines.append("Robustness (noise):")
        for noise_type, per_snr_r in robres["noise"].items():
            row = " ".join(f"{snr}:{m['weighted_f1']:.3f}"
                           for snr, m in per_snr_r.items())
            lines.append(f"  {noise_type:>9}: {row}")
        lines.append("Robustness (code-mixing F1 by ratio):")
        for lang, per_ratio in robres["code_mixing"].items():
            row = " ".join(f"{k.split('_')[1]}:{m['weighted_f1']:.3f}"
                           for k, m in per_ratio.items())
            lines.append(f"  {lang:>9}: {row}")
    zsres = results.get("zero_shot")
    if zsres:
        lines.append("")
        lines.append("Zero-shot cross-lingual (native-script texts, "
                     "same audio):")
        lines.append(f"  {'lang':>6} {'n':>6} {'wF1':>7} {'acc':>7} "
                     f"{'UAR':>7} {'transfer':>9}")
        tr = zsres["transfer"]["transfer_ratios"]
        for lang, s in zsres["per_language"].items():
            ratio = ("baseline" if lang == zsres["transfer"]["source_language"]
                     else f"{tr[lang]:.3f}")
            lines.append(f"  {lang:>6} {s['sample_count']:>6} "
                         f"{s['weighted_f1']:7.3f} {s['accuracy']:7.3f} "
                         f"{s['uar']:7.3f} {ratio:>9}")
    ib = results.get("inference_benchmark")
    if ib:
        best = ib["scaling"]
        lines.append("")
        lines.append(f"Throughput: {best['best_samples_per_sec']:.1f} "
                     f"samples/s @ batch {best['best_batch_size']}")
    lines.append("=" * 60)
    return "\n".join(lines)

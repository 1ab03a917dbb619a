"""Training CLI of the port: train the model on the card from jsonl manifests.

    python -m multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.train \\
        --train_manifest train.jsonl --val_manifest val.jsonl --epochs 5 \\
        --batch_size 16 --augment --use_amp --save_dir checkpoints

The flags and presets (default, crema_m3, crema_final) are those of the
repo's cli/train.py, and they build the same Config, with `--device`
(default cuda) in place of `--platform`. `--prng_impl` selects JAX's
random-number backend and has no counterpart here: the port's draws come
from torch generators seeded by `--seed`.

One process per card: under torchrun (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) or with --coordinator_address, --num_processes
and --process_id, each process brings up the process group (NCCL on its
card; gloo with `--device cpu`) and trains its share of the global
--batch_size on the mesh of --mesh_dcn and --mesh_model, with --fsdp
(--fsdp_min_size) sharding the parameters, gradients and AdamW moments over
'data' and --mesh_model splitting the encoders' and the cross-modal
attention's heads and FFN columns over that many consecutive ranks
(Megatron's tensor parallelism, parallel/tensor.py); rank 0 writes the
checkpoints and metrics. On one process without a group, a mesh that needs
more ranks exits:

    torchrun --nproc_per_node=8 -m \
        multilingual_multimodal_speech_emotion_recognition_tpu_torch.cli.train \
        --train_manifest train.jsonl --val_manifest val.jsonl --batch_size 128 --fsdp \
        --mesh_model 2

`--audio_backbone`
picks a preset of config.AUDIO_BACKBONE_PRESETS; `--wav2vec2_checkpoint`
and `--xlmr_checkpoint` load Hugging Face backbones (a model directory or
hub name, through transformers, which only these flags need). Checkpoints go to
--save_dir in the port's format (train/checkpoint.py); the port's eval
CLI scores them. Without a card the CLI exits non-zero unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from ..config import AUDIO_BACKBONE_PRESETS


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="--prng_impl (JAX's random-number backend) is not a flag of the port: "
               "its draws come from torch generators seeded by --seed.")
    p.add_argument("--train_manifest", type=str, default="train_70.jsonl")
    p.add_argument("--val_manifest", type=str, default="val_20.jsonl")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup_ratio", type=float, default=0.1)
    p.add_argument("--use_amp", action="store_true",
                   help="bf16 compute for the encoders and heads (no loss scaler)")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--proto_weight", type=float, default=0.05)
    p.add_argument("--save_dir", type=str, default="checkpoints")
    p.add_argument("--resume_from", type=str, default=None)
    p.add_argument("--num_labels", type=int, default=4)
    p.add_argument("--scheduler", choices=["warmup_cosine", "cosine_restarts"],
                   default="warmup_cosine")
    p.add_argument("--grad_clip", type=float, default=None)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer step (batch_size stays the "
                        "effective batch; bounds activation memory)")
    p.add_argument("--backbone_moment_dtype", default=None,
                   choices=[None, "bfloat16", "float32"],
                   help="AdamW first-moment dtype of the audio/text groups "
                        "(bfloat16 halves it when fine-tuning unfrozen)")
    p.add_argument("--early_stop_patience", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dataset_root", type=str, default="datasets")
    p.add_argument("--supcon_weight", type=float, default=0.0)
    p.add_argument("--no_quality_gates", action="store_true")
    p.add_argument("--no_audio_conditioning", action="store_true")
    p.add_argument("--use_asr", action="store_true",
                   help="fuse 8-dim ASR features into the text encoder and emit them "
                        "from the data pipeline (frontend/asr.py)")
    p.add_argument("--audio_backbone", choices=list(AUDIO_BACKBONE_PRESETS),
                   default="wav2vec2-base",
                   help="the audio encoder's preset; the large ones use the "
                        "layer-norm conv stack and the stable pre-LN encoder")
    p.add_argument("--wav2vec2_checkpoint", type=str, default=None,
                   help="Hugging Face Wav2Vec2/HuBERT/WavLM model (directory or name) "
                        "whose weights replace the audio backbone's")
    p.add_argument("--xlmr_checkpoint", type=str, default=None,
                   help="Hugging Face XLM-R model (directory or name) whose weights "
                        "replace the text backbone's")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu for tiny models)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="'model' mesh axis size: the ranks that split each encoder layer's "
                        "and the cross-modal attention's heads and FFN columns")
    p.add_argument("--mesh_dcn", type=int, default=1,
                   help="number of hosts (slices) folded slice-major into 'data'")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO: parameters, gradients and AdamW moments sharded over "
                        "'data' (parallel/mesh.param_shardings)")
    p.add_argument("--fsdp_min_size", type=int, default=None,
                   help="leaves with fewer elements replicate under --fsdp "
                        "(default parallel/mesh.FSDP_MIN_SIZE = 32768)")
    p.add_argument("--autotune_buckets", type=int, default=None,
                   help="replace the default audio buckets with N caps that minimise "
                        "the train manifest's padded samples (data/bucketing.py)")
    p.add_argument("--preset", choices=["default", "crema_m3", "crema_final"],
                   default="default",
                   help="crema_m3 = train_crema.py knobs (6-class, softened focal, "
                        "L2-normalised proto, restarts, grad clip); crema_final = "
                        "train_crema_final.py knobs (stronger dropout, "
                        "consistency-augmentation CE)")
    p.add_argument("--two_phase", action="store_true",
                   help="phase 1 frozen encoders, phase 2 full fine-tune")
    p.add_argument("--coordinator_address", default=None,
                   help="multi-process runs without torchrun: host:port of rank 0's "
                        "rendezvous (parallel/multihost.initialize)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p.parse_args(argv)


def build_config(args: argparse.Namespace):
    """The Config the repo's cli/train.py builds from the same flags."""
    from ..config import Config, DataConfig, ModelConfig, TrainConfig
    train_kw = dict(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        warmup_ratio=args.warmup_ratio, augment=args.augment,
        proto_weight=args.proto_weight, save_dir=args.save_dir,
        resume_from=args.resume_from, scheduler=args.scheduler,
        grad_clip=args.grad_clip, seed=args.seed, grad_accum=args.grad_accum,
        backbone_moment_dtype=args.backbone_moment_dtype,
        supcon_weight=args.supcon_weight, early_stop_patience=args.early_stop_patience)
    num_labels = args.num_labels
    dropout = 0.15
    if args.preset == "crema_m3":
        # train_crema.py:95-517: 6 classes, softened focal (beta .99, gamma 1),
        # CE + 0.1 focal + w proto (L2-normalised), grad clip, restarts
        num_labels = 6
        train_kw.update(focal_weight=0.1, focal_beta=0.99, focal_gamma=1.0,
                        proto_l2_normalize=True, proto_term_weight=args.proto_weight,
                        scheduler="cosine_restarts", grad_clip=args.grad_clip or 1.0)
    elif args.preset == "crema_final":
        # train_crema_final.py:65-418: 4 classes, dropout 0.25, restarts every
        # 3 epochs, 0.3 CE(augmented) on 30 % of steps, CE + 0.5 focal + 0.1 proto
        num_labels = 4
        dropout = 0.25
        train_kw.update(focal_weight=0.5, proto_term_weight=0.1,
                        consistency_aug_weight=0.3, consistency_aug_fraction=0.3,
                        scheduler="cosine_restarts", restart_period_epochs=3,
                        grad_clip=args.grad_clip or 1.0)
    data_kw = dict(dataset_root=args.dataset_root, emit_asr_feats=args.use_asr)
    if args.autotune_buckets:
        from ..data import bucketing
        caps, report = bucketing.autotune_from_manifest(
            args.train_manifest, DataConfig(**data_kw), args.autotune_buckets)
        print(report, f"caps={caps}")
        data_kw["audio_buckets"] = caps
    from ..config import MeshConfig
    return Config(
        model=ModelConfig(
            num_labels=num_labels, classifier_dropout=dropout,
            compute_dtype="bfloat16" if args.use_amp else "float32",
            use_quality_gates=not args.no_quality_gates,
            use_audio_conditioning=not args.no_audio_conditioning,
            use_asr=args.use_asr, audio=AUDIO_BACKBONE_PRESETS[args.audio_backbone]()),
        data=DataConfig(**data_kw),
        train=TrainConfig(**train_kw),
        mesh=MeshConfig(model_axis=args.mesh_model, dcn_data=args.mesh_dcn,
                        fsdp=args.fsdp, fsdp_min_size=args.fsdp_min_size))


def load_pretrained(args: argparse.Namespace) -> Optional[dict]:
    """The Hugging Face state dicts the flags name, as train's `pretrained`
    (AutoModel resolves Wav2Vec2Model, HubertModel, WavLMModel or
    Wav2Vec2BertModel, and XLMRobertaModel), or None."""
    names = {"wav2vec2_state": args.wav2vec2_checkpoint, "xlmr_state": args.xlmr_checkpoint}
    if not any(names.values()):
        return None
    try:
        from transformers import AutoModel
    except ImportError as e:
        raise SystemExit("--wav2vec2_checkpoint / --xlmr_checkpoint load Hugging Face "
                         "models through the transformers package, which is not "
                         "installed") from e
    return {key: AutoModel.from_pretrained(name).state_dict()
            for key, name in names.items() if name}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns train's (or train_two_phase's) result."""
    args = parse_args(argv)
    from ..utils.runtime import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"train: {e} (--device cpu)") from e
    from ..parallel import multihost
    from ..train import loop

    # one process per card: a process group from the flags or torchrun's
    # environment, before anything runs on the card
    try:
        pod = multihost.initialize(args.coordinator_address, args.num_processes,
                                   args.process_id, device=device)
    except ValueError as e:
        raise SystemExit(f"train: {e}") from e
    if pod:
        device = multihost.rank_device()
        print(f"multi-process: rank {multihost.rank()}/"
              f"{multihost.world_size()} on {device}")
    elif args.mesh_dcn != 1 or args.mesh_model != 1:
        raise SystemExit(f"train: a mesh of model {args.mesh_model} x dcn {args.mesh_dcn} "
                         "needs that many ranks: launch one process per card with torchrun, "
                         "or give --coordinator_address, --num_processes and --process_id")

    cfg = build_config(args)
    run = loop.train_two_phase if args.two_phase else loop.train
    result = run(cfg, train_manifest=args.train_manifest, val_manifest=args.val_manifest,
                 pretrained=load_pretrained(args), device=device)
    print(f"Best F1: {result['best_f1']:.4f}")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])

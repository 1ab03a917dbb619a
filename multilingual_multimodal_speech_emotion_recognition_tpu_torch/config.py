"""Configuration of the port: its own copies of the JAX package's
ModelConfig, DataConfig and TrainConfig (config.py), Wav2Vec2Config
(models/wav2vec2.py) and XLMRConfig (models/xlmr.py), with the same fields
and defaults, so a JAX checkpoint's config JSON loads here unchanged, and
of its audio backbone presets (`AUDIO_BACKBONE_PRESETS`).
`Config` holds the model, data, train and mesh sections, as the JAX
package's does."""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = False
    feat_extract_norm: str = "group"  # "group" | "layer"
    gated_relpos_bias: bool = False
    num_buckets: int = 320
    max_bucket_distance: int = 800
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10

    def feat_extract_output_lengths(self, input_lengths):
        """HF Wav2Vec2Model._get_feat_extract_output_lengths (ints or
        integer tensors)."""
        lengths = input_lengths
        for k, s in zip(self.conv_kernel, self.conv_stride):
            lengths = (lengths - k) // s + 1
        return lengths


def wav2vec2_large_audio_config() -> Wav2Vec2Config:
    """facebook/wav2vec2-large: 24 pre-LN layers, 16 heads, hidden 1024, a
    layer-norm conv stack with conv biases."""
    return Wav2Vec2Config(
        hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
        intermediate_size=4096, conv_bias=True,
        do_stable_layer_norm=True, feat_extract_norm="layer")


def hubert_large_audio_config() -> Wav2Vec2Config:
    """facebook/hubert-large-ls960-ft: the wav2vec2-large skeleton and key
    layout (models/hf_convert.wav2vec2_from_hf converts it)."""
    return wav2vec2_large_audio_config()


def wavlm_large_audio_config() -> Wav2Vec2Config:
    """microsoft/wavlm-large: the wav2vec2-large skeleton without conv
    biases, plus the gated bucketed relative position bias (320 buckets,
    max distance 800)."""
    return Wav2Vec2Config(
        hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
        intermediate_size=4096, conv_bias=False,
        do_stable_layer_norm=True, feat_extract_norm="layer",
        gated_relpos_bias=True, num_buckets=320, max_bucket_distance=800)


AUDIO_BACKBONE_PRESETS = {
    "wav2vec2-base": Wav2Vec2Config,
    "wav2vec2-large": wav2vec2_large_audio_config,
    "hubert-large": hubert_large_audio_config,
    "wavlm-large": wavlm_large_audio_config,
}


@dataclasses.dataclass(frozen=True)
class XLMRConfig:
    vocab_size: int = 250002
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    num_labels: int = 4
    adapter_dim: int = 256
    shared_dim: int = 256
    num_heads: int = 8
    proj_dim: int = 512
    classifier_layers: int = 35
    classifier_base_dim: int = 512
    classifier_dropout: float = 0.15
    cross_dropout: float = 0.1
    fusion_dropout: float = 0.1
    anchor_dropout: float = 0.1
    use_quality_gates: bool = True
    use_audio_conditioning: bool = True
    use_asr: bool = False
    frontend_dsp: bool = True
    zero_non_accept: bool = False
    pad_frames_valid: bool = False
    audio: Wav2Vec2Config = dataclasses.field(default_factory=Wav2Vec2Config)
    text: XLMRConfig = dataclasses.field(default_factory=XLMRConfig)
    compute_dtype: str = "float32"
    remat_encoders: Union[bool, str] = True

    @property
    def audio_hidden(self) -> int:
        return self.audio.hidden_size

    @property
    def text_hidden(self) -> int:
        return self.text.hidden_size


@dataclasses.dataclass(frozen=True)
class DataConfig:
    sample_rate: int = 16000
    max_audio_seconds: float = 30.0
    min_audio_seconds: float = 0.5
    max_text_tokens: int = 64
    audio_buckets: Tuple[float, ...] = (2.0, 4.0, 8.0, 16.0, 30.0)
    dataset_root: str = "datasets"
    # per-utterance 8-dim ASR features in batches (`asr_feats`, built on
    # the host by frontend/asr.py; manifest text skips the transcription)
    emit_asr_feats: bool = False
    # False: the gates see no text (the reference's plain eval loop), so
    # every row takes the no-text LID constants (1.0, 0.0)
    gates_see_text: bool = True
    # pad audio to the batch's longest clip instead of the bucket cap
    pad_to_batch_max: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 5
    batch_size: int = 4
    lr: float = 1e-4
    warmup_ratio: float = 0.1
    augment: bool = False
    # one speed factor per step (one resampler runs) instead of one per row
    # (every factor's resampler runs); a row's factor has the same
    # distribution across steps either way (ops/audio_dsp.augment_batch)
    augment_speed_per_batch: bool = True
    proto_weight: float = 0.05
    save_dir: str = "checkpoints"
    resume_from: Optional[str] = None
    grad_clip: Optional[float] = None   # the reference's train_crema.py uses 1.0
    # microbatches per optimizer step; batch_size stays the effective batch
    # and must be divisible by it (train/train_step.py)
    grad_accum: int = 1
    # the audio/text groups' AdamW first moment in this dtype ("bfloat16");
    # the second moment stays f32. None keeps f32 everywhere
    backbone_moment_dtype: Optional[str] = None
    seed: int = 0
    # loss mix (the reference's train.py:151-168)
    focal_weight: float = 0.3
    anchor_weight: float = 0.1
    uncertainty_weight: float = 0.05
    proto_term_weight: float = 0.01
    supcon_weight: float = 0.0          # defined but off in the reference
    label_smoothing: float = 0.1
    scheduler: str = "warmup_cosine"    # or "cosine_restarts" (train_crema.py:45-69)
    restart_period_epochs: int = 3
    early_stop_patience: Optional[int] = None
    freeze_backbones: bool = True       # audio_encoder.py:15-17, text_encoder.py:13-15
    # train_crema.py preset knobs
    proto_l2_normalize: bool = False    # prototype loss on the L2-normalised fused vector
    focal_beta: float = 0.9999
    focal_gamma: float = 2.0
    # train_crema_final.py preset knobs: extra CE on a second augmented
    # forward, on a fraction of the optimizer steps
    consistency_aug_weight: float = 0.0
    consistency_aug_fraction: float = 0.3


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The ('data', 'model') mesh over the process group's ranks
    (parallel/mesh.py), used under a process group."""
    data_axis: int = -1                 # -1: the ranks left over go on 'data'
    model_axis: int = 1
    dcn_data: int = 1                   # > 1: hosts (slices) folded slice-major
    #                                     into 'data' (parallel/mesh.make_mesh)
    fsdp: bool = False                  # ZeRO: parameters, gradients and AdamW
    #                                     moments sharded over 'data'
    fsdp_min_size: Optional[int] = None # smaller leaves replicate
    #                                     (None: parallel/mesh.FSDP_MIN_SIZE)


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


_NESTED = {"model": ModelConfig, "data": DataConfig, "train": TrainConfig,
           "mesh": MeshConfig, "audio": Wav2Vec2Config, "text": XLMRConfig}


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def _from_dict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            continue
        if isinstance(v, dict) and k in _NESTED:
            v = _from_dict(_NESTED[k], v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


def from_json(s: str) -> ModelConfig:
    """ModelConfig from the JSON of a ModelConfig, or from a JAX
    checkpoint's whole-Config JSON (its "model" entry). Unknown keys are
    ignored, as the JAX package's loader does."""
    d = json.loads(s)
    return _from_dict(ModelConfig, d.get("model", d))


def config_from_json(s: str) -> Config:
    """Config from a whole-Config JSON (the port's or a JAX checkpoint's),
    by the rules of the JAX package's config.from_json: unknown keys are
    ignored; lists become tuples."""
    return _from_dict(Config, json.loads(s))

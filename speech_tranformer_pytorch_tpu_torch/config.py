"""Typed configuration for the PyTorch port of the Speech-Transformer.

The port keeps its own copy of the JAX package's configuration: the same
dataclasses, fields, defaults, five presets, ``get_config``,
``apply_overrides`` and ``validate``, so that ``to_dict()`` of every preset
equals the JAX package's (tests/test_torch_config.py holds them equal).
Fields that select JAX-only machinery (Pallas switches, ``scan_layers``,
mesh axes, ...) are kept so configs and checkpoints stay interchangeable;
the port reads only the ones its modules implement.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Tuple


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(x) for x in obj]
    return obj


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FeatureConfig(_Replace):
    """Log-mel filterbank front-end (Kaldi-style fbank)."""

    sample_rate: int = 16000
    frame_length_ms: float = 25.0   # Kaldi-style 25 ms window / 10 ms hop
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 80
    fft_length: int = 512          # next pow2 >= 400 samples @ 16 kHz
    low_freq: float = 20.0
    high_freq: float = 0.0         # 0 => Nyquist
    preemphasis: float = 0.97
    window: str = "povey"          # povey | hann | hamming
    dither: float = 0.0            # train-time dither amplitude (0 = off)
    use_log: bool = True
    cmvn: bool = True              # per-utterance mean-variance normalisation
    use_pallas: bool = True        # JAX package only; the port dispatches by device
    output_dtype: str = "float32"  # feature dtype handed to the model; the cast
                                   # happens after CMVN, whose statistics stay f32

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig(_Replace):
    """SpecAugment (Park et al., 2019) — Large/LibriSpeech presets."""

    enabled: bool = False
    num_freq_masks: int = 2
    freq_mask_width: int = 27
    num_time_masks: int = 2
    time_mask_width: int = 100
    time_mask_max_frac: float = 0.2
    time_masks_per_frame: float = 0.0
    max_total_frac: float = 0.6


@dataclasses.dataclass(frozen=True)
class ModelConfig(_Replace):
    """Encoder-decoder Transformer dims (Speech-Transformer paper, Table 1)."""

    vocab_size: int = 4336         # AISHELL-1 chars + specials
    d_model: int = 512
    num_heads: int = 8
    d_ff: int = 2048
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    dropout_rate: float = 0.1
    attention_dropout_rate: float = 0.0
    input_dim: int = 80            # mel bins
    subsample_channels: int = 64   # conv2d-subsampling channel width
    subsample_impl: str = "conv"   # the port implements 'conv'
    max_source_positions: int = 3000
    max_target_positions: int = 512
    share_embedding: bool = True   # tie decoder embed and output projection
    fused_qkv: bool = True         # self-attn q/k/v as one [d,3,H,Dh] kernel
    normalize_before: bool = True  # pre-LN; False = the paper's post-LN
    dtype: str = "bfloat16"        # activation dtype (params stay f32 in training)
    use_flash_attention: bool = False
    attention_impl: str = "auto"
    remat: bool = False
    attention_remat: bool = False
    scan_layers: bool = False
    attention_bf16_weights: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


@dataclasses.dataclass(frozen=True)
class TrainConfig(_Replace):
    """Noam/warmup Adam training."""

    batch_size: int = 64
    max_frames_per_batch: int = 0
    num_epochs: int = 80
    warmup_steps: int = 4000
    peak_lr_scale: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.98
    adam_eps: float = 1e-9
    grad_clip_norm: float = 5.0
    label_smoothing: float = 0.1
    weight_decay: float = 0.0
    mixed_precision: bool = True   # cast params to model.dtype for compute
    fused_optimizer: bool = False
    moment_dtype: str = "bfloat16"
    master_weights: bool = False
    dropout_rng_impl: str = "rbg"
    seed: int = 0
    log_every: int = 100
    checkpoint_every_steps: int = 1000
    keep_checkpoints: int = 5
    eval_every_steps: int = 2000
    dev_decode_batches: int = 4


@dataclasses.dataclass(frozen=True)
class DataConfig(_Replace):
    train_manifest: str = ""
    dev_manifest: str = ""
    test_manifest: str = ""
    vocab_path: str = ""
    tokenizer: str = "char"            # char | bpe
    pipeline: str = "python"           # python | grain
    bpe_vocab_size: int = 5000
    max_source_frames: int = 3000
    max_target_len: int = 128
    adaptive_target_len: bool = True
    bucket_boundaries: Tuple[int, ...] = (200, 400, 600, 800, 1000, 1400, 2000, 3000)
    num_workers: int = 2
    audio_dtype: str = "int16"         # int16 PCM is dequantized by 1/32768 on device


@dataclasses.dataclass(frozen=True)
class DecodeConfig(_Replace):
    beam_size: int = 5
    max_decode_len: int = 100
    length_penalty: float = 1.0        # GNMT-style ((5+len)/6)^alpha weighting
    max_len_ratio: float = 0.0
    int8_weights: bool = False
    int8_kv_cache: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig(_Replace):
    data_axis: int = 0
    model_axis: int = 1
    axis_names: Tuple[str, str] = ("data", "model")


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "base"
    features: FeatureConfig = dataclasses.field(default_factory=FeatureConfig)
    spec_augment: SpecAugmentConfig = dataclasses.field(default_factory=SpecAugmentConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    decode: DecodeConfig = dataclasses.field(default_factory=DecodeConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def to_dict(self) -> dict:
        return _asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def config_hash(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]

    def model_hash(self) -> str:
        """Hash of the checkpoint-compatibility surface only (architecture +
        features)."""
        payload = json.dumps(
            {"model": _asdict(self.model), "features": _asdict(self.features)},
            sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "ExperimentConfig":
        """Raise ValueError on inconsistent settings; returns self."""
        m, d, t = self.model, self.data, self.train
        errs = []
        if m.d_model % m.num_heads != 0:
            errs.append(f"d_model {m.d_model} not divisible by num_heads "
                        f"{m.num_heads}")
        if m.vocab_size < 5:
            errs.append(f"vocab_size {m.vocab_size} too small (needs 4 "
                        f"specials + >=1 token)")
        if d.max_target_len > m.max_target_positions:
            errs.append(f"data.max_target_len {d.max_target_len} exceeds "
                        f"model.max_target_positions {m.max_target_positions}"
                        f" (targets would overflow the positional table)")
        if t.moment_dtype not in ("float32", "bfloat16"):
            errs.append(f"train.moment_dtype {t.moment_dtype!r} not in "
                        f"('float32', 'bfloat16')")
        if d.audio_dtype not in ("int16", "float32"):
            errs.append(f"data.audio_dtype {d.audio_dtype!r} not in "
                        f"('int16', 'float32')")
        if t.master_weights:
            if not t.fused_optimizer:
                errs.append("train.master_weights requires "
                            "train.fused_optimizer=True (optax's "
                            "apply_updates contract cannot emit "
                            "compute-dtype params from an f32 master)")
            if not t.mixed_precision or m.dtype == "float32":
                errs.append("train.master_weights is pointless without "
                            "mixed precision and a non-f32 model.dtype "
                            "(params would just be a second f32 copy)")
        if d.bucket_boundaries and max(d.bucket_boundaries) < d.max_source_frames:
            errs.append(f"largest bucket boundary "
                        f"{max(d.bucket_boundaries)} < data.max_source_frames "
                        f"{d.max_source_frames}: long utterances would be "
                        f"clipped below the configured max")
        if m.subsample_impl not in ("im2col", "conv", "phase"):
            errs.append(f"model.subsample_impl {m.subsample_impl!r} not in "
                        f"('im2col', 'conv', 'phase')")
        if self.decode.beam_size < 1:
            errs.append("decode.beam_size must be >= 1")
        if (d.tokenizer == "bpe" and d.bpe_vocab_size != m.vocab_size):
            errs.append(f"data.bpe_vocab_size {d.bpe_vocab_size} != "
                        f"model.vocab_size {m.vocab_size}: with a BPE "
                        f"tokenizer the model's output dim must match the "
                        f"trained BPE vocabulary")
        if self.features.output_dtype not in ("float32", "bfloat16"):
            errs.append(f"features.output_dtype "
                        f"{self.features.output_dtype!r} not in "
                        f"('float32', 'bfloat16')")
        if m.attention_impl not in ("auto", "dot", "flash", "ring"):
            errs.append(f"model.attention_impl {m.attention_impl!r} not in "
                        f"('auto', 'dot', 'flash', 'ring')")
        if m.attention_impl == "ring" and m.attention_dropout_rate > 0.0:
            errs.append("attention_impl='ring' does not support attention "
                        "dropout (set model.attention_dropout_rate=0.0)")
        if self.mesh.model_axis >= 1 and m.num_heads % self.mesh.model_axis != 0:
            errs.append(f"num_heads {m.num_heads} not divisible by TP degree "
                        f"{self.mesh.model_axis}")
        if errs:
            raise ValueError("invalid config:\n  - " + "\n  - ".join(errs))
        return self


def _nested_replace(cfg: Any, dotted: str, value: Any) -> Any:
    """Apply one ``section.field=value`` override."""
    parts = dotted.split(".")
    if len(parts) == 1:
        return dataclasses.replace(cfg, **{parts[0]: value})
    section_name, field = parts[0], ".".join(parts[1:])
    section = getattr(cfg, section_name)
    new_section = (_nested_replace(section, field, value) if "." in field
                   else dataclasses.replace(section, **{field: value}))
    return dataclasses.replace(cfg, **{section_name: new_section})


def apply_overrides(cfg: ExperimentConfig, overrides: dict[str, Any]) -> ExperimentConfig:
    for key, value in overrides.items():
        cfg = _nested_replace(cfg, key, value)
    return cfg


# ---------------------------------------------------------------------------
# Presets — the same five as the JAX package.
# ---------------------------------------------------------------------------

def tiny_config() -> ExperimentConfig:
    """3-enc/3-dec, d_model=256, 4 heads — CPU-runnable test size."""
    return ExperimentConfig(
        name="tiny",
        model=ModelConfig(
            vocab_size=64, d_model=256, num_heads=4, d_ff=1024,
            num_encoder_layers=3, num_decoder_layers=3,
            subsample_channels=32, dropout_rate=0.1,
            max_source_positions=512, max_target_positions=64,
            use_flash_attention=False, dtype="float32",
        ),
        train=TrainConfig(batch_size=8, warmup_steps=100, grad_clip_norm=5.0),
        data=DataConfig(max_target_len=32, max_source_frames=512,
                        bucket_boundaries=(100, 200, 300, 512)),
        decode=DecodeConfig(beam_size=5, max_decode_len=32),
    )


def base_config() -> ExperimentConfig:
    """6/6, d_model=512, 8 heads — the paper / AISHELL-1 headline config."""
    return ExperimentConfig(
        name="base",
        features=FeatureConfig(output_dtype="bfloat16"))


def large_config() -> ExperimentConfig:
    """12-enc/6-dec, d_model=768, SpecAugment + 3000-frame buckets."""
    return ExperimentConfig(
        name="large",
        features=FeatureConfig(output_dtype="bfloat16"),
        model=ModelConfig(
            d_model=768, num_heads=12, d_ff=3072,
            num_encoder_layers=12, num_decoder_layers=6,
            max_source_positions=3000, remat=True, scan_layers=True,
        ),
        spec_augment=SpecAugmentConfig(enabled=True, num_time_masks=10,
                                       time_masks_per_frame=0.005),
        train=TrainConfig(batch_size=96, warmup_steps=8000),
    )


def librispeech_config() -> ExperimentConfig:
    """LibriSpeech-960h, BPE-5k subword outputs, label smoothing 0.1."""
    return ExperimentConfig(
        name="librispeech",
        features=FeatureConfig(output_dtype="bfloat16"),
        model=ModelConfig(
            vocab_size=5000, d_model=512, num_heads=8,
            num_encoder_layers=12, num_decoder_layers=6,
            max_target_positions=256,
        ),
        spec_augment=SpecAugmentConfig(enabled=True, num_time_masks=10,
                                       time_masks_per_frame=0.005),
        data=DataConfig(tokenizer="bpe", bpe_vocab_size=5000, max_target_len=256),
        train=TrainConfig(batch_size=96, warmup_steps=10000, label_smoothing=0.1),
    )


def sharded_config() -> ExperimentConfig:
    """d_model=2048 encoder with tensor-parallel ring attention (the port
    has no parallel path yet; the preset is kept for config parity)."""
    return ExperimentConfig(
        name="sharded",
        features=FeatureConfig(output_dtype="bfloat16"),
        model=ModelConfig(
            d_model=2048, num_heads=16, d_ff=8192,
            num_encoder_layers=12, num_decoder_layers=6,
            subsample_channels=128, remat=True, scan_layers=True,
            attention_impl="ring",
        ),
        train=TrainConfig(batch_size=256, warmup_steps=12000),
        mesh=MeshConfig(data_axis=0, model_axis=4),
    )


PRESETS = {
    "tiny": tiny_config,
    "base": base_config,
    "large": large_config,
    "librispeech": librispeech_config,
    "sharded": sharded_config,
}


def get_config(name: str, **overrides: Any) -> ExperimentConfig:
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; choose from {sorted(PRESETS)}")
    cfg = PRESETS[name]()
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg

"""Typed configuration for the PyTorch port of the Speech-Transformer.

The port keeps its own copy of the JAX package's configuration: the same
dataclasses, fields, defaults, five presets, ``get_config``,
``apply_overrides`` and ``validate``, so that ``to_dict()`` of every preset
equals the JAX package's (tests/test_torch_config.py holds them equal).
Fields that select JAX-only machinery (Pallas switches, ``scan_layers``,
mesh axes, ...) are kept so configs and checkpoints stay interchangeable;
the port reads only the ones its modules implement. ``scan_layers`` (JAX's
weight-stacked ``nn.scan`` over the encoder layers, a compile-time lever)
is read only by ``convert.py``, which unstacks such a tree; the port always
builds its layers one by one.

The port adds fields of its own (``PORT_ONLY``), off by default: the CTC
head of the hybrid CTC/attention model (``model.ctc_head``), the CTC share
of the training loss (``train.ctc_weight``, ESPnet's ``mtlalpha``) and of
the beam search's scores (``decode.ctc_weight``), and the encoder's kind
(``model.encoder``: the Speech-Transformer's, or ESPnet's Conformer with
its depthwise convolution's kernel ``model.conv_kernel``), and what
OpenAI's Whisper needs (``SERVING_ONLY``: its log-mel front end, the Conv1d
stem, its position tables, no embedding scale, GELU, LayerNorm's epsilon,
a forced prompt and suppressed ids), which only the
single-device beam search serves. ``jax_dict()`` is ``to_dict()`` without
them where they hold their defaults, and the hashes are taken over it, so
a preset's hashes stay the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, List, Tuple


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
    kind: str = "kaldi"            # port only: kaldi | whisper (data/features.py)

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
    subsample_impl: str = "conv"   # conv | im2col | phase: one conv in the port
    max_source_positions: int = 3000
    max_target_positions: int = 512
    share_embedding: bool = True   # tie decoder embed and output projection
    fused_qkv: bool = True         # self-attn q/k/v as one [d,3,H,Dh] kernel
    normalize_before: bool = True  # pre-LN; False = the paper's post-LN
    dtype: str = "bfloat16"        # activation dtype (params stay f32 in training)
    use_flash_attention: bool = False
    attention_impl: str = "auto"
    remat: bool = False            # torch.utils.checkpoint per layer (training)
    attention_remat: bool = False
    scan_layers: bool = False      # JAX-only; the port reads it in convert.py
    attention_bf16_weights: bool = True
    ctc_head: bool = False         # port only: a CTC head (Linear d_model -> V) on the encoder
    encoder: str = "transformer"   # port only: transformer | conformer (models/conformer.py)
    conv_kernel: int = 31          # port only: the Conformer's depthwise convolution kernel
    stem: str = "conv2d"           # port only: conv2d (Conv2dSubsampling) | conv1d_gelu (Whisper's)
    encoder_positions: str = "sinusoidal"   # port only: sinusoidal | whisper ([sin | cos])
    decoder_positions: str = "sinusoidal"   # port only: sinusoidal | learned
    embed_scale: bool = True       # port only: the decoder's embedding times sqrt(d_model)
    activation: str = "relu"       # port only: relu | gelu (exact), the Transformer FFNs'
    layer_norm_eps: float = 1e-6   # port only: the Transformer encoder's and decoder's

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
    ctc_weight: float = 0.0            # port only: the CTC share of the loss (needs model.ctc_head)


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
    ctc_weight: float = 0.0            # port only: CTC prefix scores' share (model.ctc_head)
    prompt: Tuple[int, ...] = ()       # port only: forced start tokens; () = <sos> alone
    suppress: Tuple[int, ...] = ()     # port only: ids never emitted
    suppress_first: Tuple[int, ...] = ()   # port only: ids not emitted as the first token


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

    def jax_dict(self) -> dict:
        """``to_dict()`` without the ``PORT_ONLY`` fields that hold their
        defaults: the JAX package's ``to_dict()`` of a config without them."""
        return drop_port_only(self.to_dict())

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def config_hash(self) -> str:
        payload = json.dumps(self.jax_dict(), indent=2, sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def model_hash(self) -> str:
        """Hash of the checkpoint-compatibility surface only (architecture +
        features)."""
        d = self.jax_dict()
        payload = json.dumps({"model": d["model"], "features": d["features"]},
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
        for section, w in (("train", t.ctc_weight), ("decode", self.decode.ctc_weight)):
            if not 0.0 <= w <= 1.0:
                errs.append(f"{section}.ctc_weight {w} not in [0, 1]")
            elif w > 0.0 and not m.ctc_head:
                errs.append(f"{section}.ctc_weight {w} needs model.ctc_head=True")
        if m.encoder not in ("transformer", "conformer"):
            errs.append(f"model.encoder {m.encoder!r} not in ('transformer', 'conformer')")
        elif m.encoder == "conformer":
            if m.conv_kernel < 1 or m.conv_kernel % 2 == 0:
                errs.append(f"model.conv_kernel {m.conv_kernel} must be odd and positive "
                            f"(the depthwise convolution keeps the frame count)")
            if m.attention_impl == "ring":
                errs.append("model.encoder='conformer' has no ring attention: its "
                            "relative-position attention runs on one device")
            if m.remat or not m.normalize_before:
                errs.append("model.encoder='conformer' is the pre-LN block without "
                            "remat (set model.remat=False, model.normalize_before=True)")
        errs += _serving_only_errors(self)
        if m.attention_impl == "ring" and m.attention_dropout_rate > 0.0:
            errs.append("attention_impl='ring' does not support attention "
                        "dropout (set model.attention_dropout_rate=0.0)")
        if self.mesh.model_axis >= 1 and m.num_heads % self.mesh.model_axis != 0:
            errs.append(f"num_heads {m.num_heads} not divisible by TP degree "
                        f"{self.mesh.model_axis}")
        if errs:
            raise ValueError("invalid config:\n  - " + "\n  - ".join(errs))
        return self


def _serving_only_errors(cfg: ExperimentConfig) -> List[str]:
    """The checks of the ``SERVING_ONLY`` fields."""
    f, m, dec = cfg.features, cfg.model, cfg.decode
    errs = [f"{name} {value!r} not in {allowed}" for name, value, allowed in (
        ("features.kind", f.kind, ("kaldi", "whisper")),
        ("model.stem", m.stem, ("conv2d", "conv1d_gelu")),
        ("model.encoder_positions", m.encoder_positions, ("sinusoidal", "whisper")),
        ("model.decoder_positions", m.decoder_positions, ("sinusoidal", "learned")),
        ("model.activation", m.activation, ("relu", "gelu"))) if value not in allowed]
    if f.kind == "whisper" and f.fft_length != f.frame_length:
        errs.append("features.kind='whisper' needs fft_length == frame_length (Whisper's "
                    "400-point window and DFT)")
    ids = {"decode.prompt": dec.prompt, "decode.suppress": dec.suppress,
           "decode.suppress_first": dec.suppress_first}
    errs += [f"{name} {list(v)} holds an id outside the vocabulary of {m.vocab_size}"
             for name, v in ids.items() if any(not 0 <= t < m.vocab_size for t in v)]
    only = serving_only_fields(cfg)
    if only:
        clash = [what for what, on in (
            ("model.encoder='conformer'", m.encoder == "conformer"),
            ("model.ctc_head", m.ctc_head), ("attention_impl='ring'", m.attention_impl == "ring"),
            ("decode.int8_weights", dec.int8_weights), ("decode.int8_kv_cache", dec.int8_kv_cache),
            ("model.remat", m.remat), ("post-LN (normalize_before=False)", not m.normalize_before))
            if on]
        if clash:
            errs.append(f"{only} are served by the single-device pre-LN beam search alone; "
                        f"{clash} has no path with them")
    return errs


# Fields the JAX package does not have, with their defaults (a tuple field's
# as its ``to_dict()`` list).
PORT_ONLY = {"features": {"kind": "kaldi"},
             "model": {"ctc_head": False, "encoder": "transformer", "conv_kernel": 31,
                       "stem": "conv2d", "encoder_positions": "sinusoidal",
                       "decoder_positions": "sinusoidal", "embed_scale": True,
                       "activation": "relu", "layer_norm_eps": 1e-6},
             "train": {"ctc_weight": 0.0},
             "decode": {"ctc_weight": 0.0, "prompt": [], "suppress": [],
                        "suppress_first": []}}

# The port-only fields that only the single-device beam search serves
# (Whisper's): training, a mesh, int8 serving, export and greedy search
# refuse a configuration that sets one away from its default.
SERVING_ONLY = (("features", "kind"), ("model", "stem"), ("model", "encoder_positions"),
                ("model", "decoder_positions"), ("model", "embed_scale"),
                ("model", "activation"), ("model", "layer_norm_eps"), ("decode", "prompt"),
                ("decode", "suppress"), ("decode", "suppress_first"))


def serving_only_fields(cfg: ExperimentConfig) -> List[str]:
    """The ``SERVING_ONLY`` fields of ``cfg`` away from their defaults."""
    d = cfg.to_dict()
    return [f"{section}.{name}" for section, name in SERVING_ONLY
            if d[section][name] != PORT_ONLY[section][name]]


def drop_port_only(d: dict) -> dict:
    """A copy of a ``to_dict()`` without the ``PORT_ONLY`` fields that hold
    their defaults."""
    out = {key: dict(v) if isinstance(v, dict) else v for key, v in d.items()}
    for section, fields in PORT_ONLY.items():
        for name, default in fields.items():
            if out.get(section, {}).get(name, default) == default:
                out.get(section, {}).pop(name, None)
    return out


def config_from_dict(d: dict) -> ExperimentConfig:
    """Inverse of ``ExperimentConfig.to_dict`` (a run's ``config.json``):
    unknown keys are ignored and lists become tuples."""
    sections = {
        "features": FeatureConfig, "spec_augment": SpecAugmentConfig,
        "model": ModelConfig, "train": TrainConfig, "data": DataConfig,
        "decode": DecodeConfig, "mesh": MeshConfig,
    }
    kw: dict = {"name": d.get("name", "custom")}
    for key, cls in sections.items():
        if key in d:
            fields = {f.name for f in dataclasses.fields(cls)}
            kw[key] = cls(**{k: (tuple(v) if isinstance(v, list) else v)
                             for k, v in d[key].items() if k in fields})
    return ExperimentConfig(**kw)


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
# Presets — the same five as the JAX package, and the port's own Conformer
# and Whisper.
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


def librispeech_conformer_config() -> ExperimentConfig:
    """ESPnet's LibriSpeech Conformer with hybrid CTC/attention decoding
    (``egs2/librispeech/asr1``, ``conf/tuning/train_asr_conformer*.yaml``;
    Gulati et al., 2020; Guo et al., 2021): ``librispeech`` with 12
    Conformer blocks (relative-position self-attention, a depthwise
    convolution of kernel 31, macaron feed-forwards with Swish), 512
    subsampling channels, attention dropout 0.1, a CTC head and CTC weight
    0.3 in training and decoding. A port-only preset: the JAX package has
    no Conformer."""
    cfg = librispeech_config()
    return cfg.replace(
        name="librispeech_conformer",
        model=cfg.model.replace(encoder="conformer", conv_kernel=31, subsample_channels=512,
                                attention_dropout_rate=0.1, ctc_head=True),
        train=cfg.train.replace(ctc_weight=0.3),
        decode=cfg.decode.replace(ctc_weight=0.3))


# Whisper's special ids as the port places them (the port keeps <pad>, <sos>
# and <eos> at 0, 1 and 2): <|startoflm|> is 0, <|startoftranscript|> 1 and
# <|endoftext|> 2, and the tokens v3 puts there ('!', '"', '#') sit at v3's
# ids of those three; every other id is v3's.
WHISPER_IDS = {"sot_lm": 0, "sot": 1, "eot": 2, "blank": 220, "en": 50259,
               "translate": 50359, "transcribe": 50360, "sot_prev": 50362,
               "no_speech": 50363, "notimestamps": 50364}


def whisper_large_v3_config() -> ExperimentConfig:
    """OpenAI's Whisper large-v3 (Radford et al., 2022; ``openai/whisper``
    ``model.py``, ``audio.py``, ``decoding.py``; the model card's
    ``config.json``): 32 + 32 pre-LN layers at d_model 1280, 20 heads, FFN
    5120 with GELU, LayerNorm epsilon 1e-5 (Whisper's keys have no bias;
    the port's key biases, which move no attention, load as zeros); a
    128-bin log-mel of 30-s windows, a Conv1d stem, [sin | cos] encoder positions
    and learned decoder positions (448), no embedding scale, a tied
    vocabulary of 51,866. Decoding starts after the forced prompt
    <|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|> and
    suppresses Whisper's special ids (``SuppressTokens``; <|endoftext|> and
    " " at the first token, ``SuppressBlank``); beam 5 with the GNMT
    penalty at alpha 1 (Whisper's ``length_penalty=1.0``). A port-only
    preset: the JAX package has none of it."""
    ids = WHISPER_IDS
    return ExperimentConfig(
        name="whisper_large_v3",
        features=FeatureConfig(num_mel_bins=128, fft_length=400, low_freq=0.0,
                               preemphasis=0.0, window="hann", cmvn=False,
                               output_dtype="bfloat16", kind="whisper"),
        model=ModelConfig(
            vocab_size=51866, d_model=1280, num_heads=20, d_ff=5120,
            num_encoder_layers=32, num_decoder_layers=32, dropout_rate=0.0,
            input_dim=128, max_source_positions=1500, max_target_positions=448,
            stem="conv1d_gelu", encoder_positions="whisper", decoder_positions="learned",
            embed_scale=False, activation="gelu", layer_norm_eps=1e-5),
        data=DataConfig(max_target_len=224),
        decode=DecodeConfig(
            beam_size=5, max_decode_len=224, length_penalty=1.0,
            prompt=(ids["sot"], ids["en"], ids["transcribe"], ids["notimestamps"]),
            suppress=tuple(ids[n] for n in ("sot_lm", "sot", "translate", "transcribe",
                                            "sot_prev", "no_speech")),
            suppress_first=(ids["eot"], ids["blank"])))


def sharded_config() -> ExperimentConfig:
    """d_model=2048 with tensor parallelism over 4 ranks and ring attention
    in the encoder: the port trains and decodes it on a mesh
    (``parallel/``); on fewer ranks ``mesh='auto'`` falls back to one
    device with a warning."""
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

# The port's own presets, which the JAX package has no counterpart of.
PORT_PRESETS = {
    "librispeech_conformer": librispeech_conformer_config,
    "whisper_large_v3": whisper_large_v3_config,
}


def get_config(name: str, **overrides: Any) -> ExperimentConfig:
    presets = {**PRESETS, **PORT_PRESETS}
    if name not in presets:
        raise ValueError(f"unknown preset {name!r}; choose from {sorted(presets)}")
    cfg = presets[name]()
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg

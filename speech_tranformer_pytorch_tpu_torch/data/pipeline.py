"""Input pipeline and audio-batch train step (counterpart of the JAX
package's ``data/pipeline.py``).

The host reads a manifest, shuffles each epoch from a seed, buckets
utterances by frame count, pads each batch to its bucket's shape and reads
the PCM (``ManifestDataset``, ``plan_epoch``, ``BucketedBatcher``). The
epoch plan needs only manifest metadata, so a resumed run skips into an
epoch without reading audio. Batches are built in numpy and handed over as
CPU tensors in an ``AudioBatch``; padding rows (``valid=False``) fill a
remainder batch to its bucket's size.

The features are computed on the device inside the step: fbank + CMVN run
under ``torch.no_grad()`` through ``extract_features`` (the stft_mel kernel
on a card, once per step), SpecAugment masks them when the config enables
it, then the train step of ``train.py`` runs on the result
(``make_preprocess_fn``, ``make_audio_train_step``). As JAX splits one
step key into an augmentation key and a dropout key, the port draws the
masks from a generator of (seed, step) on a stream of its own
(``ops/dropout.AUGMENT_STREAM``), which leaves the dropout bits as they
were. Evaluation and serving never augment.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DataConfig, ExperimentConfig, FeatureConfig, SpecAugmentConfig
from ..ops.dropout import AUGMENT_STREAM, step_generator
from ..train import Batch, TrainState, make_train_step
from .augment import spec_augment
from .features import extract_features
from .prepare import read_audio, read_manifest
from .tokenizer import EOS, PAD, SOS


@dataclasses.dataclass(frozen=True)
class AudioBatch:
    """Padded raw-audio batch (features are computed on the device)."""
    audio: torch.Tensor          # [B, S] int16 PCM or float32
    sample_lens: torch.Tensor    # [B]
    targets_in: torch.Tensor     # [B, U]
    targets_out: torch.Tensor    # [B, U]
    target_lens: torch.Tensor    # [B]
    valid: torch.Tensor          # [B] bool — False for eval-padding rows

    def to(self, device) -> "AudioBatch":
        return AudioBatch(*(torch.as_tensor(getattr(self, f.name)).to(device)
                            for f in dataclasses.fields(self)))


def _frames_for_samples(n: int, fcfg: FeatureConfig) -> int:
    if n < fcfg.frame_length:
        return 0
    return 1 + (n - fcfg.frame_length) // fcfg.frame_shift


def _samples_for_frames(frames: int, fcfg: FeatureConfig) -> int:
    return fcfg.frame_length + (frames - 1) * fcfg.frame_shift


class ManifestDataset:
    """A manifest's entries, without those too short for one frame, longer
    than ``data.max_source_frames`` or with more than
    ``data.max_target_len - 1`` tokens; ``dropped`` counts those."""

    def __init__(self, manifest_path: str, data_cfg: DataConfig,
                 feature_cfg: FeatureConfig):
        entries = read_manifest(manifest_path)
        self.fcfg = feature_cfg
        self.audio_dtype = data_cfg.audio_dtype
        kept = []
        for e in entries:
            frames = _frames_for_samples(e["num_samples"], feature_cfg)
            if frames == 0 or frames > data_cfg.max_source_frames:
                continue
            if len(e["tokens"]) + 1 > data_cfg.max_target_len:
                continue
            kept.append(e)
        self.dropped = len(entries) - len(kept)
        self.entries = kept

    def __len__(self) -> int:
        return len(self.entries)


@dataclasses.dataclass(frozen=True)
class PlannedBatch:
    """One global batch, decided from manifest metadata alone."""
    bucket: int
    global_idxs: Tuple[int, ...]   # entry indices, in plan order
    pad_to_batch: bool             # a remainder batch: pad rows to full size


def target_width_for_rows(ds: ManifestDataset, global_idxs, target_len: int, *,
                          adaptive: bool = True) -> int:
    """A batch's target pad width: the smallest multiple of 16 that holds
    its longest target and the <sos>/<eos> column, capped at
    ``target_len``; ``target_len`` itself when not ``adaptive`` or when
    ``target_len <= 16``. Computed from the global plan rows, so every
    shard of a batch picks the same width."""
    if not adaptive or target_len <= 16:
        return target_len
    need = 2
    for i in global_idxs:
        need = max(need, min(len(ds.entries[i]["tokens"]), target_len - 1) + 1)
    return min(target_len, -(-need // 16) * 16)


def _bucket_of(frames: int, boundaries: Sequence[int]) -> int:
    for i, b in enumerate(boundaries):
        if frames <= b:
            return i
    return len(boundaries) - 1


def plan_epoch(ds: ManifestDataset, *, boundaries: Sequence[int],
               bucket_batch_sizes: Sequence[int], num_shards: int, seed: int,
               epoch_index: int, shuffle: bool, drop_remainder: bool
               ) -> List[PlannedBatch]:
    """The epoch's batches from metadata alone. The order is shuffled by
    ``np.random.default_rng(seed + epoch_index)``; each utterance joins the
    bucket of its frame count, and a bucket emits a batch once it holds
    ``bucket_batch_sizes[b] * num_shards`` utterances. Without
    ``drop_remainder`` the partly filled buckets follow, in bucket order."""
    order = np.arange(len(ds))
    if shuffle:
        np.random.default_rng(seed + epoch_index).shuffle(order)
    plans: List[PlannedBatch] = []
    buckets: Dict[int, List[int]] = {}
    for idx in order:
        e = ds.entries[idx]
        b = _bucket_of(_frames_for_samples(e["num_samples"], ds.fcfg), boundaries)
        buckets.setdefault(b, []).append(int(idx))
        if len(buckets[b]) == bucket_batch_sizes[b] * num_shards:
            plans.append(PlannedBatch(b, tuple(buckets.pop(b)), False))
    if not drop_remainder:
        for b, global_idxs in sorted(buckets.items()):
            if global_idxs:
                plans.append(PlannedBatch(b, tuple(global_idxs), True))
    return plans


class BucketedBatcher:
    """Length-bucketed, epoch-shuffled, host-sharded batches of a
    ``ManifestDataset``. Shard ``shard_index`` of ``num_shards`` takes
    every ``num_shards``-th row of each planned batch. With
    ``max_frames_per_batch`` each bucket's batch size is that budget over
    the bucket's frame bound (at least 1); otherwise ``batch_size``."""

    def __init__(self, ds: ManifestDataset, *, batch_size: int,
                 bucket_boundaries: Sequence[int], target_len: int, seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1,
                 drop_remainder: bool = True, shuffle: bool = True,
                 max_frames_per_batch: int = 0, adaptive_target_len: bool = True):
        self.ds = ds
        self.boundaries = list(bucket_boundaries)
        self.adaptive_target_len = adaptive_target_len
        if max_frames_per_batch > 0:
            self.bucket_batch_sizes = [max(max_frames_per_batch // bnd, 1)
                                       for bnd in self.boundaries]
        else:
            self.bucket_batch_sizes = [batch_size] * len(self.boundaries)
        self.target_len = target_len
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.drop_remainder = drop_remainder
        self.shuffle = shuffle

    def plan(self, epoch_index: int) -> List[PlannedBatch]:
        return plan_epoch(
            self.ds, boundaries=self.boundaries,
            bucket_batch_sizes=self.bucket_batch_sizes,
            num_shards=self.num_shards, seed=self.seed, epoch_index=epoch_index,
            shuffle=self.shuffle, drop_remainder=self.drop_remainder)

    def epoch(self, epoch_index: int, skip_batches: int = 0,
              with_rows: bool = False) -> Iterator:
        """The shard's batches of the epoch, after the first
        ``skip_batches`` (skipped without reading audio). ``with_rows``
        yields ``(AudioBatch, entry indices)``: the indices pair each
        non-padding row with its manifest entry."""
        for p in self.plan(epoch_index)[skip_batches:]:
            idxs = list(p.global_idxs[self.shard_index::self.num_shards])
            width = target_width_for_rows(self.ds, p.global_idxs, self.target_len,
                                          adaptive=self.adaptive_target_len)
            batch = self._make_batch(idxs, p.bucket, pad_to_batch=p.pad_to_batch,
                                     target_width=width)
            yield (batch, idxs) if with_rows else batch

    def _make_batch(self, idxs: List[int], bucket: int, *, pad_to_batch: bool = False,
                    target_width: Optional[int] = None) -> AudioBatch:
        rows = []
        for idx in idxs:
            e = self.ds.entries[idx]
            rows.append((read_audio(e["audio"], dtype=self.ds.audio_dtype)[0], e["tokens"]))
        return assemble_batch(
            rows, max_samples=_samples_for_frames(self.boundaries[bucket], self.ds.fcfg),
            batch_rows=self.bucket_batch_sizes[bucket] if pad_to_batch else len(idxs),
            width=target_width or self.target_len,
            frame_length=self.ds.fcfg.frame_length, audio_dtype=self.ds.audio_dtype)


def assemble_batch(rows: Sequence[Tuple[np.ndarray, Sequence[int]]], *, max_samples: int,
                   batch_rows: int, width: int, frame_length: int,
                   audio_dtype: str) -> AudioBatch:
    """One padded ``AudioBatch`` of CPU tensors from ``(samples, tokens)``
    rows: audio cut to ``max_samples``, targets to ``width`` columns with
    ``<sos>``/``<eos>``, and ``batch_rows - len(rows)`` padding rows (one
    frame, ``<eos>`` only, ``valid=False``)."""
    adt = np.int16 if audio_dtype == "int16" else np.float32
    audio = np.zeros((batch_rows, max_samples), adt)
    slens = np.zeros((batch_rows,), np.int32)
    tin = np.full((batch_rows, width), PAD, np.int32)
    tout = np.full((batch_rows, width), PAD, np.int32)
    tlens = np.zeros((batch_rows,), np.int32)
    valid = np.zeros((batch_rows,), bool)
    for row, (samples, tokens) in enumerate(rows):
        n = min(len(samples), max_samples)
        audio[row, :n] = samples[:n]
        slens[row] = n
        toks = tokens[: width - 1]
        tin[row, 0] = SOS
        tin[row, 1:1 + len(toks)] = toks
        tout[row, :len(toks)] = toks
        tout[row, len(toks)] = EOS
        tlens[row] = len(toks) + 1
        valid[row] = True
    for row in range(len(rows), batch_rows):   # padding rows: one frame, <eos> only
        slens[row] = frame_length
        tlens[row] = 1
        tin[row, 0] = SOS
        tout[row, 0] = EOS
    return AudioBatch(*(torch.from_numpy(x)
                        for x in (audio, slens, tin, tout, tlens, valid)))


def make_preprocess_fn(feature_cfg: FeatureConfig,
                       spec_cfg: Optional[SpecAugmentConfig] = None):
    """``preprocess(batch, device, generator=None) -> Batch``: fbank + CMVN
    on ``device``, then SpecAugment when ``spec_cfg`` enables it and a
    generator is given (on ``device``)."""

    def preprocess(batch: AudioBatch, device,
                   generator: Optional[torch.Generator] = None) -> Batch:
        with torch.no_grad():
            feats, frame_lens = extract_features(batch.audio, batch.sample_lens,
                                                 feature_cfg, device=device)
            if spec_cfg is not None and spec_cfg.enabled and generator is not None:
                feats = spec_augment(generator, feats, frame_lens, spec_cfg)
        return Batch(feats=feats, frame_lens=frame_lens,
                     targets_in=batch.targets_in, targets_out=batch.targets_out,
                     target_lens=batch.target_lens).to(device)

    return preprocess


def make_audio_train_step(cfg: ExperimentConfig):
    """``step(state, audio_batch, seed=cfg.train.seed) -> (state, metrics)``:
    on-device preprocess (SpecAugment drawn from (seed, state.step) on its
    own stream) → model → loss → update."""
    preprocess = make_preprocess_fn(cfg.features, cfg.spec_augment)
    inner = make_train_step(cfg)
    augment = cfg.spec_augment.enabled

    def step(state: TrainState, abatch: AudioBatch, seed: int = cfg.train.seed):
        gen = (step_generator(seed, state.step, state.device, AUGMENT_STREAM)
               if augment else None)
        return inner(state, preprocess(abatch, state.device, gen), seed)

    return step

"""Worker-pool input pipeline, ``data.pipeline="grain"`` (counterpart of the
JAX package's ``data/grain_pipeline.py``, without the grain library).

The JAX package uses grain only as a parallel reader: the batches come from
the metadata-only ``plan_epoch`` that ``BucketedBatcher`` also uses, so
both pipelines give the same batches, and grain reads this shard's rows in
plan order. The port keeps that design on ``torch.utils.data.DataLoader``
(grain imports jax where jax is installed, and the port imports none of
it):

- a map-style dataset over the manifest reads one utterance a key;
- a batch sampler yields each planned batch's rows of this shard, in plan
  order; each key carries its batch's shape (``_BatchSpec``);
- the collate function is ``pipeline.assemble_batch``, which also builds
  ``BucketedBatcher``'s batches, so the two pipelines' ``AudioBatch``es are
  equal.

With ``num_workers`` > 0 the reads and the padding run in that many worker
processes; at 0 in the calling process. Batches come out in plan order
either way. ``epoch(e, skip_batches=n)`` resumes an epoch with no IO for
the skipped batches, as ``BucketedBatcher`` does.

Workers are started by a fork server (``forkserver``), not by ``fork``
from the caller: the ``Trainer`` creates the epoch's iterator in its
prefetch thread, in a process that holds a CUDA context and runs other
threads, and a child forked from it would inherit locks those threads may
hold. The fork server is a fresh interpreter, started once a process, that
imports this module (and with it torch) before it forks any worker, so a
worker starts without the import. Started with ``spawn`` instead, each
worker of each epoch imported torch itself: on an H100 machine's host the
first batch came 13-60 s after an epoch started with 2-8 workers
(``chip_smoke.py`` ``pipeline_path``). A worker never touches CUDA: it
reads files and builds CPU tensors, and the ``Trainer`` pins and copies
them. The ``DataLoader`` gets a ``timeout`` when it has workers, so a
worker that hangs fails the run instead of stalling it, and an epoch that
is left early (``max_steps``) shuts its workers down when its generator is
closed.
"""

from __future__ import annotations

import multiprocessing
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

from torch.utils.data import DataLoader, Dataset, Sampler

from .pipeline import (AudioBatch, ManifestDataset, PlannedBatch, _samples_for_frames,
                       assemble_batch, plan_epoch, target_width_for_rows)
from .prepare import read_audio

# Seconds a worker may take to deliver a batch (its first one includes the
# worker's start-up import) before the epoch fails.
WORKER_TIMEOUT_S = 300.0


class _BatchSpec(NamedTuple):
    """A planned batch's padded shape: ``assemble_batch``'s arguments."""
    max_samples: int
    batch_rows: int
    width: int
    frame_length: int
    audio_dtype: str


_Key = Tuple[Optional[int], _BatchSpec]   # (entry index, or None for no row)


class ManifestReads(Dataset):
    """A manifest's utterances by key ``(entry index, spec)``: returns
    ``(spec, (samples, tokens))``; the key ``(None, spec)`` of a shard with
    no row in a batch returns ``(spec, None)``."""

    def __init__(self, ds: ManifestDataset):
        self.entries = ds.entries
        self.audio_dtype = ds.audio_dtype

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, key: _Key):
        idx, spec = key
        if idx is None:
            return spec, None
        e = self.entries[idx]
        return spec, (read_audio(e["audio"], dtype=self.audio_dtype)[0], e["tokens"])


class PlannedBatches(Sampler):
    """Batch sampler: the keys of each planned batch's rows of one shard,
    in plan order."""

    def __init__(self, plans: Sequence[PlannedBatch], specs: Sequence[_BatchSpec],
                 shard_index: int, num_shards: int):
        self.plans, self.specs = list(plans), list(specs)
        self.shard_index, self.num_shards = shard_index, num_shards

    def __len__(self) -> int:
        return len(self.plans)

    def __iter__(self) -> Iterator[List[_Key]]:
        for p, spec in zip(self.plans, self.specs):
            rows = p.global_idxs[self.shard_index::self.num_shards]
            yield [(i, spec) for i in rows] or [(None, spec)]


def collate(items) -> AudioBatch:
    """A planned batch's ``(spec, row)`` items -> its ``AudioBatch``."""
    spec = items[0][0]
    return assemble_batch([row for _, row in items if row is not None],
                          **spec._asdict())


class GrainBucketedPipeline:
    """Deterministic sharded epoch iterator over bucketed ``AudioBatch``es:
    ``BucketedBatcher``'s plan (global order, global batch boundaries,
    frame-budget batch sizes), read by a ``DataLoader`` worker pool.
    ``bucket_batch_sizes`` may be changed after construction (the mesh
    ``Trainer`` rounds them); each epoch reads them when it starts."""

    def __init__(
        self,
        ds: ManifestDataset,
        *,
        batch_size: int,
        bucket_boundaries: Sequence[int],
        target_len: int,
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
        num_workers: int = 0,
        drop_remainder: bool = True,
        shuffle: bool = True,
        max_frames_per_batch: int = 0,
        adaptive_target_len: bool = True,
    ):
        self.ds = ds
        self.adaptive_target_len = adaptive_target_len
        self.batch_size = batch_size
        self.boundaries = list(bucket_boundaries)
        if max_frames_per_batch > 0:
            self.bucket_batch_sizes = [max(max_frames_per_batch // bnd, 1)
                                       for bnd in self.boundaries]
        else:
            self.bucket_batch_sizes = [batch_size] * len(self.boundaries)
        self.target_len = target_len
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.num_workers = num_workers
        self.drop_remainder = drop_remainder
        self.shuffle = shuffle

    def plan(self, epoch_index: int) -> List[PlannedBatch]:
        return plan_epoch(
            self.ds, boundaries=self.boundaries,
            bucket_batch_sizes=self.bucket_batch_sizes,
            num_shards=self.num_shards, seed=self.seed, epoch_index=epoch_index,
            shuffle=self.shuffle, drop_remainder=self.drop_remainder)

    def _spec(self, p: PlannedBatch) -> _BatchSpec:
        rows = len(p.global_idxs[self.shard_index::self.num_shards])
        return _BatchSpec(
            max_samples=_samples_for_frames(self.boundaries[p.bucket], self.ds.fcfg),
            batch_rows=self.bucket_batch_sizes[p.bucket] if p.pad_to_batch else rows,
            # From the global rows, so every shard of a batch has one width.
            width=target_width_for_rows(self.ds, p.global_idxs, self.target_len,
                                        adaptive=self.adaptive_target_len),
            frame_length=self.ds.fcfg.frame_length, audio_dtype=self.ds.audio_dtype)

    def epoch(self, epoch_index: int, skip_batches: int = 0) -> Iterator[AudioBatch]:
        """The shard's batches of the epoch after the first ``skip_batches``."""
        plans = self.plan(epoch_index)[skip_batches:]
        workers = self.num_workers > 0
        ctx = None
        if workers:
            ctx = multiprocessing.get_context("forkserver")
            ctx.set_forkserver_preload([__name__])   # read when the server starts
        loader = DataLoader(
            ManifestReads(self.ds),
            batch_sampler=PlannedBatches(plans, [self._spec(p) for p in plans],
                                         self.shard_index, self.num_shards),
            collate_fn=collate, num_workers=self.num_workers,
            multiprocessing_context=ctx, timeout=WORKER_TIMEOUT_S if workers else 0)
        it = iter(loader)
        try:
            yield from it
        finally:
            if workers:
                it._shutdown_workers()

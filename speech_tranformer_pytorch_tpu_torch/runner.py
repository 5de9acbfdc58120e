"""Training loop (counterpart of the JAX package's ``runner.py``): epochs
over a bucketed manifest, logging, step checkpoints with bit-exact resume,
dev loss with greedy dev CER, and best-model tracking in ``work_dir/best``.

With a mesh (``parallel.mesh.Mesh``, one process per card) each data rank
reads its stride of every globally planned batch, the steps are the
sharded ones of ``parallel/sharding.py``, dev CER runs the sharded greedy
decode, every rank computes the same log records and rank 0 alone writes
them and the checkpoints (whole trees, in the single-device format).
``data.pipeline`` picks the train batches' reader, as in JAX: "python"
reads them in the prefetch thread (``BucketedBatcher``), "grain" in a pool
of ``data.num_workers`` worker processes (``data/grain_pipeline.py``); both
give the same batches.

The hot loop never waits on the device per step: the step count
is a host ``int``, and the per-step metric tensors are read in one batch at
each log boundary. A prefetch thread reads and pads the batches and
queues their host-to-device copies, so the file reads and the host's
share of the copy overlap the device's work. The copy itself is queued on
the steps' stream and so runs on the device after the step before it,
not beside it.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import math
import sys
import time
import warnings
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.func import functional_call

from .config import ExperimentConfig
from .data.grain_pipeline import GrainBucketedPipeline
from .data.pipeline import (AudioBatch, BucketedBatcher, ManifestDataset,
                            make_audio_train_step, make_preprocess_fn)
from .data.prefetch import prefetch
from .data.tokenizer import EOS, PAD
from .decoding import greedy_decode, tokens_to_lists
from .device import DeviceLike, resolve_device
from .ops.losses import label_smoothed_cross_entropy
from .ops.metrics import cer
from .parallel.mesh import Mesh, make_mesh_auto
from .parallel.sharding import (make_sharded_audio_eval_step,
                                make_sharded_audio_train_step)
from .train import TrainState, cast_params, compute_cast_dtype, create_train_state
from .utils.checkpoint import Checkpointer, CheckpointState
from .utils.logging import MetricsLogger


def make_audio_eval_step(cfg: ExperimentConfig):
    """``eval_step(state, audio_batch) -> {"loss", "tokens"}``: deterministic
    dev loss, padding rows (``valid=False``) given no weight."""
    preprocess = make_preprocess_fn(cfg.features, None)
    cast_dt = compute_cast_dtype(cfg)
    smoothing = cfg.train.label_smoothing

    @torch.no_grad()
    def step(state: TrainState, abatch: AudioBatch) -> Dict[str, torch.Tensor]:
        batch = preprocess(abatch, state.device)
        logits = functional_call(
            state.model, cast_params(state.params, cast_dt),
            (batch.feats, batch.frame_lens, batch.targets_in, batch.target_lens))
        valid = torch.as_tensor(abatch.valid).to(state.device)
        tgt = torch.where(valid[:, None], batch.targets_out, PAD)
        loss, tokens = label_smoothed_cross_entropy(logits, tgt, smoothing=smoothing)
        return {"loss": loss, "tokens": tokens}

    return step


def _resolve_mesh(cfg: ExperimentConfig, mesh, device: DeviceLike) -> Optional[Mesh]:
    """The JAX ``Trainer``'s mesh argument: "auto" builds the mesh when the
    launch has several ranks or ``mesh.model_axis`` > 1 (in a single-rank
    launch that cannot fit the model axis, none, with a warning); a ``Mesh``
    is used as it is; None trains on one device, refused under a
    multi-rank launch."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh == "auto":
        if world > 1 or cfg.mesh.model_axis > 1:
            return make_mesh_auto(cfg.mesh, device=device)
        return None
    if isinstance(mesh, Mesh):
        return mesh
    if mesh is None:
        if world > 1:
            raise ValueError(f"mesh=None under a {world}-rank launch would train "
                             "diverging replicas: pass mesh='auto' or a Mesh")
        return None
    raise TypeError(f"mesh must be 'auto', None or a Mesh; got {mesh!r}")


class Trainer:
    def __init__(self, cfg: ExperimentConfig, *, work_dir: str,
                 train_manifest: Optional[str] = None,
                 dev_manifest: Optional[str] = None, resume: bool = False,
                 mesh: object = "auto", device: DeviceLike = None):
        """Trains on ``device`` (CUDA unless the caller asks for the CPU).
        ``resume`` continues from the latest checkpoint in
        ``work_dir/checkpoints``, which must carry this config's model hash.
        ``mesh``: "auto", a ``parallel.mesh.Mesh`` or None (``_resolve_mesh``);
        with a mesh the rank trains on ``mesh.device`` and
        ``train.batch_size`` is the global batch."""
        self.cfg = cfg
        self.work_dir = work_dir
        self.mesh = mesh = _resolve_mesh(cfg, mesh, device)
        self.device = resolve_device(device) if mesh is None else mesh.device
        # Data ranks shard each planned batch, as JAX's hosts do.
        shards = dict(shard_index=0, num_shards=1) if mesh is None else dict(
            shard_index=mesh.data_index, num_shards=mesh.dp)
        n = shards["num_shards"]
        t, data = cfg.train, cfg.data
        self.train_ds = ManifestDataset(train_manifest or data.train_manifest, data,
                                        cfg.features)
        self.dev_ds = None
        dev_path = dev_manifest or data.dev_manifest
        if dev_path:
            ds = ManifestDataset(dev_path, data, cfg.features)
            if len(ds) == 0:
                # An empty dev set would score loss 0 and claim work_dir/best.
                warnings.warn(f"dev manifest {dev_path} has 0 usable utterances; "
                              "disabling dev evaluation")
            else:
                self.dev_ds = ds
        target_len = min(data.max_target_len, cfg.model.max_target_positions)
        per_rank = max(t.batch_size // n, 1)
        if data.pipeline == "grain":
            batcher_cls = functools.partial(GrainBucketedPipeline,
                                            num_workers=data.num_workers)
        else:
            batcher_cls = BucketedBatcher
        self.batcher = batcher_cls(
            self.train_ds, batch_size=per_rank,
            bucket_boundaries=data.bucket_boundaries, target_len=target_len,
            seed=t.seed, drop_remainder=True,
            max_frames_per_batch=t.max_frames_per_batch // n,
            adaptive_target_len=data.adaptive_target_len, **shards)
        self.dev_batcher = None
        if self.dev_ds is not None:
            self.dev_batcher = BucketedBatcher(
                self.dev_ds, batch_size=per_rank,
                bucket_boundaries=data.bucket_boundaries, target_len=target_len,
                seed=0, drop_remainder=False, shuffle=False,
                adaptive_target_len=data.adaptive_target_len, **shards)
        if mesh is not None:
            # Each global batch (per-rank rows × shards) must divide the
            # data axis (JAX runner.py:156-169).
            q = mesh.dp // math.gcd(mesh.dp, n)
            for b in (self.batcher, self.dev_batcher):
                if b is not None:
                    b.bucket_batch_sizes = [-(-s // q) * q for s in b.bucket_batch_sizes]

        main = mesh is None or mesh.is_main
        # Every rank computes the records; rank 0 alone writes and prints them.
        self.logger = MetricsLogger(work_dir if main else None,
                                    console_every=1 if main else sys.maxsize)
        self.ckpt = Checkpointer(f"{work_dir}/checkpoints", max_to_keep=t.keep_checkpoints,
                                 mesh=mesh)
        self.state = create_train_state(cfg, device=self.device, seed=t.seed, mesh=mesh)
        if mesh is None:
            self.step_fn = make_audio_train_step(cfg)
            self.eval_fn = make_audio_eval_step(cfg)
        else:
            self.step_fn = make_sharded_audio_train_step(cfg, mesh)
            self.eval_fn = make_sharded_audio_eval_step(cfg, mesh)
        # The dropout seed; the bits also depend on the step (train.py).
        self.dropout_seed = t.seed + 1
        self.start_epoch = 0
        self.start_batch = 0
        self.best_dev_loss = float("inf")
        self.best_dev_step = -1
        self.best_ckpt = None
        if resume:
            # A mesh rank restores the whole tree on the CPU and takes its shards.
            step, restored = self.ckpt.restore(
                device=self.device if mesh is None else "cpu")
            if restored.config_hash and restored.config_hash != cfg.model_hash():
                raise ValueError(f"checkpoint config hash {restored.config_hash} != "
                                 f"current {cfg.model_hash()}")
            self.state = create_train_state(cfg, device=self.device, mesh=mesh,
                                            params=restored.params, opt=restored.opt)
            self.state.step = step
            self.start_epoch = restored.epoch
            self.start_batch = restored.batch_in_epoch
            # Resume-safe best-model tracking: after a restart only a dev loss
            # better than the one before it replaces work_dir/best.
            self.best_dev_loss = restored.best_dev_loss
            self.best_dev_step = restored.best_dev_step
            if main:
                print(f"resumed from step {step} (epoch {self.start_epoch}, batch "
                      f"{self.start_batch}, best_dev_loss {self.best_dev_loss:.4f})")

    def _ckpt_state(self, epoch: int, batch_in_epoch: int) -> CheckpointState:
        return CheckpointState.of(self.state, epoch, batch_in_epoch,
                                  self.cfg.model_hash(), mesh=self.mesh,
                                  best_dev_loss=self.best_dev_loss,
                                  best_dev_step=self.best_dev_step)

    def _batches(self, epoch: int, skip: int, stream):
        """The epoch's batches after ``skip``, each copied to the device in
        the prefetch thread. The copy is queued on ``stream``, the stream
        the steps run on, so stream order puts it before the step that
        reads it and no thread waits. ``pin_memory`` takes its block from
        PyTorch's caching host allocator, which records the copy's stream
        and hands the block out again only once the copy has completed, so
        dropping the pinned tensor right after the non-blocking copy is
        safe."""
        it = self.batcher.epoch(epoch, skip_batches=skip)
        if self.device.type != "cuda":
            return prefetch(it)

        def on_device():
            with contextlib.closing(it):     # a worker pool stops with its epoch
                for abatch in it:
                    with torch.cuda.stream(stream):
                        moved = AudioBatch(*(getattr(abatch, f.name).pin_memory().to(
                            self.device, non_blocking=True)
                            for f in dataclasses.fields(abatch)))
                    yield moved

        return prefetch(on_device())

    def train(self, *, max_steps: Optional[int] = None) -> TrainState:
        t = self.cfg.train
        stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        window_t0 = time.perf_counter()
        step = self.state.step
        pending = []     # (audio_seconds, tokens) device scalars since the last log
        for epoch in range(self.start_epoch, t.num_epochs):
            # Mid-epoch resume skips batches through the metadata-only plan.
            skip = self.start_batch if epoch == self.start_epoch else 0
            batches = self._batches(epoch, skip, stream)
            for bi, abatch in enumerate(batches, start=skip):
                self.state, metrics = self.step_fn(self.state, abatch, self.dropout_seed)
                step += 1
                pending.append((metrics["audio_seconds"], metrics["tokens"]))

                if step % t.log_every == 0:
                    n = len(pending)
                    scalars = ([a for a, _ in pending] + [tok for _, tok in pending]
                               + [metrics[k] for k in ("loss", "grad_norm", "accuracy", "lr")])
                    vals = torch.stack([x.double().reshape(()) for x in scalars]).tolist()
                    pending = []
                    dt = max(time.perf_counter() - window_t0, 1e-9)
                    loss, grad_norm, accuracy, lr = vals[2 * n:]
                    self.logger.log(step, {
                        "loss": loss, "grad_norm": grad_norm, "accuracy": accuracy,
                        "lr": lr, "audio_sps": sum(vals[:n]) / dt,
                        "tokens_per_s": sum(vals[n:2 * n]) / dt, "epoch": epoch})
                    window_t0 = time.perf_counter()

                if step % t.checkpoint_every_steps == 0:
                    self.ckpt.save(step, self._ckpt_state(epoch, bi + 1))

                if (self.dev_ds is not None and t.eval_every_steps > 0
                        and step % t.eval_every_steps == 0):
                    self._dev_eval(epoch, bi + 1)
                    window_t0 = time.perf_counter()
                    pending = []

                if max_steps is not None and step >= max_steps:
                    batches.close()
                    # The JAX runner records batch 0 here (runner.py:306), so
                    # a resume would replay the epoch; the port records the
                    # next batch.
                    self._finish(epoch, bi + 1)
                    return self.state

            if self.dev_ds is not None:
                self._dev_eval(epoch + 1, 0)
                window_t0 = time.perf_counter()
                pending = []
            self.ckpt.save(self.state.step, self._ckpt_state(epoch + 1, 0))
        self._finish(t.num_epochs, 0)
        return self.state

    def _dev_eval(self, epoch: int, batch_in_epoch: int) -> None:
        """Dev loss and greedy CER; a new best dev loss saves the model to
        ``work_dir/best``."""
        dev = self.evaluate(decode_cer=True)
        step = self.state.step
        self.logger.log(step, dev, prefix="dev_")
        if dev["loss"] < self.best_dev_loss:
            self.best_dev_loss = dev["loss"]
            self.best_dev_step = step
            if self.best_ckpt is None:
                self.best_ckpt = Checkpointer(f"{self.work_dir}/best", max_to_keep=1,
                                              mesh=self.mesh)
            self.best_ckpt.save(step, self._ckpt_state(epoch, batch_in_epoch))

    def evaluate(self, *, decode_cer: bool = False,
                 max_decode_batches: Optional[int] = None) -> Dict[str, float]:
        """Dev loss over every dev batch, and with ``decode_cer`` the greedy
        CER over the first ``max_decode_batches`` batches (default
        ``train.dev_decode_batches``; 0 = all). A CER over only some batches
        is reported as ``cer_sampled``."""
        if max_decode_batches is None:
            max_decode_batches = self.cfg.train.dev_decode_batches
        total_loss, total_tokens = 0.0, 0.0
        refs, hyps = [], []
        sampled = False
        model = self._decode_model() if decode_cer else None
        for bi, abatch in enumerate(self.dev_batcher.epoch(0)):
            m = self.eval_fn(self.state, abatch)
            tokens = float(m["tokens"])
            total_loss += float(m["loss"]) * tokens
            total_tokens += tokens
            if decode_cer:
                if max_decode_batches <= 0 or bi < max_decode_batches:
                    refs_b, hyps_b = self._greedy_batch(model, abatch)
                    refs.extend(refs_b)
                    hyps.extend(hyps_b)
                else:
                    sampled = True
        out = {"loss": total_loss / max(total_tokens, 1.0), "tokens": total_tokens}
        if decode_cer and refs:
            out["cer_sampled" if sampled else "cer"] = cer(refs, hyps)["cer"]
        return out

    def _decode_model(self):
        """An eval-mode copy of the model at the compute dtype, for greedy
        decoding (the train step casts the f32 masters the same way)."""
        dt = compute_cast_dtype(self.cfg) or torch.float32
        return copy.deepcopy(self.state.model).to(dt).eval()

    def _greedy_batch(self, model, abatch: AudioBatch):
        """Greedy-decode one dev batch; returns (refs, hyps) of its valid
        rows (with a mesh, every data rank's, gathered in data order)."""
        batch = make_preprocess_fn(self.cfg.features, None)(abatch, self.device)
        max_len = min(self.cfg.decode.max_decode_len,
                      self.cfg.model.max_target_positions - 1)
        hyps_all = tokens_to_lists(greedy_decode(model, batch.feats, batch.frame_lens,
                                                 max_len=max_len, device=self.device))
        tout, tlens = abatch.targets_out.numpy(), abatch.target_lens.numpy()
        refs, hyps = [], []
        for row in range(tout.shape[0]):
            if not bool(abatch.valid[row]):
                continue
            refs.append([int(t) for t in tout[row, :tlens[row]] if t != EOS and t != PAD])
            hyps.append([t for t in hyps_all[row] if t != EOS])
        if self.mesh is not None:
            pairs = [None] * self.mesh.dp
            dist.all_gather_object(pairs, (refs, hyps), group=self.mesh.data_group)
            refs = [r for rs, _ in pairs for r in rs]
            hyps = [h for _, hs in pairs for h in hs]
        return refs, hyps

    def _finish(self, epoch: int, batch: int) -> None:
        self.ckpt.save(self.state.step, self._ckpt_state(epoch, batch))
        self.logger.close()

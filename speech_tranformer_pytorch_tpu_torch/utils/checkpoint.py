"""Step checkpoints (counterpart of the JAX package's ``utils/checkpoint.py``).

One file a step, ``step_<n>.pt``, written with ``torch.save`` to a
temporary name and renamed into place, so a crash never leaves a partial
checkpoint. It holds everything a bit-exact resume needs: the model's
parameters (the f32 masters, or with ``train.master_weights`` their
compute-dtype cast beside the f32 master of the Adam state), the Adam
moments in their own dtype and the device step count, the host step, the
epoch and the batch in it, and the best dev loss and its step. The model hash goes beside it as ``config_hash.txt``, as the
JAX package writes it, so the two packages' runs compare by that file.

There is no RNG key: the port's dropout and SpecAugment bits come from
generators seeded by (seed, step) alone (``ops/dropout.step_generator``),
so the step restores them. Saving is synchronous; ``wait`` has nothing to wait for.

A mesh run (``Checkpointer(..., mesh=mesh)``) writes the same single-device
file: ``CheckpointState.of(..., mesh=mesh)`` gathers the tensor-parallel
shards (every model rank takes part), rank 0 alone writes, and every rank
waits for the write, so a later restore on any rank finds it. Each rank
restores the whole tree and takes its shards (``train.create_train_state``
with the mesh); ``load_recognizer`` serves it with or without a mesh.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike
from ..ops.fused_adam import AdamState
from ..train import TrainState

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


@dataclasses.dataclass
class CheckpointState:
    """``params`` is the model's ``state_dict`` and ``opt`` its Adam state
    (with its f32 master under master weights); ``best_dev_loss`` and ``best_dev_step`` keep best-model tracking
    across a restart."""
    params: Dict[str, torch.Tensor]
    opt: AdamState
    epoch: int
    batch_in_epoch: int
    config_hash: str
    best_dev_loss: float = float("inf")
    best_dev_step: int = -1
    num_devices: int = 1

    @classmethod
    def of(cls, state: TrainState, epoch: int, batch_in_epoch: int, config_hash: str,
           mesh=None, **kw) -> "CheckpointState":
        """The state's tree; with ``mesh`` the whole tree gathered from the
        model ranks' shards (a collective)."""
        params = {k: p.detach() for k, p in state.model.state_dict().items()}
        opt = state.opt
        if mesh is not None:
            from ..parallel.sharding import gather_adam_state, gather_params

            params, opt = gather_params(params, mesh), gather_adam_state(opt, mesh)
            kw.setdefault("num_devices", mesh.world)
        return cls(params, opt, epoch, batch_in_epoch, config_hash, **kw)


class Checkpointer:
    def __init__(self, directory: str, *, max_to_keep: int = 5, mesh=None):
        """``mesh``: a mesh run's checkpoints, written by rank 0 alone."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                                   os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, ckpt: CheckpointState) -> bool:
        """Write step ``step``; keep the newest ``max_to_keep`` files. A step
        at or below the latest saved one is not written (as the JAX
        package's checkpoint manager skips it): returns whether it was.
        With a mesh every rank calls it, and returns once rank 0's write
        is done."""
        if self.mesh is None:
            return self._write(step, ckpt)
        dist.barrier()                 # every rank sees the same latest step
        wrote = self.latest_step() is None or step > self.latest_step()
        if wrote and self.mesh.is_main:
            self._write(step, ckpt)
        dist.barrier()
        return wrote

    def _write(self, step: int, ckpt: CheckpointState) -> bool:
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        payload = {
            "params": ckpt.params,
            "mu": ckpt.opt.mu, "nu": ckpt.opt.nu, "count": ckpt.opt.count,
            "master": ckpt.opt.master,
            "meta": {"step": int(step), "epoch": int(ckpt.epoch),
                     "batch_in_epoch": int(ckpt.batch_in_epoch),
                     "best_dev_loss": float(ckpt.best_dev_loss),
                     "best_dev_step": int(ckpt.best_dev_step),
                     "num_devices": int(ckpt.num_devices)},
        }
        path = self._path(step)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        with open(os.path.join(self.directory, "config_hash.txt"), "w") as f:
            f.write(ckpt.config_hash + "\n")
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def restore(self, step: Optional[int] = None, *, device: DeviceLike = "cpu"
                ) -> Tuple[int, CheckpointState]:
        """Load step ``step`` (default: the latest) onto ``device``, every
        tensor in the dtype it was saved in. Returns (step, CheckpointState)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = torch.load(self._path(step), weights_only=True,
                       map_location=torch.device(device))
        hash_path = os.path.join(self.directory, "config_hash.txt")
        config_hash = ""
        if os.path.exists(hash_path):
            with open(hash_path) as f:
                config_hash = f.read().strip()
        m = d["meta"]
        return step, CheckpointState(
            params=d["params"], opt=AdamState(count=d["count"], mu=d["mu"], nu=d["nu"],
                                              master=d.get("master")),
            epoch=m["epoch"], batch_in_epoch=m["batch_in_epoch"],
            config_hash=config_hash, best_dev_loss=m["best_dev_loss"],
            best_dev_step=m["best_dev_step"], num_devices=m["num_devices"])

    def wait(self) -> None:
        """Saving is synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing is held open between calls."""


def write_checkpoint(work_dir: str, step: int, ckpt: CheckpointState, cfg) -> str:
    """Write ``ckpt`` as ``work_dir/checkpoints/step_<step>.pt`` with its
    ``config_hash.txt``, and ``cfg`` (an ``ExperimentConfig``) as the run's
    ``work_dir/config.json``, as ``train_cli`` writes it: a work dir that
    ``Trainer(resume=True)``, ``load_recognizer`` and the CLIs take, for
    example from ``convert.checkpoint_from_npz``. Returns the checkpoint's
    path."""
    ckpts = Checkpointer(os.path.join(work_dir, "checkpoints"))
    if not ckpts.save(step, ckpt):
        raise ValueError(f"{ckpts.directory} already holds step {ckpts.latest_step()} "
                         f">= {step}")
    with open(os.path.join(work_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    return ckpts._path(step)

"""The ('data', 'model') mesh of ranks (counterpart of the JAX package's
``parallel/mesh.py``).

One process per card. Rank ``r`` of a world of ``dp·tp`` ranks sits at
mesh position ``(r // tp, r % tp)``: utterance batches split over ``data``
(each data index holds its own rows and gradients are summed over it),
attention heads, FFN hidden columns and the embedding's d_model split over
``model`` (Megatron tensor parallelism, ``parallel/tp.py``). A ``Mesh``
holds the process groups of its rank's data column and model row; its
collectives run on ``nccl`` for ranks holding CUDA tensors and ``gloo`` on
the CPU. A one-rank mesh is a real mesh: its collectives are identities
that still go through the backend.

``init_distributed`` starts the process group from the environment that
``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) and places the rank on card
``LOCAL_RANK``. Without a launch, ``make_mesh`` starts a one-rank group in
process (``HashStore``), so a single-process mesh needs no address.
``spawn_ranks`` runs a function on fresh ranks of this machine (one per
card, or gloo ranks on the CPU), rendezvousing through a file.
"""

from __future__ import annotations

import os
import tempfile
import warnings
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import MeshConfig
from ..device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def launched_world() -> int:
    """The world size of a ``torchrun`` launch (1 without one)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_distributed(device: DeviceLike = None) -> torch.device:
    """Start the default process group of a ``torchrun`` launch (env://)
    once, on ``nccl`` for a CUDA device and ``gloo`` on the CPU, and return
    this rank's device: for CUDA without an index, card ``LOCAL_RANK`` (the
    current card outside a launch). Outside a launch the world is this one
    process."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", torch.cuda.current_device() if local is None
                           else int(local))
    if dev.type == "cuda":
        resolve_device(dev)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend_for(dev), init_method="env://")
        else:
            dist.init_process_group(backend_for(dev), store=dist.HashStore(),
                                    rank=0, world_size=1)
    return dev


class Mesh:
    """This rank's place in the ('data', 'model') mesh and the groups of its
    data column (``data_group``: the ranks holding the same model shard)
    and model row (``model_group``: the ranks holding the same rows).
    ``device`` is where the rank's tensors live."""

    def __init__(self, dp: int, tp: int, rank: int, device: torch.device,
                 data_group, model_group, model_ranks: List[int]):
        self.dp, self.tp, self.rank, self.device = dp, tp, rank, device
        self.data_group, self.model_group = data_group, model_group
        self.model_ranks = model_ranks           # global ranks of the model row

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}

    @property
    def world(self) -> int:
        return self.dp * self.tp

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    @property
    def is_main(self) -> bool:
        """Rank 0: the one rank that writes files."""
        return self.rank == 0

    def __deepcopy__(self, memo) -> "Mesh":
        # Process groups cannot be copied: a copied model shares its mesh.
        return self

    def __repr__(self) -> str:
        return (f"Mesh(data={self.dp}, model={self.tp}, rank={self.rank}, "
                f"device={self.device})")


def mesh_shape(world: int, model_axis: int) -> Tuple[int, int]:
    """(dp, tp) of a world: ``model_axis`` must divide it."""
    if model_axis < 1 or world % model_axis != 0:
        raise ValueError(f"model axis {model_axis} must divide the world size {world}")
    return world // model_axis, model_axis


def make_mesh(cfg: Optional[MeshConfig] = None, *, model_axis_size: Optional[int] = None,
              device: DeviceLike = None) -> Mesh:
    """The mesh over every rank of the process group (started by
    ``init_distributed`` when it is not yet). ``model_axis_size`` (or
    ``cfg.model_axis``) fixes the TP degree and must divide the world size;
    the other ranks form the data axis. Every rank must call this, in the
    same order as its other group creations."""
    dev = init_distributed(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    tp = model_axis_size if model_axis_size is not None else (
        cfg.model_axis if cfg is not None else 1)
    dp, tp = mesh_shape(world, tp)
    backend = backend_for(dev)
    data_group = model_group = model_ranks = None
    for d in range(dp):                    # every rank creates every group
        ranks = [d * tp + m for m in range(tp)]
        g = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            model_group, model_ranks = g, ranks
    for m in range(tp):
        g = dist.new_group([d * tp + m for d in range(dp)], backend=backend)
        if m == rank % tp:
            data_group = g
    return Mesh(dp, tp, rank, dev, data_group, model_group, model_ranks)


def make_mesh_auto(cfg: MeshConfig, *, device: DeviceLike = None) -> Optional[Mesh]:
    """The mesh where the launch fits ``cfg.model_axis``; in a single-rank
    launch that cannot fit it, ``None`` (the single-device path) with a
    warning, so a checkpoint of a TP preset still decodes on one card.
    Under a multi-rank launch this is as strict as ``make_mesh``: a
    collective-free path there would train or decode diverging replicas."""
    world = dist.get_world_size() if dist.is_initialized() else launched_world()
    tp = cfg.model_axis
    if world == 1 and (tp > world or world % tp != 0):
        warnings.warn(
            f"mesh auto mode: mesh.model_axis={tp} does not fit the {world} "
            "rank(s) of this launch; falling back to the single-device path "
            "(pass --mesh on / an explicit Mesh to make this an error)")
        return None
    return make_mesh(cfg, device=device)


def _rank_entry(rank: int, fn, world: int, tmp: str, device: str, args) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        resolve_device(dev)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        torch.save(fn(rank, *args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable[..., Any], world: int, *args, device: str = "cpu") -> List[Any]:
    """``fn(rank, *args)`` on ``world`` fresh processes (``spawn``), each a
    rank of one process group: gloo on the CPU, or nccl with rank r on
    card r for ``device="cuda"``. ``fn`` must be importable by name and
    its result picklable; returns the ranks' results in rank order."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_entry, args=(fn, world, tmp, device, args), nprocs=world,
                 join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]

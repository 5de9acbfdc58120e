"""Cross-rank top-k over a vocabulary-sharded score row (counterpart of
the JAX package's ``parallel/beam_exchange.py``).

With the candidate scores [B, F] split over the ``model`` ranks along F,
each rank takes the top-k of its shard (``topk_stable``, ``lax.top_k``'s
tie order), turns its indices global, all-gathers the k (value, index)
pairs of every rank, and takes the top-k of those. That is exact (the
global top-k lies in the union of the shards' top-k) and moves n·k pairs
instead of F scores. Ties keep ``lax.top_k``'s order: the gathered pairs
come in shard order, each shard's in index order, so a stable top-k over
them puts the lowest global index first.

The port's decode path gathers whole logits before the beam prune
(``models/decoder.py``), as JAX's GSPMD program does; this is the
hand-written statement of the exchange, held to JAX's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.topk import topk_stable
from .mesh import Mesh
from .tp import all_gather_stack


def distributed_topk(local: torch.Tensor, k: int, mesh: Mesh
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global (values, flat indices) [B, k] of the scores whose model rank
    m holds columns [m·F/n, (m+1)·F/n) as ``local`` [B, F/n]; the same on
    every model rank and equal to ``topk_stable`` of the whole row."""
    vals, idx = topk_stable(local, k)
    gidx = idx + mesh.model_index * local.shape[-1]

    def gather(x):
        return torch.cat(all_gather_stack(x, mesh.model_group, mesh.tp).unbind(0), dim=-1)

    all_vals, all_idx = gather(vals), gather(gidx)
    v, sel = topk_stable(all_vals, k)
    return v, torch.gather(all_idx, -1, sel)


def dp_split_utterances(n_utts: int, axis_size: int, axis_index: int) -> slice:
    """Contiguous utterance slice for a data-parallel decode worker."""
    per = -(-n_utts // axis_size)
    start = axis_index * per
    return slice(start, min(start + per, n_utts))

"""Mesh-parallel decoding (counterpart of the JAX package's
``parallel/decode.py``).

The batch is split over ``data`` and the model's parameters over
``model``: each rank runs the beam search or greedy search of
``decoding/`` on its own rows with its heads (the lineage attention B-3
and beam prune B-2 launches are the rank's own), and the results are
gathered back over ``data`` in row order. ``Recognizer(mesh=...)``
decodes through these builders. The logits reach the beam prune whole
(``models/decoder.py``), so the hypotheses equal the single-device
decode's token for token; the model ranks of one data index take the
same decisions and stop at the same step.

Where JAX's builders take the global batch and let GSPMD split it, these
take the rank's rows: ``sharding.data_rows`` of a global batch, or a
data rank's own stride of a distributed ``decode_manifest``.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from ..decoding import BeamResult, GreedyResult, beam_decode, greedy_decode
from ..models import SpeechTransformer
from .mesh import Mesh
from .sharding import gather_rows


def gather_result(result: Union[BeamResult, GreedyResult], mesh: Mesh):
    """A decode result of this data rank's rows -> the whole batch's, in
    data order; ``steps`` stays this rank's."""
    fields = {f.name: getattr(result, f.name) for f in dataclasses.fields(result)}
    return type(result)(**{k: gather_rows(v, mesh) if torch.is_tensor(v) else v
                           for k, v in fields.items()})


def make_sharded_beam_decode(model: SpeechTransformer, mesh: Mesh, *, beam_size: int,
                             max_len: int, alpha: float = 1.0):
    """``fn(feats [B_rank, T, F], frame_lens [B_rank]) -> BeamResult`` of
    the whole batch; ``model`` holds this rank's shards
    (``SpeechTransformer(cfg, mesh)``) on ``mesh.device``."""

    def fn(feats, frame_lens):
        return gather_result(beam_decode(model, feats, frame_lens, beam_size=beam_size,
                                         max_len=max_len, alpha=alpha,
                                         device=mesh.device), mesh)

    return fn


def make_sharded_greedy_decode(model: SpeechTransformer, mesh: Mesh, *, max_len: int):
    """``fn(feats [B_rank, T, F], frame_lens [B_rank]) -> GreedyResult`` of
    the whole batch."""

    def fn(feats, frame_lens):
        return gather_result(greedy_decode(model, feats, frame_lens, max_len=max_len,
                                           device=mesh.device), mesh)

    return fn

"""Fused beam-candidate scoring and top-k2 (one beam step's prune).

Replaces the TPU kernel ``_kernel`` / ``candidate_topk_rows`` and the merge
in ``candidate_topk`` (speech_tranformer_pytorch_tpu/kernels/beam_prune.py:36,
:68, :93). The kernels are in ``csrc/beam_prune.cu``; its header says what
bounds it on an H100 (bytes: one read of the logits) and how the one-launch
cluster kernel merges each utterance's rows. ``plan`` picks that kernel or
the two-launch one by shape. Results are exact against the plain version
here: indices equal, tie order included.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.masks import NEG_INF
from ..ops.topk import topk_stable
from . import _build

MAX_CLUSTER_BEAMS = 8   # the portable thread-block cluster size
MAX_CLUSTER_K2 = 16
CLUSTER_WARPS = 8
CLUSTER_SMEM_BYTES = 220 * 1024   # of 227 KB, less the kernel's static arrays


def cluster_smem_bytes(vocab: int, k2: int) -> int:
    """Dynamic shared memory of the cluster kernel: the row and its
    candidate cap (csrc/beam_prune.cu ``candidate_cap``)."""
    cap = CLUSTER_WARPS * k2 * (4 * -(-(vocab // 4) // (CLUSTER_WARPS * 32)) + 2)
    return 4 * (vocab + 4 + 2 * cap)


def plan(beams: int, k2: int, vocab: int) -> str:
    """"cluster" (one launch, one block cluster per utterance) for
    K <= 8 and k2 <= 16, every beam up to 8 since k2 = 2K, when the row
    and its candidates fit one block's shared memory; else "rows" (the row
    pass and the merge, two launches). Chosen by shape, never on failure."""
    if (beams <= MAX_CLUSTER_BEAMS and k2 <= MAX_CLUSTER_K2
            and cluster_smem_bytes(vocab, k2) <= CLUSTER_SMEM_BYTES):
        return "cluster"
    return "rows"


def candidate_topk_reference(
    logits: torch.Tensor,        # [B·K, V]
    alive_scores: torch.Tensor,  # [B, K]
    *,
    k2: int,
    pad_id: int = 0,
    sos_id: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (top scores [B, k2] f32, flat indices [B, k2] into
    K·V) of log_softmax(logits) with <pad>/<sos> at -1e9, plus the beam
    scores, lowest flat index first among ties."""
    b, k = alive_scores.shape
    v = logits.shape[-1]
    lp = torch.log_softmax(logits.float(), dim=-1)
    lp[:, pad_id] = NEG_INF
    lp[:, sos_id] = NEG_INF
    cand = alive_scores.float()[:, :, None] + lp.reshape(b, k, v)
    vals, idx = topk_stable(cand.reshape(b, k * v), k2)
    return vals, idx.to(torch.int32)


def candidate_topk_cuda(
    logits: torch.Tensor,
    alive_scores: torch.Tensor,
    *,
    k2: int,
    pad_id: int = 0,
    sos_id: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper: same contract as ``candidate_topk_reference`` for
    CUDA tensors."""
    if logits.device.type != "cuda":
        raise ValueError("candidate_topk_cuda needs CUDA tensors")
    b, k = alive_scores.shape
    bk, v = logits.shape
    if bk != b * k or logits.dtype != torch.float32:
        raise ValueError(f"logits {tuple(logits.shape)} {logits.dtype} do not "
                         f"match alive scores {tuple(alive_scores.shape)}")
    if not 0 < k2 <= v or not (0 <= pad_id < v and 0 <= sos_id < v):
        raise ValueError(f"k2={k2}, pad_id={pad_id}, sos_id={sos_id} need "
                         f"0 < k2 <= V={v} and ids inside the vocabulary")
    if v * 4 > 227 * 1024:
        raise ValueError(f"vocabulary {v} does not fit one block's shared memory")
    logits = logits.contiguous()
    alive = alive_scores.float().contiguous()
    dev = logits.device
    vals = torch.empty((b, k2), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k2), dtype=torch.int32, device=dev)
    lib = _build.library()
    stream = _build.stream_ptr(dev)
    if plan(k, k2, v) == "cluster":
        _build.check(lib.st_beam_prune(
            logits.data_ptr(), alive.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            b, k, v, k2, pad_id, sos_id, stream), "st_beam_prune")
    else:
        row_vals = torch.empty((bk, k2), dtype=torch.float32, device=dev)
        row_idx = torch.empty((bk, k2), dtype=torch.int32, device=dev)
        _build.check(lib.st_beam_prune_rows(
            logits.data_ptr(), alive.data_ptr(), row_vals.data_ptr(),
            row_idx.data_ptr(), vals.data_ptr(), idx.data_ptr(), b, k, v, k2,
            pad_id, sos_id, stream), "st_beam_prune_rows")
    candidate_topk_cuda.launches += 1
    return vals, idx


candidate_topk_cuda.launches = 0

"""Cross-attention of one decode step over the beam-invariant cross cache.

The JAX package has no kernel for it (its scores are an XLA einsum on bf16
operands with float32 results, speech_tranformer_pytorch_tpu/models/
modules.py:503), so no TPU kernel is replaced: on the card
``csrc/cross_attention.cu`` is everything ``MultiHeadAttention.attend_bhsd``
does between ``project_q`` and ``project_out``, one launch a decoder layer
and step. The K beams of an utterance are its query rows, so its cross
K/V are read once for all of them; frames at or after the utterance's
valid length are skipped. What bounds it on an H100 is the bytes of those
rows; the kernel's header says how it spreads them over the card.

The plain version is the einsum route the step ran before the kernel,
unchanged: scores as the float32 sum of exact float32 products over √D,
the length mask as an additive -1e9, the softmax in float32, the weights
rounded to the value dtype before P·V.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..ops import masks
from . import _build

MAX_BEAMS = 8     # query rows an utterance: the kernel's instantiations
MAX_SPLITS = 8    # blocks a (utterance, head): the portable cluster size
_MIN_FRAMES = 64  # padded frames a split takes at least


def cross_attention_decode_reference(
    q: torch.Tensor,         # [B·K, 1, H, D] the step's queries
    k: torch.Tensor,         # [B, H, S, D] cross keys
    v: torch.Tensor,         # [B, H, S, D] cross values
    mem_lens: torch.Tensor,  # [B] valid encoder frames
) -> torch.Tensor:
    """Plain version: [B·K, 1, H, D] in v's dtype."""
    bk, _, h, d = q.shape
    b, _, s, _ = k.shape
    qb = q.reshape(b, bk // b, h, d).transpose(1, 2)           # [B,H,K,D]
    scores = torch.einsum("bhtd,bhsd->bhts", qb.float(), k.float())
    scores = scores / math.sqrt(d)
    bias = masks.mask_to_bias(masks.padding_attention_mask(1, mem_lens, s))
    scores = scores + bias.float()
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bhsd->bhtd", weights, v)
    return out.transpose(1, 2).reshape(bk, 1, h, d)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits_for(bh: int, s: int, sms: int) -> int:
    """Blocks a (utterance, head) cluster, at most ``MAX_SPLITS``: two
    while the B·H clusters fit the card's SMs, else one, and no split of
    fewer than ``_MIN_FRAMES`` padded frames. A sweep of 1 to 6 on an H100
    found 2 the fastest or within 2 % of it at every serving shape (B·H 64
    and 128, S 149 to 749, K 1 and 5; ``PERF.md``): each block keeps its
    fixed costs (launch, cluster barriers, merge) while its share of the
    bytes shrinks, and from three blocks a cluster the longest shapes no
    longer fit one wave of the card's shared memory."""
    return max(1, min(2 if bh <= sms else 1, -(-s // _MIN_FRAMES)))


def cross_attention_decode_cuda(q, k, v, mem_lens) -> torch.Tensor:
    """Kernel wrapper: same contract as ``cross_attention_decode_reference``
    for CUDA tensors in float32 or bfloat16, ``mem_lens`` int32 on the same
    card. K and V may have any (b, h, s) strides that hold whole 16-byte
    rows, with D contiguous. The blocks a cluster are ``splits_for``'s."""
    dt = q.dtype
    if dt not in (torch.float32, torch.bfloat16) or k.dtype != dt or v.dtype != dt:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q [B·K,1,H,D] and k, v [B,H,S,D] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = k.shape
    bk = q.shape[0]
    beams = bk // b if b else 0
    if (q.shape[1:] != (1, h, d) or beams * b != bk or not 1 <= beams <= MAX_BEAMS
            or s < 1):
        raise ValueError(f"q {tuple(q.shape)} is not [B·K, 1, H, D] with K in "
                         f"1..{MAX_BEAMS} rows an utterance of k {tuple(k.shape)}")
    if (mem_lens.dtype != torch.int32 or tuple(mem_lens.shape) != (b,)
            or not mem_lens.is_contiguous()):
        raise ValueError(f"mem_lens must be a contiguous int32 [B={b}], got "
                         f"{mem_lens.dtype} {tuple(mem_lens.shape)}")
    vec = 16 // q.element_size()
    if d % vec or d > 32 * vec:
        raise ValueError(f"head_dim {d} must be a multiple of {vec} and at most "
                         f"{32 * vec} for {dt}")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("q must be contiguous and 16-byte aligned")
    for name, t in (("k", k), ("v", v)):
        if (t.stride(3) != 1 or any(st % vec for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must hold whole 16-byte rows with D contiguous, "
                             f"got strides {t.stride()}")
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v, mem_lens)):
        raise ValueError(f"cross_attention_decode_cuda needs q, k, v and mem_lens on one "
                         f"CUDA device, got {q.device}, {k.device}, {v.device}, "
                         f"{mem_lens.device}")
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    splits = splits_for(b * h, s, _sm_count(index))
    strides = (ctypes.c_longlong * 6)(*k.stride()[:3], *v.stride()[:3])
    out = torch.empty_like(q)
    _build.check(_build.library().st_cross_attention_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mem_lens.data_ptr(), out.data_ptr(),
        b, beams, h, s, d, strides, splits, int(dt == torch.bfloat16),
        _build.stream_ptr(q.device)), "st_cross_attention_decode")
    cross_attention_decode_cuda.launches += 1
    return out


cross_attention_decode_cuda.launches = 0

"""Attention masks (counterpart of the JAX package's ``ops/masks.py``).

Masks are boolean, True = attendable. The attention bias is additive f32:
0 where attendable, ``NEG_INF`` where masked.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] int lengths -> [B, max_len] bool, True for valid positions."""
    positions = torch.arange(max_len, device=lengths.device)[None, :]
    return positions < lengths[:, None]


def causal_mask(length: int, device=None) -> torch.Tensor:
    """[length, length] bool lower-triangular (True = attendable)."""
    idx = torch.arange(length, device=device)
    return idx[None, :] <= idx[:, None]


def padding_attention_mask(q_len: int, kv_lengths: torch.Tensor,
                           kv_len: int) -> torch.Tensor:
    """Key-padding mask broadcast over queries: [B, 1, q_len, kv_len] bool."""
    kv_valid = length_mask(kv_lengths, kv_len)
    return kv_valid[:, None, None, :].expand(-1, 1, q_len, kv_len)


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """bool mask -> additive attention bias (0 keep / NEG_INF drop)."""
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    neg = torch.full((), NEG_INF, dtype=dtype, device=mask.device)
    return torch.where(mask, zero, neg)

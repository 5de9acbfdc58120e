"""Top-k with a fixed tie order."""

from __future__ import annotations

from typing import Tuple

import torch


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis, lowest index first among
    equal values — the order of ``jax.lax.top_k``. ``torch.topk`` does not
    promise any tie order; a stable descending sort does."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]

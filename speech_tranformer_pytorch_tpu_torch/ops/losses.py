"""Label-smoothed cross-entropy and token accuracy (counterpart of the JAX
package's ``ops/losses.py``).

For smoothing ε over V classes with true class y::

  loss = (1-ε)·(−log p_y) + ε/(V−1)·Σ_{k≠y} (−log p_k)

from two reductions (the gathered true-class log-prob and the sum of all
log-probs), so the smoothed distribution is never built. Pad targets get
weight 0; the token count is floored at 1.
"""

from __future__ import annotations

from typing import Tuple

import torch


def label_smoothed_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                                 smoothing: float = 0.1, pad_id: int = 0
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean per-token loss, valid-token count), both f32 scalars."""
    vocab = logits.shape[-1]
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    true_lp = torch.gather(log_probs, -1, targets.long()[..., None])[..., 0]
    if smoothing > 0.0:
        sum_lp = log_probs.sum(dim=-1)
        off_weight = smoothing / (vocab - 1)
        on_weight = 1.0 - smoothing
        per_tok = -(on_weight * true_lp + off_weight * (sum_lp - true_lp))
    else:
        per_tok = -true_lp
    weights = (targets != pad_id).float()
    token_count = torch.clamp(weights.sum(), min=1.0)
    return (per_tok * weights).sum() / token_count, token_count


def token_accuracy(logits: torch.Tensor, targets: torch.Tensor, *,
                   pad_id: int = 0) -> torch.Tensor:
    """Fraction of non-pad target tokens predicted correctly (argmax)."""
    weights = (targets != pad_id).float()
    correct = (logits.argmax(dim=-1) == targets.long()).float() * weights
    return correct.sum() / torch.clamp(weights.sum(), min=1.0)

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
from torch.nn import functional as F


def label_smoothed_ce_sums(logits: torch.Tensor, targets: torch.Tensor, *,
                           smoothing: float = 0.1, pad_id: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the per-token losses over non-pad targets, their count), both
    f32 scalars: the two sums a data-parallel step reduces over ranks."""
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
    return (per_tok * weights).sum(), weights.sum()


def label_smoothed_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                                 smoothing: float = 0.1, pad_id: int = 0
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean per-token loss, valid-token count), both f32 scalars."""
    loss_sum, weights = label_smoothed_ce_sums(logits, targets, smoothing=smoothing,
                                               pad_id=pad_id)
    token_count = torch.clamp(weights, min=1.0)
    return loss_sum / token_count, token_count


def ctc_loss_sum(log_probs: torch.Tensor, input_lens: torch.Tensor, targets: torch.Tensor,
                 target_lens: torch.Tensor, *, blank: int = 0) -> torch.Tensor:
    """Sum over the batch of -log p(y | x) under CTC (the port's own loss:
    the JAX package has no CTC head). ``log_probs`` [B, T, V] f32, the
    first ``target_lens`` of each row of ``targets`` [B, U] the labels; a
    label sequence no alignment fits adds 0 (``zero_infinity``)."""
    return F.ctc_loss(log_probs.transpose(0, 1), targets.long(), input_lens.long(),
                      target_lens.long(), blank=blank, reduction="sum", zero_infinity=True)


def token_accuracy_sums(logits: torch.Tensor, targets: torch.Tensor, *,
                        pad_id: int = 0) -> torch.Tensor:
    """Count of non-pad target tokens predicted correctly (argmax), f32."""
    weights = (targets != pad_id).float()
    return ((logits.argmax(dim=-1) == targets.long()).float() * weights).sum()


def token_accuracy(logits: torch.Tensor, targets: torch.Tensor, *,
                   pad_id: int = 0) -> torch.Tensor:
    """Fraction of non-pad target tokens predicted correctly (argmax)."""
    weights = (targets != pad_id).float()
    return token_accuracy_sums(logits, targets, pad_id=pad_id) / torch.clamp(
        weights.sum(), min=1.0)

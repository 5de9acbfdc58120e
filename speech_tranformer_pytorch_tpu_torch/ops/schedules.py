"""Noam learning-rate schedule (counterpart of the JAX package's
``ops/schedules.py``)::

  lr(step) = scale · d_model^-0.5 · min(step^-0.5, step · warmup^-1.5),

with step floored at 1. The moment semantics of the JAX
``scale_by_adam_typed`` (compute in f32, round mu and nu to
``moment_dtype`` on store) live in ``ops/fused_adam.py`` and its kernel.
"""

from __future__ import annotations

from typing import Callable

import torch


def noam_schedule(d_model: int, warmup_steps: int, scale: float = 1.0
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``schedule(step)`` -> f32 learning rate on step's device (a Python
    int gives a CPU scalar tensor)."""
    coef = scale * d_model ** -0.5
    ramp = warmup_steps ** -1.5

    def schedule(step) -> torch.Tensor:
        step = torch.clamp(torch.as_tensor(step).float(), min=1.0)
        return coef * torch.minimum(step ** -0.5, step * ramp)

    return schedule

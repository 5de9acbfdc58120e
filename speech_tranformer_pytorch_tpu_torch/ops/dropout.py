"""u8-bit dropout (counterpart of the JAX package's ``ops/dropout.py``).

An element is kept iff its random byte is >= q = round(256·rate), and kept
elements are scaled by 256/(256 − q), so the keep probability is exactly
(256 − q)/256 and the estimator stays unbiased (rate 0.1 keeps 230/256).
The bytes come from an explicit ``torch.Generator``; ``step_generator``
derives one from (seed, step), the counterpart of ``train.dropout_key``.
The bits cannot match JAX's: tests hold the invariants instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def dropout_quantized(x: torch.Tensor, rate: float,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Functional u8-bits dropout (training mode)."""
    q = int(round(rate * 256.0))
    if q <= 0:
        return x
    if q >= 256:
        return torch.zeros_like(x)
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device,
                         generator=generator)
    scale = torch.tensor(256.0 / (256.0 - q), dtype=x.dtype)
    return torch.where(bits >= q, x * scale, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


def dropout(x: torch.Tensor, rate: float, *, deterministic: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The ``Dropout`` module's call: identity when deterministic or at rate 0."""
    if deterministic or rate == 0.0:
        return x
    return dropout_quantized(x, rate, generator)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step) alone."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0]))
    return g

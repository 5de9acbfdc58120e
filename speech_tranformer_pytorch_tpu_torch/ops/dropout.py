"""u8-bit dropout (counterpart of the JAX package's ``ops/dropout.py``).

An element is kept iff its random byte is >= q = round(256·rate), and kept
elements are scaled by 256/(256 − q), so the keep probability is exactly
(256 − q)/256 and the estimator stays unbiased (rate 0.1 keeps 230/256).
The bytes come from an explicit ``torch.Generator``; ``step_generator``
derives one from (seed, step), the counterpart of ``train.dropout_key``,
and other streams of the same step (SpecAugment's) from (seed, step,
stream). The bits cannot match JAX's: tests hold the invariants instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def dropout_quantized(x: torch.Tensor, rate: float,
                      generator: Optional[torch.Generator] = None,
                      shard: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Functional u8-bits dropout (training mode). ``shard`` = (n, m, dim):
    ``x`` is block m of n equal blocks along ``dim`` of a tensor-parallel
    tensor; the whole tensor's bits are drawn and the block's kept, so the
    rank drops what one device would."""
    q = int(round(rate * 256.0))
    if q <= 0:
        return x
    if q >= 256:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if shard is not None:
        shape[shard[2]] *= shard[0]
    bits = torch.randint(0, 256, shape, dtype=torch.uint8, device=x.device,
                         generator=generator)
    if shard is not None:
        bits = bits.chunk(shard[0], dim=shard[2])[shard[1]]
    scale = torch.tensor(256.0 / (256.0 - q), dtype=x.dtype)
    return torch.where(bits >= q, x * scale, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


def dropout(x: torch.Tensor, rate: float, *, deterministic: bool,
            generator: Optional[torch.Generator] = None,
            shard: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """The ``Dropout`` module's call: identity when deterministic or at rate 0."""
    if deterministic or rate == 0.0:
        return x
    return dropout_quantized(x, rate, generator, shard)


DROPOUT_STREAM, AUGMENT_STREAM = 0, 1


def step_generator(seed: int, step: int, device,
                   stream: int = DROPOUT_STREAM, shard: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step) alone. Stream 0
    (dropout) keeps the seeding of the first train steps the port shipped;
    another stream is a child of the same (seed, step) entropy with its own
    spawn key, so its draws leave stream 0's bits as they were. ``shard``
    (a data rank's index) gives each data rank bits of its own; shard 0
    draws the single-device bits."""
    key = (int(stream), int(shard)) if shard else ((int(stream),) if stream else ())
    ss = np.random.SeedSequence([int(seed), int(step)], spawn_key=key)
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1)[0]))
    return g

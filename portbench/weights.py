"""Seeded weights, made on the device in a few large calls.

Every ``fan_in`` leaf is normal with std 1/sqrt(fan in) (LeCun), the
embedding normal with std 1/sqrt(d_model), biases zero and LayerNorm
scales one, as ``reference.model.param_spec`` lists them. All normal
leaves come from one draw of a ``torch.Generator`` on the device, seeded
with ``--seed``; the same dictionary is handed to the port and to the
reference.

For serving (``never_end``) the ``<eos>`` row of the tied embedding is
zero, so its logit is 0 while
the best of the other 4,000-odd ids lie a few standard deviations above:
a search never ends a hypothesis, and every seed decodes the steps its
mix sets (``decode.max_len_ratio``, which stands in for the length of a
transcript). Without it a seed whose weights favour ``<eos>`` stops its
beams early and runs less work than another.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.model import param_spec

EOS = 2     # the configuration's <eos> id


def make_params(model_cfg: dict, seed: int, device, never_end: bool = False
                ) -> Dict[str, torch.Tensor]:
    spec = param_spec(model_cfg)
    normal = [(n, s, init) for n, s, init in spec if init in ("fan_in", "embed")]
    total = sum(math.prod(s) for _, s, _ in normal)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, init in normal:
        n = math.prod(shape)
        fan = shape[1] if init == "embed" else math.prod(shape[1:])
        out[name] = flat[at:at + n].view(shape).mul_(1.0 / math.sqrt(fan))
        at += n
    for name, shape, init in spec:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
    if never_end:
        out["decoder.embed.weight"][EOS].zero_()
    return {name: out[name] for name, _, _ in spec}

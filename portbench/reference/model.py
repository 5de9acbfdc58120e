"""The Speech-Transformer forward pass of the reference, functional over a
``{name: tensor}`` dictionary keyed as the port's ``state_dict``.

Encoder: two 3x3 / stride-2 VALID convolutions with ReLU over (time,
frequency), a linear projection of the flattened (frequency, channel) axes,
sinusoidal positions, then pre-LN layers {self-attention, ReLU
feed-forward} with dropout on each sublayer's output and on the hidden
layer of the feed-forward, a final LayerNorm and zeroed padding frames.
Decoder: embedding x sqrt(d_model) + positions, pre-LN layers {causal
self-attention, cross-attention, feed-forward}, a final LayerNorm, logits
by the tied embedding. Attention keeps key j of row b iff j < length[b]
(and j <= t when causal); LayerNorm epsilon is 1e-6.

Dropout is the u8-bit rule the configuration states: element kept iff its
byte is >= round(256 rate), kept elements scaled by 256 / (256 - q). The
bytes are drawn site by site in forward order from a generator seeded by
``step_generator`` (the seeding rule the port documents for its train
step), so the reference's masks are the ones the same seed gives.

``Precision`` rounds the operands of every product: float32 (the
reference) or ``fp8`` (the control: the precision below the configuration's bfloat16;
see the class).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

Params = Dict[str, torch.Tensor]

NEG = float("-inf")


# ----------------------------------------------------------------------------
# Parameters: names, shapes, initialisation.
# ----------------------------------------------------------------------------

def subsampled(n):
    """Length after the two 3x3 / stride-2 VALID convolutions."""
    for _ in range(2):
        n = (n - 3) // 2 + 1
    return n


def param_spec(m: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter. init is ``fan_in`` (normal,
    std 1/sqrt(fan in)), ``embed`` (normal, std 1/sqrt(d_model)), ``zeros``
    or ``ones``."""
    d, ff, c, v = m["d_model"], m["d_ff"], m["subsample_channels"], m["vocab_size"]
    if not (m["share_embedding"] and m["fused_qkv"] and m["normalize_before"]):
        raise ValueError("the reference implements the tied, fused-qkv, pre-LN model")
    spec = []

    def lin(name, out_f, in_f):
        spec.extend([(f"{name}.weight", (out_f, in_f), "fan_in"), (f"{name}.bias", (out_f,), "zeros")])

    def ln(name):
        spec.extend([(f"{name}.weight", (d,), "ones"), (f"{name}.bias", (d,), "zeros")])

    spec += [("encoder.subsample.conv0.weight", (c, 1, 3, 3), "fan_in"),
             ("encoder.subsample.conv0.bias", (c,), "zeros"),
             ("encoder.subsample.conv1.weight", (c, c, 3, 3), "fan_in"),
             ("encoder.subsample.conv1.bias", (c,), "zeros")]
    lin("encoder.subsample.out", d, subsampled(m["input_dim"]) * c)
    for i in range(m["num_encoder_layers"]):
        p = f"encoder.layers.{i}"
        lin(f"{p}.self_attn.qkv", 3 * d, d)
        lin(f"{p}.self_attn.out", d, d)
        lin(f"{p}.ffn.fc1", ff, d)
        lin(f"{p}.ffn.fc2", d, ff)
        ln(f"{p}.ln1")
        ln(f"{p}.ln2")
    ln("encoder.final_norm")
    spec.append(("decoder.embed.weight", (v, d), "embed"))
    for i in range(m["num_decoder_layers"]):
        p = f"decoder.layers.{i}"
        lin(f"{p}.self_attn.qkv", 3 * d, d)
        lin(f"{p}.self_attn.out", d, d)
        for proj in ("q", "k", "v", "out"):
            lin(f"{p}.cross_attn.{proj}", d, d)
        lin(f"{p}.ffn.fc1", ff, d)
        lin(f"{p}.ffn.fc2", d, ff)
        for j in (1, 2, 3):
            ln(f"{p}.ln{j}")
    ln("decoder.final_norm")
    return spec


def positions(n: int, d: int, device) -> torch.Tensor:
    """[n, d] sinusoidal table (Vaswani et al., 2017), computed in float64."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    pe = np.zeros((n, d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.tensor(pe, dtype=torch.float32, device=device)


# ----------------------------------------------------------------------------
# Precision of products, TF32 off.
# ----------------------------------------------------------------------------

def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """Per-tensor scaled rounding to an fp8 format and back to float32."""
    top = torch.finfo(dtype).max
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _GradFp8(torch.autograd.Function):
    """Identity forward; the backward rounds the incoming gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Precision:
    """Rounding applied around every product. ``float32`` is the identity.
    ``fp8`` is the hybrid recipe of fp8 training: both operands rounded to
    e4m3 with a per-tensor scale (amax to the format's largest value), and
    the gradient that reaches the product's output rounded to e5m2, so
    every product of the forward and the backward reads fp8 operands."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product."""
        if self.name == "float32":
            return x
        q = _fp8(x.detach(), torch.float8_e4m3fn)
        return x + (q - x).detach()

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's result (its gradient is the next products' operand)."""
        if self.name == "float32" or not y.requires_grad:
            return y
        return _GradFp8.apply(y)


F32 = Precision("float32")


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """TF32 off for matmuls and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ----------------------------------------------------------------------------
# Dropout bits.
# ----------------------------------------------------------------------------

def step_generator(seed: int, step: int, device, stream: int = 0) -> torch.Generator:
    """A generator seeded from (seed, step) by numpy's SeedSequence; stream
    0 (dropout) has no spawn key, stream s > 0 the spawn key (s,)."""
    ss = np.random.SeedSequence([int(seed), int(step)],
                                spawn_key=(int(stream),) if stream else ())
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1)[0]))
    return g


def dropout_shapes(m: dict, b: int, t_sub: int, u: int) -> List[Tuple[int, ...]]:
    """The shapes of the dropout sites of one teacher-forced forward, in
    the order they are drawn."""
    d, ff = m["d_model"], m["d_ff"]
    shapes = [(b, t_sub, d)]
    shapes += [(b, t_sub, d), (b, t_sub, ff), (b, t_sub, d)] * m["num_encoder_layers"]
    shapes += [(b, u, d)]
    shapes += [(b, u, d), (b, u, d), (b, u, ff), (b, u, d)] * m["num_decoder_layers"]
    return shapes


def draw_dropout_bits(generator: torch.Generator, shapes) -> List[torch.Tensor]:
    return [torch.randint(0, 256, s, dtype=torch.uint8, device=generator.device,
                          generator=generator) for s in shapes]


class Dropout:
    """Applies pre-drawn bytes site by site (rows ``rows`` of each site)."""

    def __init__(self, rate: float, bits: Optional[List[torch.Tensor]], rows=slice(None)):
        self.q = int(round(rate * 256.0))
        self.bits = bits
        self.rows = rows
        self.site = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.bits is None or self.q <= 0:
            return x
        b = self.bits[self.site][self.rows]
        self.site += 1
        return torch.where(b >= self.q, x * (256.0 / (256.0 - self.q)), torch.zeros_like(x))


NO_DROPOUT = Dropout(0.0, None)


# ----------------------------------------------------------------------------
# Forward.
# ----------------------------------------------------------------------------

def _linear(p: Params, name: str, x: torch.Tensor, pr: Precision) -> torch.Tensor:
    return pr.out(pr(x) @ pr(p[f"{name}.weight"]).t()) + p[f"{name}.bias"]


def _ln(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps=1e-6)


def attention(q, k, v, kv_lens, causal: bool, pr: Precision) -> torch.Tensor:
    """[B, T, H, D] x [B, S, H, D] -> [B, T, H, D]."""
    s = pr.out(torch.einsum("bthd,bshd->bhts", pr(q), pr(k))) / math.sqrt(q.shape[-1])
    t_len, s_len = q.shape[1], k.shape[1]
    keep = torch.arange(s_len, device=q.device)[None, :] < kv_lens[:, None].long()   # [B, S]
    keep = keep[:, None, None, :]
    if causal:
        keep = keep & (torch.arange(s_len, device=q.device)[None, :]
                       <= torch.arange(t_len, device=q.device)[:, None])
    w = torch.softmax(s.masked_fill(~keep, NEG), dim=-1)
    return pr.out(torch.einsum("bhts,bshd->bthd", pr(w), pr(v)))


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    return x.unflatten(-1, (h, x.shape[-1] // h))


def encode(p: Params, m: dict, feats: torch.Tensor, frame_lens: torch.Tensor, *,
           drop: Dropout = NO_DROPOUT, pr: Precision = F32
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(memory [B, T', d] with zeroed padding, valid lengths [B])."""
    h = m["num_heads"]
    x = feats[:, None]
    for conv in ("conv0", "conv1"):
        w = p[f"encoder.subsample.{conv}.weight"]
        x = F.relu(pr.out(F.conv2d(pr(x), pr(w), stride=2))
                   + p[f"encoder.subsample.{conv}.bias"][:, None, None])
    b, c, t, f = x.shape
    x = _linear(p, "encoder.subsample.out", x.permute(0, 2, 3, 1).reshape(b, t, f * c), pr)
    x = drop(x + positions(t, m["d_model"], x.device))
    lens = subsampled(frame_lens.long())
    for i in range(m["num_encoder_layers"]):
        n = f"encoder.layers.{i}"
        y = _ln(p, f"{n}.ln1", x)
        qkv = _linear(p, f"{n}.self_attn.qkv", y, pr).unflatten(-1, (3, h, -1))
        a = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], lens, False, pr)
        x = x + drop(_linear(p, f"{n}.self_attn.out", a.flatten(-2), pr))
        y = drop(F.relu(_linear(p, f"{n}.ffn.fc1", _ln(p, f"{n}.ln2", x), pr)))
        x = x + drop(_linear(p, f"{n}.ffn.fc2", y, pr))
    x = _ln(p, "encoder.final_norm", x)
    valid = torch.arange(t, device=x.device)[None, :] < lens[:, None]
    return x * valid[..., None].float(), lens


def decode(p: Params, m: dict, tokens_in: torch.Tensor, tgt_lens: torch.Tensor,
           memory: torch.Tensor, mem_lens: torch.Tensor, *, drop: Dropout = NO_DROPOUT,
           pr: Precision = F32) -> torch.Tensor:
    """Teacher-forced logits [B, U, V] (float32)."""
    h, d = m["num_heads"], m["d_model"]
    emb = p["decoder.embed.weight"]
    x = emb[tokens_in.long()] * math.sqrt(d)
    x = drop(x + positions(x.shape[1], d, x.device))
    for i in range(m["num_decoder_layers"]):
        n = f"decoder.layers.{i}"
        y = _ln(p, f"{n}.ln1", x)
        qkv = _linear(p, f"{n}.self_attn.qkv", y, pr).unflatten(-1, (3, h, -1))
        a = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], tgt_lens, True, pr)
        x = x + drop(_linear(p, f"{n}.self_attn.out", a.flatten(-2), pr))
        y = _ln(p, f"{n}.ln2", x)
        q = _heads(_linear(p, f"{n}.cross_attn.q", y, pr), h)
        k = _heads(_linear(p, f"{n}.cross_attn.k", memory, pr), h)
        v = _heads(_linear(p, f"{n}.cross_attn.v", memory, pr), h)
        a = attention(q, k, v, mem_lens, False, pr)
        x = x + drop(_linear(p, f"{n}.cross_attn.out", a.flatten(-2), pr))
        y = drop(F.relu(_linear(p, f"{n}.ffn.fc1", _ln(p, f"{n}.ln3", x), pr)))
        x = x + drop(_linear(p, f"{n}.ffn.fc2", y, pr))
    x = _ln(p, "decoder.final_norm", x)
    return pr.out(pr(x) @ pr(emb).t())

"""Ring attention over the frame axis (counterpart of the JAX package's
``parallel/ring_attention.py``).

The frame axis is split over the mesh's ``model`` axis: model rank m
holds query, key and value frames [m·T/n, (m+1)·T/n). K/V blocks and their
valid lengths travel round the ring, one hop a step, with
``batch_isend_irecv``; after n steps every query block has met every key
block, and the blocks' partial results are merged by their log-sum-exp.
The send is an autograd function whose backward sends the gradient the
other way round the ring, as the transpose of ``lax.ppermute`` does in
JAX; without it the gradients would be silently wrong. The result equals
full attention with key-padding masks (flash semantics: query rows are
not masked).

Two per-block bodies, as in JAX:
  * ``"flash"``: ``interface.flash_attention_stats`` (B-4 forward, B-5/B-6
    backward with the lse cotangent) on each resident block, merged with
    ``logaddexp`` from an lse of −0.7·FLT_MAX, never −inf, so a block with
    no kept key (o = 0, lse near ``MASK_VALUE``) merges without NaN forward
    or backward. The model's ring route uses this body.
  * ``"dot"``: the online-softmax einsum body of JAX's
    ``_ring_attention_local``, in plain torch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels import interface
from .mesh import Mesh
from .tp import all_to_all

LSE_INIT = -0.7 * float(torch.finfo(torch.float32).max)


def _shift(tensors, mesh: Mesh, step: int):
    """Send each tensor ``step`` hops round the model ring (+1 = to the next
    rank) and return what arrives from the other side."""
    n, m = mesh.tp, mesh.model_index
    dst, src = mesh.model_ranks[(m + step) % n], mesh.model_ranks[(m - step) % n]
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, dst, group=mesh.model_group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, src, group=mesh.model_group) for o in outs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _RingShift(torch.autograd.Function):
    """K/V and their lengths one hop forward; the gradients of K/V one hop
    back."""

    @staticmethod
    def forward(ctx, mesh, lens, k, v):
        ctx.mesh = mesh
        lens, k, v = _shift((lens, k, v), mesh, +1)
        ctx.mark_non_differentiable(lens)
        return lens, k, v

    @staticmethod
    def backward(ctx, _, dk, dv):
        return (None, None) + tuple(_shift((dk, dv), ctx.mesh, -1))


def flash_step(q, k, v, lens, carry, stats=interface.flash_attention_stats):
    """Merge one key block's (o, lse) into the running f32 (o, lse)
    [B, H, T, ·]; q, k, v [B, T, H, D]. ``stats`` computes a block's
    (o, lse) from [B, H, T, D] inputs."""
    o, lse = carry
    o_b, lse_b = stats(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lens)
    lse_new = torch.logaddexp(lse, lse_b)
    o = (torch.exp(lse - lse_new)[..., None] * o
         + torch.exp(lse_b - lse_new)[..., None] * o_b.float())
    return o, lse_new


def _dot_step(q, k, v, lens, carry, scale):
    """The online-softmax step of JAX's dot body, [B, T, H, ·] layout."""
    m, l, o = carry
    s = torch.einsum("bthd,bshd->bths", q.float(), k.float()) * scale
    valid = (torch.arange(k.shape[1], device=q.device)[None, :]
             < lens[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full((), -1e30, device=s.device))
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.where(valid, torch.exp(s - m_new[..., None]), torch.zeros((), device=s.device))
    l = alpha * l + p.sum(-1)
    o = alpha[..., None] * o + torch.einsum("bths,bshd->bthd", p.to(v.dtype).float(),
                                            v.float())
    return m_new, l, o


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_lengths: torch.Tensor, mesh: Mesh, *, body: str = "flash"
                   ) -> torch.Tensor:
    """This model rank's block of full attention: q, k, v [B, T/n, H, D]
    are its frames, ``kv_lengths`` [B] the global valid frame counts.
    Returns [B, T/n, H, D] in q's dtype."""
    if body not in ("flash", "dot"):
        raise ValueError(f"ring body must be 'flash' or 'dot', got {body!r}")
    n, block = mesh.tp, k.shape[1]
    src = mesh.model_index                   # the rank whose block is resident
    lens = torch.clamp(kv_lengths.to(torch.int32) - src * block, 0, block)
    b, t, h, d = q.shape
    if body == "flash":
        carry = (torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device),
                 torch.full((b, h, t), LSE_INIT, device=q.device))
        step = flash_step
    else:
        carry = (torch.full((b, t, h), -float("inf"), device=q.device),
                 torch.zeros((b, t, h), device=q.device),
                 torch.zeros((b, t, h, d), device=q.device))
        step = lambda *a: _dot_step(*a, scale=1.0 / d ** 0.5)
    for i in range(n):
        carry = step(q, k, v, lens, carry)
        if i < n - 1:
            lens, k, v = _RingShift.apply(mesh, lens, k, v)
    if body == "flash":          # rows with no kept key are already 0
        return carry[0].transpose(1, 2).to(q.dtype)
    _, l, o = carry
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l[..., None]).to(q.dtype)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, mesh: Mesh, *, body: str = "flash"
                        ) -> torch.Tensor:
    """Encoder self-attention through the ring. q, k, v [B, T, H/n, D] come
    head-sharded from the tensor-parallel projections (JAX hands them to
    ``shard_map`` with ``in_specs=P(batch, 'model')``, which reshards them
    the same way): the frame axis is padded to a multiple of n, one
    ``all_to_all`` per tensor moves them to the ring's frame-sharded
    [B, T/n, H, D], and the result goes back to [B, T, H/n, D], sliced to
    T. Padded key frames lie past every length; padded query rows are
    dropped."""
    n, t = mesh.tp, q.shape[1]
    t_pad = -(-t // n) * n
    if t_pad != t:
        pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, t_pad - t))
        q, k, v = pad(q), pad(k), pad(v)
    to_frames = lambda x: all_to_all(x, mesh, split_dim=1, cat_dim=2)
    out = ring_attention(to_frames(q), to_frames(k), to_frames(v), lengths, mesh,
                         body=body)
    return all_to_all(out, mesh, split_dim=2, cat_dim=1)[:, :t]

"""Megatron tensor parallelism over the mesh's ``model`` axis, and the
collectives the model needs gradients through.

The two conjugate functions of Megatron-LM:
  * ``copy_to_model``: identity forward, all-reduce of the gradient
    backward. It enters every column-parallel product, whose input is the
    same on every model rank but whose gradient each rank holds only in
    part;
  * ``reduce_from_model``: all-reduce forward, identity backward. It ends
    every row-parallel product, whose output each rank holds only in part.
``gather_from_model`` concatenates the ranks' slices of the last axis
(the d_model-sharded embedding, an untied output projection's vocabulary
shards) and hands each rank its slice of the gradient. ``all_to_all``
moves a tensor from one sharded axis to another (heads to frames for ring
attention, and back); its backward is the reverse move.

``column_linear`` and ``row_linear`` are the sharded ``nn.Linear`` calls.
A column-parallel layer's bias is either sharded with its weight or, as
the JAX rules keep q/k/v and FFN ``Dense_0`` biases, replicated: then
each rank adds its slice, and ``copy_to_model`` sums the slices'
gradients into the whole bias. A row-parallel layer adds its replicated
bias once, after the reduction. Every function is the identity on tensors
when ``mesh`` is None, so the single-device model runs the same code.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.nn import functional as F

from .mesh import Mesh


def all_gather_stack(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[n, *x.shape]: every rank's ``x`` of ``group`` (n ranks), in rank
    order (flat buffers, the layout both gloo and nccl take)."""
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=group)
    return out.view((n,) + x.shape)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_last(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    parts = all_gather_stack(x, mesh.model_group, mesh.tp)
    return torch.cat(parts.unbind(0), dim=-1)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return _gather_last(x, mesh)

    @staticmethod
    def backward(ctx, g):
        m, w = ctx.mesh.model_index, ctx.width
        return g[..., m * w:(m + 1) * w].contiguous(), None


def _all_to_all(x: torch.Tensor, mesh: Mesh, split_dim: int, cat_dim: int):
    inp = torch.stack(x.chunk(mesh.tp, dim=split_dim), 0).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=mesh.model_group)
    return torch.cat(out.unbind(0), dim=cat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, split_dim, cat_dim):
        ctx.args = (mesh, cat_dim, split_dim)
        return _all_to_all(x, mesh, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return x if mesh is None else _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return x if mesh is None else _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return x if mesh is None else _GatherFromModel.apply(x, mesh)


def all_to_all(x: torch.Tensor, mesh: Mesh, *, split_dim: int, cat_dim: int
               ) -> torch.Tensor:
    """Split ``x`` into ``tp`` chunks along ``split_dim``, send chunk j to
    model rank j, and concatenate the chunks received along ``cat_dim``
    (in rank order). Differentiable."""
    return _AllToAll.apply(x, mesh, split_dim, cat_dim)


def dropout_shard(mesh: Optional[Mesh], dim: int):
    """``ops/dropout``'s ``shard`` for a tensor split over the model ranks
    along ``dim`` (None without a mesh)."""
    return None if mesh is None else (mesh.tp, mesh.model_index, dim)


def local_slice(x: torch.Tensor, mesh: Optional[Mesh], dim: int = -1) -> torch.Tensor:
    """This model rank's equal slice of ``x`` along ``dim``."""
    if mesh is None:
        return x
    return x.chunk(mesh.tp, dim=dim)[mesh.model_index]


def column_linear(linear: torch.nn.Linear, x: torch.Tensor, mesh: Optional[Mesh], *,
                  bias_replicated: bool = True) -> torch.Tensor:
    """``x`` (the same on every model rank) times this rank's output columns
    of ``linear``. ``bias_replicated``: the bias is whole and the rank adds
    its slice."""
    if mesh is None:
        return linear(x)
    bias = linear.bias
    if bias is not None and bias_replicated:
        bias = local_slice(copy_to_model(bias, mesh), mesh, 0)
    return F.linear(copy_to_model(x, mesh), linear.weight, bias)


def row_linear(linear: torch.nn.Linear, x: torch.Tensor, mesh: Optional[Mesh]
               ) -> torch.Tensor:
    """This rank's input rows of ``linear`` applied to its slice ``x``,
    summed over the model ranks, then the replicated bias."""
    if mesh is None:
        return linear(x)
    if mesh.tp == 1:       # the bias in the product, as the single-device call
        return reduce_from_model(linear(x), mesh)
    y = reduce_from_model(F.linear(x, linear.weight), mesh)
    return y if linear.bias is None else y + linear.bias

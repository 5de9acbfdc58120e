"""Weight bridge between the JAX package's flax parameter tree and the
port's ``state_dict``.

The tree is nested dicts of numpy arrays (``jax.tree.map(np.asarray,
variables)``), with or without the top-level ``"params"`` key. Layout rules:
  Dense kernel [in..., out...]      -> Linear weight [prod(out), prod(in)]
    (self-attention ``qkv`` [d,3,H,Dh], cross ``q/k/v`` [d,H,Dh],
     ``out`` [H,Dh,d] contracting two axes)
  Conv kernel HWIO [3,3,Cin,Cout]   -> Conv2d weight OIHW (permute 3,2,0,1)
  LayerNorm scale/bias              -> LayerNorm weight/bias
  decoder embed/embedding [V,d]     -> Embedding weight (tied output proj.)
Both directions only reshape and transpose, so a round trip is exact.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .config import ModelConfig

StateDict = Dict[str, torch.Tensor]


def _entries(cfg: ModelConfig):
    """(torch name, jax path, kind, jax shape) for every parameter. ``kind``
    is ``("dense", n)`` for a kernel whose first n axes are contracted,
    ``("bias",)``, ``("conv",)`` or ``("copy",)``."""
    d, h, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    c = cfg.subsample_channels
    freq = (((cfg.input_dim - 3) // 2 + 1) - 3) // 2 + 1
    out = []

    def dense(name, path, in_shape, out_shape, bias=True):
        out.append((f"{name}.weight", path + ("kernel",), ("dense", len(in_shape)),
                    tuple(in_shape) + tuple(out_shape)))
        if bias:
            out.append((f"{name}.bias", path + ("bias",), ("bias",), tuple(out_shape)))

    def norm(name, path):
        out.append((f"{name}.weight", path + ("LayerNorm_0", "scale"), ("copy",), (d,)))
        out.append((f"{name}.bias", path + ("LayerNorm_0", "bias"), ("copy",), (d,)))

    def attn(name, path, fused):
        if fused:
            dense(f"{name}.qkv", path + ("qkv",), (d,), (3, h, dh))
        else:
            for p in ("q", "k", "v"):
                dense(f"{name}.{p}", path + (p,), (d,), (h, dh))
        dense(f"{name}.out", path + ("out",), (h, dh), (d,))

    def ffn(name, path):
        dense(f"{name}.fc1", path + ("Dense_0",), (d,), (cfg.d_ff,))
        dense(f"{name}.fc2", path + ("Dense_1",), (cfg.d_ff,), (d,))

    sub = ("encoder", "subsample")
    for i, cin in enumerate((1, c)):
        out.append((f"encoder.subsample.conv{i}.weight", sub + (f"Conv_{i}", "kernel"),
                    ("conv",), (3, 3, cin, c)))
        out.append((f"encoder.subsample.conv{i}.bias", sub + (f"Conv_{i}", "bias"),
                    ("copy",), (c,)))
    dense("encoder.subsample.out", sub + ("Dense_0",), (freq * c,), (d,))
    for i in range(cfg.num_encoder_layers):
        n, p = f"encoder.layers.{i}", ("encoder", f"layer_{i}")
        attn(f"{n}.self_attn", p + ("self_attn",), cfg.fused_qkv)
        ffn(f"{n}.ffn", p + ("FeedForward_0",))
        norm(f"{n}.ln1", p + ("LayerNorm_0",))
        norm(f"{n}.ln2", p + ("LayerNorm_1",))
    norm("encoder.final_norm", ("encoder", "final_norm"))

    out.append(("decoder.embed.weight", ("decoder", "embed", "embedding"), ("copy",),
                (cfg.vocab_size, d)))
    for i in range(cfg.num_decoder_layers):
        n, p = f"decoder.layers.{i}", ("decoder", f"layer_{i}")
        attn(f"{n}.self_attn", p + ("self_attn",), cfg.fused_qkv)
        attn(f"{n}.cross_attn", p + ("cross_attn",), False)
        ffn(f"{n}.ffn", p + ("ffn",))
        for j in (1, 2, 3):
            norm(f"{n}.ln{j}", p + (f"ln{j}",))
    norm("decoder.final_norm", ("decoder", "final_norm"))
    if not cfg.share_embedding:
        dense("decoder.out_proj", ("decoder", "out_proj"), (d,), (cfg.vocab_size,),
              bias=False)
    return out


def params_from_jax(tree: dict, cfg: ModelConfig) -> StateDict:
    """flax param tree (numpy leaves) -> the port's float32 ``state_dict``."""
    params = tree.get("params", tree)
    sd: StateDict = {}
    for name, path, kind, shape in _entries(cfg):
        x = params
        for key in path:
            x = x[key]
        x = np.asarray(x)
        if x.shape != shape:
            raise ValueError(f"{'/'.join(path)}: shape {x.shape}, expected {shape}")
        if kind[0] == "dense":
            x = x.reshape(int(np.prod(shape[:kind[1]])), -1).T
        elif kind[0] == "bias":
            x = x.reshape(-1)
        elif kind[0] == "conv":
            x = x.transpose(3, 2, 0, 1)
        sd[name] = torch.from_numpy(np.array(x, order="C"))   # a writable copy
    return sd


def params_to_jax(state_dict: StateDict, cfg: ModelConfig) -> dict:
    """The port's ``state_dict`` -> ``{"params": tree}`` with numpy leaves."""
    tree: dict = {}
    for name, path, kind, shape in _entries(cfg):
        x = state_dict[name].detach().cpu().numpy()
        if kind[0] in ("dense", "bias"):
            x = x.T.reshape(shape)
        elif kind[0] == "conv":
            x = x.transpose(2, 3, 1, 0)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(x)
    return {"params": tree}

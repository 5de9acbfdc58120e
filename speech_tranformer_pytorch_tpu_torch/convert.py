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
        sd[name] = _to_torch(x)
    return sd


def _to_torch(x: np.ndarray) -> torch.Tensor:
    """A writable torch copy; numpy's bfloat16 (an extension dtype torch
    cannot read) comes over exactly through float32."""
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(x, np.float32, order="C")).to(torch.bfloat16)
    return torch.from_numpy(np.array(x, order="C"))


def params_to_jax(state_dict: StateDict, cfg: ModelConfig) -> dict:
    """The port's ``state_dict`` -> ``{"params": tree}`` with numpy leaves
    (bfloat16 tensors, such as bf16 Adam moments, come back as float32
    arrays holding the same values: numpy has no bfloat16 of its own)."""
    tree: dict = {}
    for name, path, kind, shape in _entries(cfg):
        t = state_dict[name].detach().cpu()
        x = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        if kind[0] in ("dense", "bias"):
            x = x.T.reshape(shape)
        elif kind[0] == "conv":
            x = x.transpose(2, 3, 1, 0)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(x)
    return {"params": tree}


def _find_moments(state):
    """The first node of a JAX optimizer state with ``mu`` and ``nu``: a
    ``FusedAdamState`` itself, or the ``ScaleByAdamState`` inside an optax
    chain's nested tuples."""
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find_moments(s)
            if found is not None:
                return found
    return None


def adam_state_from_jax(opt_state, cfg: ModelConfig, *, device="cpu"):
    """A JAX ``FusedAdamState`` or optax chain state (numpy or jax leaves)
    -> the port's ``ops.fused_adam.AdamState`` on ``device``. mu and nu
    mirror the param tree, so they cross with ``params_from_jax``; their
    dtype (f32 or bf16) is kept."""
    from .ops.fused_adam import AdamState

    node = _find_moments(opt_state)
    if node is None:
        raise ValueError("optimizer state has no node with mu and nu")
    moments = [{k: v.to(device) for k, v in params_from_jax(_as_numpy(tree), cfg).items()}
               for tree in (node.mu, node.nu)]
    count = torch.tensor(int(np.asarray(node.count)), dtype=torch.int32, device=device)
    return AdamState(count=count, mu=moments[0], nu=moments[1])


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)

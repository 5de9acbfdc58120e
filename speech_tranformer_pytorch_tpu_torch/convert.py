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

With ``model.scan_layers`` the JAX encoder keeps its layers stacked in one
``nn.scan`` module, ``encoder/layers/layer/<module>/<leaf>``, every leaf
with a leading axis of length ``num_encoder_layers``; layer i of that
stack is the port's ``encoder.layers.{i}``. The JAX decoder is never
scanned and keeps ``decoder/layer_{i}``. ``scan_layers`` selects JAX-only
machinery: the converter is the one place the port reads it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .config import ModelConfig

StateDict = Dict[str, torch.Tensor]


def _entries(cfg: ModelConfig):
    """(torch name, jax path, kind, jax shape, layer) for every parameter.
    ``kind`` is ``("dense", n)`` for a kernel whose first n axes are
    contracted, ``("bias",)``, ``("conv",)`` or ``("copy",)``; ``layer`` is
    the index into the leaf's leading axis for a scanned encoder layer, else
    None (``shape`` is then one layer's)."""
    d, h, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    c = cfg.subsample_channels
    freq = (((cfg.input_dim - 3) // 2 + 1) - 3) // 2 + 1
    out = []
    layer = None

    def add(name, path, kind, shape):
        out.append((name, path, kind, shape, layer))

    def dense(name, path, in_shape, out_shape, bias=True):
        add(f"{name}.weight", path + ("kernel",), ("dense", len(in_shape)),
            tuple(in_shape) + tuple(out_shape))
        if bias:
            add(f"{name}.bias", path + ("bias",), ("bias",), tuple(out_shape))

    def norm(name, path):
        add(f"{name}.weight", path + ("LayerNorm_0", "scale"), ("copy",), (d,))
        add(f"{name}.bias", path + ("LayerNorm_0", "bias"), ("copy",), (d,))

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
        add(f"encoder.subsample.conv{i}.weight", sub + (f"Conv_{i}", "kernel"),
            ("conv",), (3, 3, cin, c))
        add(f"encoder.subsample.conv{i}.bias", sub + (f"Conv_{i}", "bias"), ("copy",), (c,))
    dense("encoder.subsample.out", sub + ("Dense_0",), (freq * c,), (d,))
    for i in range(cfg.num_encoder_layers):
        n = f"encoder.layers.{i}"
        if cfg.scan_layers:
            p, layer = ("encoder", "layers", "layer"), i
        else:
            p = ("encoder", f"layer_{i}")
        attn(f"{n}.self_attn", p + ("self_attn",), cfg.fused_qkv)
        ffn(f"{n}.ffn", p + ("FeedForward_0",))
        norm(f"{n}.ln1", p + ("LayerNorm_0",))
        norm(f"{n}.ln2", p + ("LayerNorm_1",))
    layer = None
    norm("encoder.final_norm", ("encoder", "final_norm"))

    add("decoder.embed.weight", ("decoder", "embed", "embedding"), ("copy",),
        (cfg.vocab_size, d))
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


def _leaf(params: dict, path, layer=None) -> np.ndarray:
    for key in path:
        params = params[key]
    x = np.asarray(params)
    return x if layer is None else x[layer]


def _to_port_layout(x: np.ndarray, kind) -> np.ndarray:
    if kind[0] == "dense":
        return x.reshape(int(np.prod(x.shape[:kind[1]])), -1).T
    if kind[0] == "bias":
        return x.reshape(-1)
    if kind[0] == "conv":
        return x.transpose(3, 2, 0, 1)
    return x


def params_from_jax(tree: dict, cfg: ModelConfig) -> StateDict:
    """flax param tree (numpy leaves) -> the port's float32 ``state_dict``."""
    params = tree.get("params", tree)
    sd: StateDict = {}
    for name, path, kind, shape, layer in _entries(cfg):
        x = _leaf(params, path, layer)
        if x.shape != shape:
            raise ValueError(f"{'/'.join(path)}: shape {x.shape}, expected {shape}")
        sd[name] = _to_torch(_to_port_layout(x, kind))
    return sd


def quantized_from_jax(qparams: dict, scales: dict, cfg: ModelConfig):
    """JAX ``quantize_params`` output ``(qparams, scales)`` (numpy leaves)
    -> the port's ``(qparams, scales)`` as ``ops/quantize.quantize_params``
    makes them: int8 leaves in the port's layout, each scale broadcast to
    the JAX kernel shape and read off as one f32 value per output column
    (per row for the embedding)."""
    qp, sc = qparams.get("params", qparams), scales.get("params", scales)
    out_q, out_s = params_from_jax(qp, cfg), {}
    for name, path, kind, shape, layer in _entries(cfg):
        q = _leaf(qp, path, layer)
        if q.dtype != np.int8:
            continue
        s = np.broadcast_to(_leaf(sc, path, layer).astype(np.float32), shape)
        s = _to_port_layout(s, kind)          # output channels on axis 0
        out_s[name] = torch.from_numpy(np.array(s.reshape(s.shape[0], -1)[:, 0]))
    return out_q, out_s


def _to_torch(x: np.ndarray) -> torch.Tensor:
    """A writable torch copy; numpy's bfloat16 (an extension dtype torch
    cannot read) comes over exactly through float32."""
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(x, np.float32, order="C")).to(torch.bfloat16)
    return torch.from_numpy(np.array(x, order="C"))


def params_to_jax(state_dict: StateDict, cfg: ModelConfig) -> dict:
    """The port's ``state_dict`` -> ``{"params": tree}`` with numpy leaves
    (bfloat16 tensors, such as bf16 Adam moments, come back as float32
    arrays holding the same values: numpy has no bfloat16 of its own).
    With ``cfg.scan_layers`` the encoder layers are stacked as JAX's scan
    keeps them."""
    leaves: dict = {}
    for name, path, kind, shape, layer in _entries(cfg):
        t = state_dict[name].detach().cpu()
        x = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        if kind[0] in ("dense", "bias"):
            x = x.T.reshape(shape)
        elif kind[0] == "conv":
            x = x.transpose(2, 3, 1, 0)
        if layer is None:
            leaves[path] = x
        else:                       # a scanned leaf: its layers come in order
            leaves.setdefault(path, []).append(x)
    tree: dict = {}
    for path, x in leaves.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(np.stack(x) if isinstance(x, list) else x)
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
    -> the port's ``ops.fused_adam.AdamState`` on ``device``. mu, nu and,
    with ``train.master_weights``, the f32 master mirror the param tree, so
    they cross with ``params_from_jax``; their dtype (f32 or bf16) is kept."""
    from .ops.fused_adam import AdamState

    node = _find_moments(opt_state)
    if node is None:
        raise ValueError("optimizer state has no node with mu and nu")
    master = getattr(node, "master", None)
    trees = [node.mu, node.nu] + ([] if master is None else [master])
    moments = [{k: v.to(device) for k, v in params_from_jax(_as_numpy(tree), cfg).items()}
               for tree in trees]
    count = torch.tensor(int(np.asarray(node.count)), dtype=torch.int32, device=device)
    return AdamState(count=count, mu=moments[0], nu=moments[1],
                     master=moments[2] if master is not None else None)


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


_NPZ_TREES = ("params", "mu", "nu", "master")


def checkpoint_from_npz(path: str, cfg):
    """A JAX ``Trainer`` checkpoint converted by ``convert_jax_checkpoint.py``
    (``.npz``, numpy only) -> ``(step, utils.checkpoint.CheckpointState)``
    for ``cfg`` (an ``ExperimentConfig``), through ``params_from_jax`` and
    ``adam_state_from_jax``; each tree gets the dtype the JAX run kept it
    in (the file holds bfloat16 leaves as float32 values, exactly).

    The file has the flattened trees ``params/...``, ``mu/...``, ``nu/...``
    and, with ``train.master_weights``, ``master/...``; the Adam ``count``;
    ``step``, ``epoch``, ``batch_in_epoch``, ``best_dev_loss``,
    ``best_dev_step``; ``config_hash``; ``dtype/<tree>`` for each tree. JAX's
    PRNG key is not carried: the port's dropout and SpecAugment bits come
    from (seed, step) alone."""
    from types import SimpleNamespace

    from .ops.fused_adam import AdamState
    from .utils.checkpoint import CheckpointState

    trees: dict = {g: {} for g in _NPZ_TREES}
    with np.load(path, allow_pickle=False) as z:
        meta = {k: z[k] for k in z.files if "/" not in k or k.startswith("dtype/")}
        for k in z.files:
            group, _, leaf = k.partition("/")
            if group in trees and leaf:
                node = trees[group]
                *parents, name = leaf.split("/")
                for key in parents:
                    node = node.setdefault(key, {})
                node[name] = z[k]

    def cast(sd, group):
        dt = getattr(torch, str(meta[f"dtype/{group}"]))
        return {k: v.to(dt) for k, v in sd.items()}

    master = trees["master"] or None
    opt = adam_state_from_jax(SimpleNamespace(mu=trees["mu"], nu=trees["nu"],
                                              count=meta["count"], master=master),
                              cfg.model)
    opt = AdamState(count=opt.count, mu=cast(opt.mu, "mu"), nu=cast(opt.nu, "nu"),
                    master=None if master is None else cast(opt.master, "master"))
    return int(meta["step"]), CheckpointState(
        params=cast(params_from_jax(trees["params"], cfg.model), "params"), opt=opt,
        epoch=int(meta["epoch"]),
        batch_in_epoch=int(meta["batch_in_epoch"]),
        config_hash=str(meta["config_hash"]),
        best_dev_loss=float(meta["best_dev_loss"]),
        best_dev_step=int(meta["best_dev_step"]))

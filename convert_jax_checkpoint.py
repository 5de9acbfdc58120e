"""Convert a JAX ``Trainer`` checkpoint (orbax, ``<work-dir>/checkpoints``)
into one ``.npz`` that the PyTorch port reads without JAX.

Run it where the JAX package is installed:

    python convert_jax_checkpoint.py --work-dir RUN --out ckpt.npz [--step N]
        [--checkpoint best] [--config RUN/config.json]

The config defaults to the run's ``config.json`` (``train_cli`` writes it);
``--checkpoint best`` reads ``RUN/best`` instead of ``RUN/checkpoints``, as
``recognize_cli --checkpoint best`` does.
The restore goes through the JAX package's ``Checkpointer.restore`` with a
template of ``create_train_state`` for that config, in either optimizer
layout: ``FusedAdam`` (``train.fused_optimizer``) or the optax chain (the
default, and every mesh run), scanned encoder layers or not. The file
holds the flattened ``params``, ``mu``, ``nu`` and (with
``train.master_weights``) ``master`` trees, the Adam ``count``, ``step``,
``epoch``, ``batch_in_epoch``, ``best_dev_loss``, ``best_dev_step``, the
``config_hash`` and ``config_json``, and ``dtype/<tree>``. bfloat16 leaves
are written as float32 values (exact), since numpy has no bfloat16. JAX's
PRNG key is dropped: the port's dropout bits come from (seed, step).

Then, in the port (no JAX needed):

    from speech_tranformer_pytorch_tpu_torch.convert import checkpoint_from_npz
    from speech_tranformer_pytorch_tpu_torch.utils.checkpoint import write_checkpoint
    step, ckpt = checkpoint_from_npz("ckpt.npz", cfg)
    write_checkpoint("port_run", step, ckpt, cfg)

and ``Trainer(cfg, work_dir="port_run", resume=True)`` continues the run,
``load_recognizer(cfg, "port_run/checkpoints")`` serves it.
"""

from __future__ import annotations

import argparse
import json
import os
from collections.abc import Mapping
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from speech_tranformer_pytorch_tpu import train as jtrain
from speech_tranformer_pytorch_tpu.config import ExperimentConfig, config_from_dict
from speech_tranformer_pytorch_tpu.utils.checkpoint import Checkpointer, CheckpointState


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(tree)


def _moments(opt_state):
    """The node of a JAX optimizer state with ``mu`` and ``nu``: a
    ``FusedAdamState`` itself, or the ``ScaleByAdamState`` in an optax
    chain's nested tuples."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _moments(s)
            if found is not None:
                return found
    return None


def _template(cfg: ExperimentConfig, sharded: bool):
    """``create_train_state``'s shapes and dtypes on the CPU, without init:
    ``sharded`` selects the optax chain, as the JAX mesh ``Trainer`` does."""
    frames = 64
    example = jtrain.Batch(
        feats=jnp.zeros((1, frames, cfg.model.input_dim), jnp.float32),
        frame_lens=jnp.full((1,), frames, jnp.int32),
        targets_in=jnp.zeros((1, 8), jnp.int32), targets_out=jnp.zeros((1, 8), jnp.int32),
        target_lens=jnp.ones((1,), jnp.int32))
    shapes = jax.eval_shape(lambda: jtrain.create_train_state(
        cfg, jax.random.PRNGKey(0), example, sharded=sharded))
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=cpu),
                        shapes)


def restore(cfg: ExperimentConfig, directory: str, step: Optional[int] = None):
    """(step, CheckpointState) from a JAX checkpoint directory, trying the
    config's own optimizer layout first, then the other."""
    if not jtrain.uses_fused_optimizer(cfg):
        layouts = [True]
    else:   # master weights exist only in FusedAdam's layout
        layouts = [False] if cfg.train.master_weights else [False, True]
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    ckpt = Checkpointer(directory, async_save=False)
    errors = []
    try:
        for sharded in layouts:
            template = CheckpointState(_template(cfg, sharded), jax.random.PRNGKey(0),
                                       0, 0, "")
            try:
                return ckpt.restore(template, step)
            except (ValueError, KeyError, TypeError) as e:
                errors.append(f"{'optax chain' if sharded else 'FusedAdam'}: {e}")
    finally:
        ckpt.close()
    raise ValueError(f"{directory}: no optimizer layout of this config matches the "
                     "checkpoint:\n" + "\n".join(errors))


def convert(cfg: ExperimentConfig, directory: str, out: str,
            step: Optional[int] = None) -> int:
    """Write ``out`` (.npz) from the checkpoint ``step`` (default: the
    latest) in ``directory``; returns the step."""
    step, ck = restore(cfg, directory, step)
    node = _moments(ck.state.opt_state)
    if node is None:
        raise ValueError("optimizer state has no node with mu and nu")
    trees = {"params": ck.state.params, "mu": node.mu, "nu": node.nu}
    master = getattr(node, "master", None)
    if master is not None:
        trees["master"] = master
    arrays: Dict[str, np.ndarray] = {}
    for group, tree in trees.items():
        leaves: Dict[str, np.ndarray] = {}
        _flatten(jax.device_get(tree), group, leaves)
        dtypes = {str(x.dtype) for x in leaves.values()}
        if len(dtypes) != 1:
            raise ValueError(f"{group}: leaves of several dtypes {sorted(dtypes)}")
        arrays[f"dtype/{group}"] = np.array(dtypes.pop())
        arrays.update({k: np.asarray(v, np.float32) if v.dtype.name == "bfloat16" else v
                       for k, v in leaves.items()})
    arrays.update(
        count=np.asarray(jax.device_get(node.count), np.int64), step=np.int64(step),
        epoch=np.int64(ck.epoch), batch_in_epoch=np.int64(ck.batch_in_epoch),
        best_dev_loss=np.float64(ck.best_dev_loss),
        best_dev_step=np.int64(ck.best_dev_step),
        config_hash=np.array(ck.config_hash), config_json=np.array(cfg.to_json()))
    tmp = out + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, out)
    return step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work-dir", required=True, help="the JAX run's work dir")
    ap.add_argument("--out", required=True, help="the .npz to write")
    ap.add_argument("--step", type=int, default=None, help="default: the latest")
    ap.add_argument("--checkpoint", choices=("latest", "best"), default="latest")
    ap.add_argument("--config", default=None,
                    help="the run's config JSON (default: <work-dir>/config.json)")
    args = ap.parse_args(argv)
    with open(args.config or os.path.join(args.work_dir, "config.json")) as f:
        cfg = config_from_dict(json.load(f)).validate()
    directory = "best" if args.checkpoint == "best" else "checkpoints"
    step = convert(cfg, os.path.join(args.work_dir, directory), args.out, args.step)
    print(json.dumps({"step": step, "out": args.out}))


if __name__ == "__main__":
    main()

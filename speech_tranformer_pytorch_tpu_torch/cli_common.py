"""Shared CLI plumbing (counterpart of the JAX package's ``cli_common.py``):
the preset, ``--set section.key=value`` overrides, the data-directory
conventions and the port's ``--device``."""

from __future__ import annotations

import argparse
import ast
import os

import torch.distributed as dist

from .config import ExperimentConfig, apply_overrides, get_config


def add_common_args(ap: argparse.ArgumentParser) -> None:
    # None (resolved to "base") tells an explicit --preset from the default:
    # train_cli --resume warns that it ignores one.
    ap.add_argument("--preset", default=None,
                    help="tiny|base|large|librispeech|sharded (default: base)")
    ap.add_argument("--data-dir", default=None,
                    help="directory with {train,dev,test}.jsonl + vocab.json")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    dest="overrides",
                    help="config override, e.g. --set model.d_model=640")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; 'cpu' runs "
                         "the plain PyTorch versions of the kernels)")


def run_on_ranks(args, run):
    """``run(args, device)``. Under a ``torchrun`` launch, with
    ``--distributed`` or with ``--mesh on`` the process first joins the
    process group (``parallel.mesh.init_distributed``: ``device`` becomes
    this rank's card) and leaves it when ``run`` returns or raises."""
    from .parallel.mesh import init_distributed, launched_world

    joined = args.distributed or args.mesh == "on" or launched_world() > 1
    if not joined:
        return run(args, args.device)
    try:
        return run(args, init_distributed(args.device))
    finally:
        dist.destroy_process_group()


def _parse_value(s: str):
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def parse_overrides(pairs) -> dict:
    """``["k=v", ...]`` -> ``{k: literal value}``."""
    out = {}
    for kv in pairs:
        if "=" not in kv:
            raise SystemExit(f"--set expects K=V, got {kv!r}")
        k, v = kv.split("=", 1)
        out[k] = _parse_value(v)
    return out


def resolve_config(args) -> ExperimentConfig:
    """The preset, then ``--data-dir``'s manifests and vocabulary (whose size
    sets ``model.vocab_size``), then the ``--set`` overrides; validated."""
    overrides = parse_overrides(args.overrides)
    cfg = get_config(args.preset or "base")
    if args.data_dir:
        d = args.data_dir
        data_overrides = {}
        for split in ("train", "dev", "test"):
            p = os.path.join(d, f"{split}.jsonl")
            if os.path.exists(p):
                data_overrides[f"data.{split}_manifest"] = p
        vocab = os.path.join(d, "vocab.json")
        if os.path.exists(vocab):
            from .data.tokenizer import load_tokenizer
            data_overrides["data.vocab_path"] = vocab
            data_overrides["model.vocab_size"] = load_tokenizer(vocab).vocab_size
        cfg = apply_overrides(cfg, data_overrides)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg.validate()


def saved_config(path: str, override_pairs) -> ExperimentConfig:
    """A run's saved ``config.json`` with ``--set`` overrides on top."""
    import json

    from .config import config_from_dict
    with open(path) as f:
        cfg = config_from_dict(json.load(f))
    overrides = parse_overrides(override_pairs)
    return apply_overrides(cfg, overrides) if overrides else cfg

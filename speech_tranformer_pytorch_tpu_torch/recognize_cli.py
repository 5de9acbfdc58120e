"""Decoding CLI (counterpart of the JAX package's ``recognize_cli.py``):
decode a manifest with a trained run's checkpoint and print its scores as
one JSON line.

  python -m speech_tranformer_pytorch_tpu_torch.recognize_cli \
      --data-dir exp/data --work-dir exp/run1 --split test --beam 5 \
      --out exp/run1/hyps.jsonl [--device cpu]

Over several cards, each rank decoding its share of every batch:

  torchrun --nproc-per-node 4 -m speech_tranformer_pytorch_tpu_torch.recognize_cli \
      --data-dir exp/data --work-dir exp/run1 --distributed
"""

from __future__ import annotations

import argparse
import json
import os

from .cli_common import add_common_args, resolve_config, run_on_ranks, saved_config
from .parallel.mesh import make_mesh, make_mesh_auto


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--work-dir", required=True,
                    help="training work dir (checkpoints/ inside)")
    ap.add_argument("--manifest", default=None,
                    help="explicit manifest path (else <data-dir>/<split>.jsonl)")
    ap.add_argument("--split", default="test")
    ap.add_argument("--beam", type=int, default=None)
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--batch-size", type=int, default=32,
                    help="utterances per decode batch")
    ap.add_argument("--out", default=None)
    ap.add_argument("--checkpoint", choices=("latest", "best"), default="latest",
                    help="'best': the best-dev-loss model the Trainer kept in "
                         "work_dir/best; 'latest': the newest step checkpoint")
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights (decode.int8_weights)")
    ap.add_argument("--int8-kv", action="store_true",
                    help="int8 cross-K/V decode cache (decode.int8_kv_cache)")
    ap.add_argument("--mesh", choices=("auto", "on", "off"), default="auto",
                    help="'auto': sharded decoding over a ('data','model') mesh "
                         "when mesh.model_axis > 1 and the ranks fit it (one "
                         "device otherwise, with a warning); 'on' forces it; "
                         "'off' decodes on one device")
    ap.add_argument("--distributed", action="store_true",
                    help="decode under a torchrun launch: each rank decodes its "
                         "share of every batch, all ranks report the whole "
                         "manifest's scores (--out written by rank 0; "
                         "--batch-size is per data rank)")
    args = ap.parse_args(argv)
    return run_on_ranks(args, _run)


def _run(args, device):
    # The config train_cli saved is the base; --set applies on top.
    saved = os.path.join(args.work_dir, "config.json")
    cfg = (saved_config(saved, args.overrides) if os.path.exists(saved)
           else resolve_config(args))
    if args.int8:
        cfg = cfg.replace(decode=cfg.decode.replace(int8_weights=True))
    if args.int8_kv:
        cfg = cfg.replace(decode=cfg.decode.replace(int8_kv_cache=True))
    manifest = args.manifest or os.path.join(args.data_dir, f"{args.split}.jsonl")
    ckpt_dir = os.path.join(args.work_dir,
                            "best" if args.checkpoint == "best" else "checkpoints")
    if args.checkpoint == "best" and not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"{ckpt_dir} not found: the run had no dev evals, "
                                "so no best model was kept (use --checkpoint latest)")
    mesh = None
    if args.distributed or args.mesh == "on":
        mesh = make_mesh(cfg.mesh, device=device)
    elif args.mesh == "auto" and cfg.mesh.model_axis > 1:
        mesh = make_mesh_auto(cfg.mesh, device=device)
    from .recognize import load_recognizer
    rec = load_recognizer(cfg, ckpt_dir, vocab_path=cfg.data.vocab_path or None,
                          device=device, mesh=mesh)
    scores = rec.decode_manifest(manifest, beam_size=args.beam, max_len=args.max_len,
                                 alpha=args.alpha, batch_size=args.batch_size,
                                 out_path=args.out, distributed=args.distributed)
    print(json.dumps(scores))


if __name__ == "__main__":
    main()

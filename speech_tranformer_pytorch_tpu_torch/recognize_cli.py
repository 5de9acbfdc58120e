"""Decoding CLI (counterpart of the JAX package's ``recognize_cli.py``):
decode a manifest with a trained run's checkpoint and print its scores as
one JSON line.

  python -m speech_tranformer_pytorch_tpu_torch.recognize_cli \
      --data-dir exp/data --work-dir exp/run1 --split test --beam 5 \
      --out exp/run1/hyps.jsonl [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from .cli_common import add_common_args, resolve_config, saved_config

_NOT_PORTED = "not ported yet (ROADMAP queue A item 6, parallelism)"


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
                    help="'on' (a device mesh) is not ported; 'auto' and 'off' "
                         "decode on one device")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host decoding: not ported")
    args = ap.parse_args(argv)
    if args.distributed:
        raise NotImplementedError(f"--distributed is {_NOT_PORTED}")
    if args.mesh == "on":
        raise NotImplementedError(f"--mesh on is {_NOT_PORTED}")

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
    from .recognize import load_recognizer
    rec = load_recognizer(cfg, ckpt_dir, vocab_path=cfg.data.vocab_path or None,
                          device=args.device)
    scores = rec.decode_manifest(manifest, beam_size=args.beam, max_len=args.max_len,
                                 alpha=args.alpha, batch_size=args.batch_size,
                                 out_path=args.out)
    print(json.dumps(scores))


if __name__ == "__main__":
    main()

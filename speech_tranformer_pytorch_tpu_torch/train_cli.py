"""Training CLI (counterpart of the JAX package's ``train_cli.py``).

  python -m speech_tranformer_pytorch_tpu_torch.train_cli \
      --preset base --data-dir exp/data --work-dir exp/run1 \
      --set train.num_epochs=40 [--resume] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

from .cli_common import add_common_args, resolve_config, saved_config

_NOT_PORTED = "not ported yet (ROADMAP queue A item 6, parallelism)"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--train-manifest", default=None)
    ap.add_argument("--dev-manifest", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--mesh", choices=("auto", "on", "off"), default="auto",
                    help="'on' (a device mesh) is not ported; 'auto' and 'off' "
                         "train on one device")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process training: not ported")
    args = ap.parse_args(argv)
    if args.distributed:
        raise NotImplementedError(f"--distributed is {_NOT_PORTED}")
    if args.mesh == "on":
        raise NotImplementedError(f"--mesh on is {_NOT_PORTED}")

    saved = os.path.join(args.work_dir, "config.json")
    if args.resume and os.path.exists(saved):
        # The run's own saved config is the base, so a change of library
        # defaults never alters a resumed run; --set applies on top.
        if args.preset is not None:
            print(f"warning: --preset {args.preset} ignored on --resume (the run's "
                  "saved config.json is the base; use --set K=V for targeted "
                  "changes)", file=sys.stderr)
        cfg = saved_config(saved, args.overrides).validate()
    else:
        cfg = resolve_config(args)
    os.makedirs(args.work_dir, exist_ok=True)
    with open(saved, "w") as f:
        f.write(cfg.to_json())

    from .runner import Trainer
    trainer = Trainer(cfg, work_dir=args.work_dir, train_manifest=args.train_manifest,
                      dev_manifest=args.dev_manifest, resume=args.resume,
                      device=args.device)
    trainer.train(max_steps=args.max_steps)
    print(f"done: step={trainer.state.step} work_dir={args.work_dir}")


if __name__ == "__main__":
    main()

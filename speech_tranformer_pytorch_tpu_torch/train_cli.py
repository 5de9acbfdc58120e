"""Training CLI (counterpart of the JAX package's ``train_cli.py``).

  python -m speech_tranformer_pytorch_tpu_torch.train_cli \
      --preset base --data-dir exp/data --work-dir exp/run1 \
      --set train.num_epochs=40 [--resume] [--device cpu]

On several cards, one process each (``--device cpu`` uses gloo ranks):

  torchrun --nproc-per-node 4 -m speech_tranformer_pytorch_tpu_torch.train_cli \
      --preset sharded --data-dir exp/data --work-dir exp/run1 --mesh on
"""

from __future__ import annotations

import argparse
import os
import sys

import torch.distributed as dist

from .cli_common import add_common_args, resolve_config, run_on_ranks, saved_config
from .parallel.mesh import make_mesh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--train-manifest", default=None)
    ap.add_argument("--dev-manifest", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--mesh", choices=("auto", "on", "off"), default="auto",
                    help="'auto' (default): sharded steps over a ('data','model') "
                         "mesh of every rank whenever the launch has several "
                         "ranks or mesh.model_axis > 1; 'on' forces the mesh "
                         "(mesh.model_axis must divide the ranks); 'off' trains "
                         "on one device (refused under a multi-rank launch)")
    ap.add_argument("--distributed", action="store_true",
                    help="join a torchrun launch (RANK, WORLD_SIZE, LOCAL_RANK "
                         "from the environment; each rank takes card LOCAL_RANK)")
    args = ap.parse_args(argv)
    return run_on_ranks(args, _run)


def _run(args, device):
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
    joined = dist.is_initialized()
    main_rank = not joined or dist.get_rank() == 0
    if joined:
        dist.barrier()           # every rank has read config.json
    if main_rank:
        os.makedirs(args.work_dir, exist_ok=True)
        with open(saved, "w") as f:
            f.write(cfg.to_json())

    from .runner import Trainer
    mesh = (make_mesh(cfg.mesh, device=device) if args.mesh == "on"
            else {"auto": "auto", "off": None}[args.mesh])
    trainer = Trainer(cfg, work_dir=args.work_dir, train_manifest=args.train_manifest,
                      dev_manifest=args.dev_manifest, resume=args.resume,
                      mesh=mesh, device=device)
    trainer.train(max_steps=args.max_steps)
    if main_rank:
        print(f"done: step={trainer.state.step} work_dir={args.work_dir}")


if __name__ == "__main__":
    main()

"""Readings of a Conformer serving cell (a mix whose ``entry`` is
``serve_conformer``) that its limits are set from, many seeds in one
process (no timed window), as ``calibrate_ctc.py`` reads the hybrid
Transformer's cell:

    python3 -m portbench.calibrate_conformer --cell <cell> \\
        --what sound,control,fault,ctc,offset --seeds 1,2,3 [--out <file>]

``sound``: the port as the configuration states it. ``control``: the
reference with fp8 products serves in the port's place, through its own
hybrid beam search over its own Conformer. ``fault``: a token of each
served batch altered where it is produced (``calibrate.alter_token``).
``ctc``: each hypothesis's CTC state does not follow its parent
(``calibrate_ctc.stale_ctc_state``). ``offset``: the port's relative-
position attention reads every position row one place off
(``shifted_positions``). Each reading serves one cycle of the mix's
batches, so the longest is served and sampled.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from . import manifest, traffic
from .calibrate import alter_token
from .calibrate_ctc import stale_ctc_state
from .harness import Context, free_device
from .reference.model import Precision

WHAT = ("sound", "control", "fault", "ctc", "offset")


@contextlib.contextmanager
def shifted_positions():
    """The port's relative-position attention
    (``kernels/interface.relpos_attention``, which ``models/conformer``
    calls) is handed the position rows one row on: query i and key j read
    the row of relative position i - j - 1 instead of i - j (the last row
    repeated)."""
    from speech_tranformer_pytorch_tpu_torch.kernels import interface

    real = interface.relpos_attention

    def off_by_one(q, k, v, p, *args, **kw):
        return real(q, k, v, torch.cat([p[1:], p[-1:]]), *args, **kw)

    interface.relpos_attention = off_by_one
    try:
        yield
    finally:
        interface.relpos_attention = real


def reading(ctx: Context, what: str) -> dict:
    from .drivers import serve_conformer

    if what not in WHAT:
        raise ValueError(f"unknown reading {what!r}; choose from {WHAT}")
    n = len(traffic.build_pool(ctx.mix, ctx.cfg, ctx.seed, train=False))
    vocab = ctx.cfg["model"]["vocab_size"]
    kw = {"control": dict(control=Precision("fp8")),
          "fault": dict(fault=lambda out: alter_token(out, vocab))}.get(what, {})
    patch = {"ctc": stale_ctc_state, "offset": shifted_positions}.get(
        what, contextlib.nullcontext)
    with patch():
        return serve_conformer.run(ctx, min_items=n, **kw).numbers


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--what", default=",".join(WHAT))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    files = manifest.context_files(manifest.load(), args.cell)
    dev = torch.device("cuda", 0)
    for what in args.what.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            ctx = Context(cell=args.cell, config=files["config"], mix=files["mix"],
                          limits=files["limits"], seed=seed, seconds=0.0, trace=False,
                          device=dev, t_start=time.perf_counter())
            t0 = time.perf_counter()
            line = json.dumps({"cell": args.cell, "what": what, "seed": seed,
                               "numbers": reading(ctx, what),
                               "seconds": time.perf_counter() - t0,
                               "card": torch.cuda.get_device_name(dev)})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
            free_device(dev)


if __name__ == "__main__":
    main()

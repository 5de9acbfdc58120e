"""Readings of a hybrid CTC/attention serving cell (a mix whose ``entry`` is
``serve_ctc``) that its limits are set from, many seeds in one process
(no timed window), as ``calibrate.py`` reads the other cells:

    python3 -m portbench.calibrate_ctc --cell <cell> \\
        --what sound,control,fault,prune,ctc --seeds 1,2,3 [--out <file>]

``sound``: the port as the configuration states it. ``control``: the
reference with fp8 products serves in the port's place, through its own
hybrid beam search. ``fault``: a token of each served batch altered where
it is produced (``calibrate.alter_token``). ``prune``: the port's prune
keeps the candidates ranked 2 to k2 + 1 (``calibrate.shifted_prune``; in
a hybrid search that prune is the pre-beam, which so loses each
hypothesis's best token by attention). ``ctc``: each hypothesis's CTC
state does not follow its parent (``stale_ctc_state``). Each reading
serves one cycle of the mix's batches, so the longest is served and
sampled.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from . import manifest, traffic
from .calibrate import alter_token, shifted_prune
from .harness import Context, free_device
from .reference.model import Precision

WHAT = ("sound", "control", "fault", "prune", "ctc")


@contextlib.contextmanager
def stale_ctc_state():
    """The beam search's gather of the chosen candidates' CTC states
    (``decoding/beam.ctc_carry``) takes each lane's own row instead of its
    parent's: ψ still follows the parent, the state it is extended from
    next does not."""
    from speech_tranformer_pytorch_tpu_torch.decoding import beam

    real = beam.ctc_carry

    def own_lane(psi, states, sel):
        k = sel.shape[1]
        n_pre = states.shape[1] // k
        lane = torch.arange(k, device=sel.device)[None, :] * n_pre + sel % n_pre
        return real(psi, states, sel)[0], real(psi, states, lane)[1]

    beam.ctc_carry = own_lane
    try:
        yield
    finally:
        beam.ctc_carry = real


def reading(ctx: Context, what: str) -> dict:
    from .drivers import serve_ctc

    if what not in WHAT:
        raise ValueError(f"unknown reading {what!r}; choose from {WHAT}")
    n = len(traffic.build_pool(ctx.mix, ctx.cfg, ctx.seed, train=False))
    vocab = ctx.cfg["model"]["vocab_size"]
    kw = {"control": dict(control=Precision("fp8")),
          "fault": dict(fault=lambda out: alter_token(out, vocab))}.get(what, {})
    patch = {"prune": shifted_prune, "ctc": stale_ctc_state}.get(what, contextlib.nullcontext)
    with patch():
        return serve_ctc.run(ctx, min_items=n, **kw).numbers


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

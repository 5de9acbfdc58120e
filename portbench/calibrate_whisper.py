"""Readings of a Whisper serving cell (a mix whose ``entry`` is
``serve_whisper``) that its limits are set from, many seeds in one process
(no timed window), as ``calibrate_conformer.py`` reads the Conformer's:

    python3 -m portbench.calibrate_whisper --cell <cell> \\
        --what sound,control,fault,prune,prompt --seeds 1,2,3 [--out <file>]

``sound``: the port as the configuration states it. ``control``: the
reference with fp8 products serves in the port's place, through its own
Whisper beam search. ``fault``: a token of each served batch altered
where it is produced (``calibrate.alter_token``). ``prune``: the port's
prune keeps the candidates ranked 2 to k2 + 1 (``calibrate.shifted_prune``).
``prompt``: the prompt's rows left out of the steps' self-attention
(``prompt_left_out``). Each reading serves one cycle of the mix's batches,
so the longest is served and sampled.
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

WHAT = ("sound", "control", "fault", "prune", "prompt")


@contextlib.contextmanager
def prompt_left_out():
    """The port's forced prompt steps (``beam.read_prompt``, which the beam
    search runs before its first step) do nothing: the prompt's self K/V
    rows keep the zeros the cache starts from, so every step attends to
    blank rows in their place and its queries never see the prompt."""
    from speech_tranformer_pytorch_tpu_torch.decoding import beam, beam_graph

    real = beam.read_prompt
    beam.read_prompt = beam_graph.read_prompt = lambda *args, **kw: None
    try:
        yield
    finally:
        beam.read_prompt = beam_graph.read_prompt = real


def reading(ctx: Context, what: str) -> dict:
    from .drivers import serve_whisper

    if what not in WHAT:
        raise ValueError(f"unknown reading {what!r}; choose from {WHAT}")
    n = len(traffic.build_pool(ctx.mix, ctx.cfg, ctx.seed, train=False))
    vocab = ctx.cfg["model"]["vocab_size"]
    kw = {"control": dict(control=Precision("fp8")),
          "fault": dict(fault=lambda out: alter_token(out, vocab))}.get(what, {})
    patch = {"prune": shifted_prune, "prompt": prompt_left_out}.get(
        what, contextlib.nullcontext)
    with patch():
        return serve_whisper.run(ctx, min_items=n, **kw).numbers


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

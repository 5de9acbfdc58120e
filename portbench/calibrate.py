"""Readings that the limits of ``limits/<cell>.json`` are set from, many
seeds in one process (no timed window):

    python3 -m portbench.calibrate --cell <cell> --what sound,control,fault \\
        --seeds 1,2,3 [--out <file>]

``sound``: the port as the configuration states it. ``control``: the
precision below the configuration's bfloat16 in the port's place: the
reference with fp8 products (``reference.model.Precision``); for serving
it runs its own beam search and scores its hypotheses. ``int8``
(serving): the port's own int8 path (int8 weights and cross-K/V,
dequantized into bf16 products), read for the record. ``fault``: for
serving a token of each served batch altered where it is produced; for
training half of each checked batch left out, the mean taken over the
rest (the fault of a step that returns its state unchanged reads 1 by
``harness.train_numbers``'s measure and needs no run). ``prune``
(serving): the port's beam prune keeps the candidates ranked 2 to k2 + 1
instead of 1 to k2 (``shifted_prune``). Serving runs one cycle of the
mix's batches, so the longest is served and sampled.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from . import manifest, traffic
from .harness import Context, free_device
from .reference.model import Precision

INT8 = {"decode.int8_weights": True, "decode.int8_kv_cache": True}


def alter_token(out, vocab: int):
    """Change one token of the best hypothesis of the first utterance (to
    the next regular id), leaving its score as the search gave it."""
    tokens, lengths, scores = out
    tokens = tokens.clone()
    n = int(lengths[0, 0])
    if n > 0:
        j = n // 2
        t = int(tokens[0, 0, j])
        tokens[0, 0, j] = traffic.FIRST_TOKEN + (t - traffic.FIRST_TOKEN + 1) % (vocab - traffic.FIRST_TOKEN)
    return tokens, lengths, scores


@contextlib.contextmanager
def shifted_prune():
    """The port's beam prune (``kernels/interface.beam_candidate_topk``,
    which ``decoding/beam`` calls) returns the candidates ranked 2 to
    k2 + 1: each kept hypothesis still scores its parent's score plus its
    token's log-probability, but the best extension is lost every step."""
    from speech_tranformer_pytorch_tpu_torch.kernels import interface

    real = interface.beam_candidate_topk

    def shifted(logits, alive_scores, *, k2, **kw):
        vals, idx = real(logits, alive_scores, k2=k2 + 1, **kw)
        return vals[:, 1:].contiguous(), idx[:, 1:].contiguous()

    interface.beam_candidate_topk = shifted
    try:
        yield
    finally:
        interface.beam_candidate_topk = real


def reading(ctx: Context, what: str) -> dict:
    if ctx.mix["entry"] == "serve":
        from .drivers import serve
        n = len(traffic.build_pool(ctx.mix, ctx.cfg, ctx.seed, train=False))
        vocab = ctx.cfg["model"]["vocab_size"]
        kw = {"control": dict(control=Precision("fp8")), "int8": dict(overrides=INT8),
              "fault": dict(fault=lambda out: alter_token(out, vocab))}.get(what, {})
        with shifted_prune() if what == "prune" else contextlib.nullcontext():
            return serve.run(ctx, min_items=n, **kw).numbers
    from .drivers import train
    state, step, pool, batches, losses, grad1, params_after = train.checked_steps(ctx)
    del state, step, batches
    free_device(ctx.device)
    if what == "sound":
        return train.check(ctx, pool, losses, grad1, params_after)
    if what == "control":
        return train.check(ctx, pool, None, None, None, pr=Precision("fp8"))
    return train.check(ctx, pool, None, None, None,
                       keep_rows=slice(0, ctx.mix["batch"] // 2))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--what", default="sound,control,fault")
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
            line = json.dumps({"cell": args.cell, "what": what, "seed": seed,
                               "numbers": reading(ctx, what),
                               "card": torch.cuda.get_device_name(dev)})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
            free_device(dev)


if __name__ == "__main__":
    main()

"""Run one cell of ``BENCHMARK.json`` once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and last ``checks``: each compared number beside its
limit); the compared numbers are also the last lines of standard error.
With ``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402

from . import guard   # noqa: E402


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cache_env(root: str) -> None:
    """Kernel caches of the libraries the port may use, inside the checkout
    at fixed paths (the port's own CUDA build lives in its package's
    ``build/``)."""
    base = os.path.join(root, ".portbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bad = guard.scan()
    if bad:
        fail("import guard: " + "; ".join(bad))
    from . import manifest
    cache_env(manifest.REPO)
    bench = manifest.load()
    files = manifest.context_files(bench, args.workload)
    chips = files["workload"]["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA card(s); "
             f"torch.cuda.is_available()={torch.cuda.is_available()}, "
             f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    torch.set_num_threads(min(4, torch.get_num_threads()))
    torch.cuda.init()
    print(f"portbench: torch and CUDA ready at {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr, flush=True)
    result = run_cell(bench, files, args, torch.device("cuda", 0), T_START)
    found = guard.loaded()
    if found:
        fail(f"modules of JAX or the JAX package were loaded: {found}")
    emit(result)


def run_cell(bench: dict, files: dict, args, device, t_start: float) -> dict:
    """Run the cell's driver and build the result (without printing it)."""
    import importlib

    import torch

    from . import metrics as readers
    from .harness import Context
    from .manifest import metrics_of

    ctx = Context(cell=args.workload, config=files["config"], mix=files["mix"],
                  limits=files["limits"], seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=device, t_start=t_start)
    driver = importlib.import_module(f"portbench.drivers.{ctx.mix['entry']}")
    record = driver.run(ctx)
    section = "per_layer" if ctx.trace else "end_to_end"
    values = {}
    for m in metrics_of(bench, args.workload, section):
        v = readers.reader(m["name"]).read(record, ctx)
        if v is None and section == "end_to_end" and device.type == "cuda":
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": files["workload"]["chips"], "memory_peak_bytes": record.peak_bytes}
    out = {"correct": record.correct(ctx.limits), "attempted": record.attempted,
           "failed": record.failed, "metrics": values, "device": dev}
    if record.trace is not None:
        dev["busy_s"] = record.trace.busy_s
        dev["window_s"] = record.trace.window_s
        out["breakdown"] = {"device_ops": record.trace.top_ops,
                            "idle_gaps": record.trace.idle_gaps}
    out["checks"] = record.checks(ctx.limits)
    return out


def emit(result: dict) -> None:
    for c in result["checks"]:
        print(f"check {c['name']} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

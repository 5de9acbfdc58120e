"""Run cells of the benchmark several times, each run a process of its
own as the check runs them, and keep every run's output:

    python3 -m portbench.series --out <dir> \\
        base.serve.aishell-b8:101:30:0 base.serve.aishell-b8:102:30:0 ...

Each argument is ``cell:seed:seconds:trace``. For each run the last line
of standard output (the result) and the end of standard error are written
to ``<out>/<n>-<cell>-<seed>-<trace>.json``, and one summary line a run to
``<out>/summary.jsonl``; the card's name and power limit come first. Before
each run the host's state is read (``host_state``), so that runs which
differ can be told apart by what the host and the card were doing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def host_state() -> dict:
    """A fixed pure-Python loop timed on this host (it slows when other
    work takes the cores), the load average, and the card's clocks,
    temperature, power and active throttle reasons."""
    t = time.perf_counter()
    sum(i * i for i in range(3_000_000))
    probe = time.perf_counter() - t
    with open("/proc/loadavg", encoding="utf-8") as f:
        load = f.read().split()[:3]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,power.draw,"
             "clocks_throttle_reasons.active", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        card = f"nvidia-smi failed: {e}"
    return {"host_probe_s": probe, "loadavg": load, "card": card}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.jsonl"), "a", encoding="utf-8") as summary:
        print(json.dumps({"card": smi()}), file=summary, flush=True)
        for n, spec in enumerate(args.runs):
            short = run_one(args.out, n, spec)
            print(json.dumps(short), file=summary, flush=True)
            print(json.dumps(short), flush=True)


def run_one(out: str, n: int, spec: str) -> dict:
    """Run ``cell:seed:seconds:trace`` once; keep its record; return a summary."""
    cell, seed, seconds, trace = spec.split(":")
    cmd = [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", seed,
           "--seconds", seconds, "--trace", trace]
    before = host_state()
    t = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    wall = time.perf_counter() - t
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    rec = {"cell": cell, "seed": int(seed), "seconds": float(seconds), "trace": int(trace),
           "rc": p.returncode, "wall_s": wall, "before": before, "result": result,
           "stderr_tail": p.stderr[-6000:]}
    with open(os.path.join(out, f"{n:03d}-{cell}-{seed}-{trace}.json"), "w",
              encoding="utf-8") as f:
        json.dump(rec, f, indent=1)
    short = {k: rec[k] for k in ("cell", "seed", "trace", "rc", "wall_s", "before")}
    if result:
        short.update(correct=result.get("correct"), attempted=result.get("attempted"),
                     metrics={k: v["value"] for k, v in result.get("metrics", {}).items()},
                     checks={c["name"]: c["value"] for c in result.get("checks", [])},
                     busy_s=result["device"].get("busy_s"),
                     window_s=result["device"].get("window_s"),
                     peak=result["device"].get("memory_peak_bytes"))
    else:
        short["stderr_tail"] = p.stderr[-1500:]
    return short


if __name__ == "__main__":
    main()

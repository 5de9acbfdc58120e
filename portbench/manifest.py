"""``BENCHMARK.json`` and the files it names: loading and validation."""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List

from . import metrics
from .harness import ROOT, load_json

REPO = os.path.dirname(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(path: str = None) -> dict:
    with open(path or os.path.join(REPO, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                   f"there are {[w['name'] for w in bench['workloads']]}")


def config_entry(bench: dict, name: str) -> dict:
    return next(c for c in bench["configs"] if c["name"] == name)


def metrics_of(bench: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` a cell reports: those that list it, and
    those without ``workloads`` in every cell that reports their ``moves``
    (end-to-end: every cell)."""
    out = []
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end":
            out.append(m)
        elif cell in e2e[m["moves"]].get("workloads", [cell]):
            out.append(m)
    return out


def validate(bench: dict) -> List[str]:
    """Problems of the manifest against the shape it must have, the files it
    names and the readers' own declarations (an empty list when sound)."""
    errs = []
    names = set()
    cells = {w["name"] for w in bench["workloads"]}
    for c in bench["configs"]:
        if not NAME.match(c["name"]):
            errs.append(f"bad config name {c['name']!r}")
        if not os.path.exists(os.path.join(REPO, c["file"])):
            errs.append(f"config file {c['file']} missing")
        for k in c["reduced"]:
            if not NAME.match(k):
                errs.append(f"bad reduced key {k!r}")
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        if not NAME.match(w["name"]) or not NAME.match(w["traffic"]):
            errs.append(f"bad workload or traffic name in {w}")
        if w["config"] not in configs:
            errs.append(f"{w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            errs.append(f"{w['name']}: chips {w['chips']}")
        if not 1 <= len(w["why"]) <= 200 or "\n" in w["why"]:
            errs.append(f"{w['name']}: why has {len(w['why'])} characters")
        for part, folder in (("traffic", "mixes"), ("name", "limits")):
            if not os.path.exists(os.path.join(ROOT, folder, f"{w[part]}.json")):
                errs.append(f"{w['name']}: no {folder}/{w[part]}.json")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        errs.append("no setup_s")
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            if m["name"] in names:
                errs.append(f"metric {m['name']} twice")
            names.add(m["name"])
            if not NAME.match(m["name"]) or not UNIT.match(m["unit"]):
                errs.append(f"bad name or unit in {m}")
            for c in m.get("workloads", []):
                if c not in cells:
                    errs.append(f"{m['name']}: unknown workload {c}")
            mod = metrics.reader(m["name"])
            want = {"unit": mod.UNIT, "better": mod.BETTER, "source": mod.SOURCE}
            if section == "per_layer":
                want.update(layer=mod.LAYER, moves=mod.MOVES)
                if mod.KIND != "per_layer":
                    errs.append(f"{m['name']}: its reader is {mod.KIND}")
                mv = e2e.get(m["moves"])
                if mv is None:
                    errs.append(f"{m['name']}: moves unknown {m['moves']}")
                else:
                    reach = mv.get("workloads", sorted(cells))
                    for c in m.get("workloads", reach):
                        if c not in reach:
                            errs.append(f"{m['name']}: cell {c} does not report {m['moves']}")
            elif mod.KIND != "end_to_end":
                errs.append(f"{m['name']}: its reader is {mod.KIND}")
            for k, v in want.items():
                if m.get(k) != v:
                    errs.append(f"{m['name']}: {k} {m.get(k)!r} but its reader says {v!r}")
    for w in bench["workloads"]:
        if not any(m["name"] != "setup_s" for m in metrics_of(bench, w["name"], "end_to_end")):
            errs.append(f"{w['name']}: no end-to-end metric besides setup_s")
        if not metrics_of(bench, w["name"], "per_layer"):
            errs.append(f"{w['name']}: no per-layer metric")
    return errs


def context_files(bench: dict, cell: str) -> Dict[str, dict]:
    w = workload(bench, cell)
    c = config_entry(bench, w["config"])
    with open(os.path.join(REPO, c["file"]), encoding="utf-8") as f:
        config = json.load(f)
    return {"workload": w, "config": config, "mix": load_json("mixes", f"{w['traffic']}.json"),
            "limits": load_json("limits", f"{w['name']}.json")}

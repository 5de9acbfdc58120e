"""BENCHMARK.json checked against the shape it must have, and a cell, a
configuration and a metric added as new files only, found by name."""

import json
import os
import shutil
import subprocess
import sys

from portbench import manifest
from portbench.harness import ROOT


def test_the_manifest_is_sound():
    bench = manifest.load()
    assert manifest.validate(bench) == []
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    bench = manifest.load()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(bench, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in manifest.metrics_of(bench, w["name"], "per_layer"):
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_bad_names_and_moves_are_found():
    bench = manifest.load()
    copy = dict(bench["workloads"][0], name="base.serve.copy")
    bench["workloads"].append(copy)
    bench["per_layer"][0]["workloads"] = ["base.serve.aishell-b8", "base.serve.copy"]
    bench["end_to_end"][1]["unit"] = "audio seconds"
    errs = manifest.validate(bench)
    assert any("does not report" in e for e in errs)
    assert any("bad name or unit" in e for e in errs)


def test_new_files_alone_add_a_cell_a_configuration_and_a_metric(tmp_path):
    shutil.copytree(ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = manifest.load()
    pb = tmp_path / "portbench"
    conf = json.loads((pb / "configs" / "base.json").read_text())
    conf["name"] = "base_wide"
    conf["config"]["model"]["d_ff"] = 4096
    (pb / "configs" / "base_wide.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "mixes" / "serve.aishell-b8.json").read_text())
    mix["batch"] = 4
    (pb / "mixes" / "serve.aishell-b4.json").write_text(json.dumps(mix))
    (pb / "limits" / "base_wide.serve.aishell-b4.json").write_text('{"score_gap_mean": 0.1}')
    (pb / "metrics" / "serve.calls.py").write_text(
        'UNIT, BETTER, SOURCE, KIND = "count", "higher", "host_clock", "per_layer"\n'
        'LAYER, MOVES = "entry (recognize.Recognizer)", "serve_audio_s_per_s"\n'
        'def read(record, ctx):\n    return float(len(record.items))\n')
    bench["configs"].append({"name": "base_wide", "source": "x", "reduced": ["d_ff"],
                             "file": "portbench/configs/base_wide.json", "why": "x"})
    bench["workloads"].append({"name": "base_wide.serve.aishell-b4", "config": "base_wide",
                               "traffic": "serve.aishell-b4", "chips": 1, "why": "x"})
    bench["end_to_end"][1]["workloads"].append("base_wide.serve.aishell-b4")
    bench["per_layer"].append({"name": "serve.calls", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "entry (recognize.Recognizer)",
                               "moves": "serve_audio_s_per_s",
                               "workloads": ["base_wide.serve.aishell-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from portbench import manifest, metrics\n"
            "b = manifest.load(); print(manifest.validate(b))\n"
            "f = manifest.context_files(b, 'base_wide.serve.aishell-b4')\n"
            "print(f['config']['config']['model']['d_ff'], f['mix']['batch'], f['limits'])\n"
            "print([m['name'] for m in manifest.metrics_of(b, 'base_wide.serve.aishell-b4', 'per_layer')])\n"
            "print(metrics.reader('serve.calls').read(type('R', (), {'items': [1, 2]})(), None))\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path) + os.pathsep + os.path.dirname(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "[]"
    assert lines[1] == "4096 4 {'score_gap_mean': 0.1}"
    assert "serve.calls" in lines[2]
    assert lines[3] == "2.0"

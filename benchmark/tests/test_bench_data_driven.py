"""The harness finds cells, configurations and metrics by their files: a
new one is a new file and no other file changes. And BENCHMARK.json's
names and units use only the characters allowed."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def listing(root):
    out = subprocess.run([sys.executable, os.path.join(root, "run.py"),
                          "--list"], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_files_are_found_with_nothing_else_changed(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    wl = json.loads((copy / "workloads" / "pbmc3k.cd-grid.json").read_text())
    wl.update(config="pbmc3k_deep", consensus_k=11)
    (copy / "workloads" / "pbmc3k_deep.cd-k11.json").write_text(
        json.dumps(wl))
    cfg = json.loads((copy / "configs" / "pbmc3k.json").read_text())
    cfg["name"] = "pbmc3k_deep"
    (copy / "configs" / "pbmc3k_deep.json").write_text(json.dumps(cfg))
    (copy / "metrics" / "solvers.mean_sweeps.py").write_text(
        "def read(run):\n    return None\n")
    found = listing(str(copy))
    assert "pbmc3k_deep.cd-k11" in found["workloads"]
    assert "pbmc3k_deep" in found["configs"]
    assert "solvers.mean_sweeps" in found["metrics"]
    after = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert {p: b for p, b in after.items() if p in before} == before


def test_every_entry_of_benchmark_json_has_its_files():
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    found = listing(HERE)
    assert {c["name"] for c in bench["configs"]} <= set(found["configs"])
    assert {w["name"] for w in bench["workloads"]} <= set(found["workloads"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert {m["name"] for m in metrics} <= set(found["metrics"])


def test_benchmark_json_names_and_units():
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    names = [e["name"] for group in ("configs", "workloads", "end_to_end",
                                     "per_layer") for e in bench[group]]
    names += [w["config"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    bad = [n for n in names if not NAME.match(n)]
    assert not bad
    units = [m["unit"] for g in ("end_to_end", "per_layer") for m in bench[g]]
    assert all(UNIT.match(u) for u in units), units
    assert len(set(names[:len(bench["configs"]) + len(bench["workloads"])
                         + len(bench["end_to_end"])
                         + len(bench["per_layer"])])) == (
        len(bench["configs"]) + len(bench["workloads"])
        + len(bench["end_to_end"]) + len(bench["per_layer"]))

"""Where the benchmark finds its parts, by the names in BENCHMARK.json.

* ``configs/<config>.json``: a configuration's shapes, source, assumed
  sizes and cuts;
* ``workloads/<cell>.json``: a cell's traffic (its configuration, loss, K
  grid, restarts, iteration limit, consensus K and threshold), how much of
  a run the output check samples, and each compared number's limit;
* ``metrics/<metric>.py``: one reader a metric (``read(run)``: a number, or
  None where the run holds nothing to read);
* ``work/<loss>.py``: the work model the roofline shares count with.

A new cell, configuration, metric or loss is a new file; no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
KINDS = {"configs": ".json", "workloads": ".json", "metrics": ".py",
         "work": ".py"}


def _path(kind: str, name: str) -> str:
    return os.path.join(HERE, kind, name + KINDS[kind])


def listing(root: str = HERE) -> dict:
    """The names of each kind's files under ``root``."""
    out = {}
    for kind, ext in KINDS.items():
        folder = os.path.join(root, kind)
        names = (sorted(f[:-len(ext)] for f in os.listdir(folder)
                        if f.endswith(ext) and not f.startswith("_"))
                 if os.path.isdir(folder) else [])
        out[kind] = names
    return out


def load_json(kind: str, name: str) -> dict:
    with open(_path(kind, name)) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        _path(kind, name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(name: str) -> dict:
    """A cell's workload with its configuration under ``"cfg"``."""
    wl = load_json("workloads", name)
    return dict(wl, name=name, cfg=load_json("configs", wl["config"]))


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of the cell reports: the end-to-end ones untraced,
    the per-layer ones traced, each where its ``workloads`` names the cell
    or where it names none."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]

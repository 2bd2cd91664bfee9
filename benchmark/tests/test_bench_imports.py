"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program. Each check runs in a fresh
interpreter and compares the top-level name of every loaded module whole
(the port's name begins with the JAX package's)."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "cnmf_tpu"}

LOAD_ALL = """
import glob, json, os, sys
sys.path[:0] = [{here!r}, {repo!r}]
import run
from benchkit import cells, check, generate, job, peaks, trace
from benchkit.reference import consensus, prepare, solvers, threefry
import cnmf_tpu_torch.pipeline.stages, cnmf_tpu_torch.ops.device_densify
for kind in ("metrics", "work"):
    for name in cells.listing()[kind]:
        cells.load_module(kind, name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys
sys.path[:0] = [{here!r}]
from benchkit.reference import consensus, prepare, solvers, threefry
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_names(code):
    env = dict(os.environ, USE_FLAX="0", USE_JAX="0")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code.format(here=HERE,
                                                           repo=REPO)],
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    names = top_level_names(LOAD_ALL)
    assert "cnmf_tpu_torch" in names      # the program is loaded ...
    assert not names & FORBIDDEN          # ... and nothing of JAX's


def test_reference_loads_nothing_of_the_program():
    names = top_level_names(LOAD_REFERENCE)
    assert not names & (FORBIDDEN | {"cnmf_tpu_torch"})


@pytest.mark.parametrize("name, hit", [
    ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True),
    ("cnmf_tpu.ops", True), ("cnmf_tpu_torch.ops", False),
    ("jaxtyping", False)])
def test_forbidden_names_are_whole_top_level_names(name, hit, monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, name, object())
    assert bool(run.forbidden_modules()) == hit

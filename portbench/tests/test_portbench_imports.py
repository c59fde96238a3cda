"""No module that the harness or the reference loads has ``jax``, ``jaxlib``,
``flax`` or the JAX package as its top-level name (compared whole: the port's
name begins with the JAX package's), and the reference loads nothing of the port."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import REPO

FORBIDDEN = ["jax", "jaxlib", "flax", "kddcup_2020_multimodalitiesrecall_2nd_place_tpu"]
PORT = "kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch"


def _top_level(code: str) -> set[str]:
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "HOME": str(REPO)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_port():
    mods = _top_level("import portbench.reference.models, portbench.reference.train, portbench.reference.featurize, "
                      "portbench.reference.tokenizer, portbench.reference.judge, portbench.reference.lowp")
    assert not mods & set(FORBIDDEN) and PORT not in mods


def test_a_whole_cpu_run_of_each_cell_loads_no_jax():
    code = f"""
import sys, tempfile, time
sys.path.insert(0, {str(REPO / 'portbench' / 'tests')!r})
from conftest import tiny_run, run_tiny
import portbench.run, portbench.control
from portbench import harness
for cell in ("imagebert_a.score_tsv", "imagebert_b.train_packed"):
    for trace in (False, True):
        run = tiny_run(cell, tempfile.mkdtemp())
        run.trace = trace
        assert run_tiny(run)["correct"]
    for m in harness.load_benchmark()["per_layer"]:
        harness.load_reader(m["name"])
assert not harness.forbidden_modules(), harness.forbidden_modules()
"""
    mods = _top_level(code)
    assert PORT in mods and not mods & set(FORBIDDEN)


def test_the_check_compares_whole_top_level_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, PORT + "_probe", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]

"""The import audit: what the benchmark's command loads has no module whose
top-level name is `jax`, `jaxlib`, `flax` or `cvids_tpu` (compared whole:
the port's `cvids_tpu_torch` begins with the JAX package's name), and the
references load nothing of the port."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "cvids_tpu"}


def loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    top = loaded_after(
        "import torch; torch.set_num_threads(2)\n"
        "import benchmark.run\nfrom benchmark import harness\nfrom benchmark.tests import tiny\n"
        "harness.run_cell(harness.load_benchmark(), 'server4_euroc752.dense_backlog', 3, 4.0, "
        "False, device='cpu', config_patch=tiny.patch)\n"
        "assert harness.forbidden_modules() == []")
    assert "cvids_tpu_torch" in top
    assert not top & FORBIDDEN


def test_the_references_load_nothing_of_the_port():
    top = loaded_after("import benchmark.reference.dense, benchmark.reference.tsdf, "
                       "benchmark.reference.posegraph")
    assert "cvids_tpu_torch" not in top and not top & FORBIDDEN
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN | {"cvids_tpu_torch"}, (path, name)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "cvids_tpu_torch_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cvids_tpu.server", sys)
    assert harness.forbidden_modules() == ["cvids_tpu"]

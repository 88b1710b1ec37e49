"""The port's packages bind the same submodules as the reference's.

`import cvids_tpu.server` leaves `cvids_tpu.server.pipeline` bound, because
the reference's `__init__`s import their modules; code written against
those attribute paths must work on the port too. For the top-level package
and every subpackage that both packages have, a fresh process imports it
and lists the submodules bound on it; the port's list must equal the
reference's, and the port's process must have loaded no module of jax or
of `cvids_tpu`.
"""

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SUBPACKAGES = ("", "camera", "dense", "geometry", "io", "mapping", "native", "ops",
               "parallel", "server", "utils", "vio")

_LIST = """
import importlib, json, sys, types
m = importlib.import_module(sys.argv[1])
print(json.dumps({
    "bound": sorted(k for k, v in vars(m).items()
                    if isinstance(v, types.ModuleType) and v.__name__ == m.__name__ + "." + k),
    "reference": sorted(x for x in sys.modules if x.split(".")[0] in ("jax", "cvids_tpu")),
}))
"""


def _listing(module: str) -> dict:
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", _LIST, module], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT), env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def listings():
    """Both packages' listings of every subpackage, each from its own fresh
    process (a few at a time: each reference process imports jax)."""
    names = [f"{pkg}.{sub}".rstrip(".") for sub in SUBPACKAGES
             for pkg in ("cvids_tpu", "cvids_tpu_torch")]
    with ThreadPoolExecutor(4) as ex:
        return dict(zip(names, ex.map(_listing, names)))


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top")
def test_bound_submodules_match_the_reference(listings, sub):
    ref = listings[f"cvids_tpu.{sub}".rstrip(".")]
    port = listings[f"cvids_tpu_torch.{sub}".rstrip(".")]
    assert port["bound"] == ref["bound"]
    assert port["reference"] == [], f"the port loaded {port['reference']}"

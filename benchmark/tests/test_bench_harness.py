"""The harness on the CPU at a size a test can hold (`tiny.patch`): cells,
configurations and metrics found by name, the result line, the control and
the faults that must come out not correct, and a cell added by files alone.
On a card (`cuda` marker) one short run of each cell through the command."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 33 + 11
DENSE = "server4_rs640.dense_backlog"
EUROC = "server4_euroc752.dense_backlog"
POSE = "server4_rs640.posegraph_backlog"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_run(cell, control=False, seconds=5.0):
    return harness.run_cell(harness.load_benchmark(), cell, SEED, seconds, False, device="cpu",
                            control=control, config_patch=tiny.patch)


def test_cell_configuration_and_metrics_found_by_name():
    bench = harness.load_benchmark()
    cell, config, traffic = harness.cell_files(bench, EUROC)
    assert config["name"] == "server4_euroc752" and config["camera"]["width"] == 752
    assert traffic["driver"] == "closed_loop" and traffic["images"]
    e2e = [m["name"] for m in harness.cell_metrics(bench, cell, "end_to_end")]
    assert e2e == ["server_kf_per_s", "setup_s"]
    layer = [m["name"] for m in harness.cell_metrics(bench, cell, "per_layer")]
    assert "remap_ms" in layer and "dense_device_ms" in layer
    pose = harness.cell_metrics(bench, harness.cell_files(bench, POSE)[0], "per_layer")
    assert [m["name"] for m in pose] == ["server_kf_p95_ms", "ingest_ms", "device_idle_share"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_result_line_keys_and_checks_last():
    result, lines = tiny_run(DENSE)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True, lines
    assert set(result["metrics"]) == {"server_kf_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert lines[0].startswith("window: ") and lines[1].startswith("tail: ")
    assert len(lines) == len(result["checks"]) + 2
    assert all(ln.startswith("check ") for ln in lines[2:])
    assert result["checks"]["dense_cycles_checked"]["value"] >= 1


@pytest.mark.parametrize("cell", [DENSE, EUROC, POSE])
def test_control_is_not_correct(cell):
    result, lines = tiny_run(cell, control=True)
    assert result["correct"] is False, lines


def _fault(name, monkeypatch):
    from cvids_tpu_torch.dense import estimator
    from cvids_tpu_torch.server import pipeline, posegraph
    if name == "state_unchanged_dense":
        monkeypatch.setattr(estimator.DenseStep, "fuse", lambda self, *a, **k: self.state)
    elif name == "state_unchanged_loops":
        monkeypatch.setattr(posegraph.CollaborativePoseGraph, "_accept_loop",
                            lambda self, *a, **k: None)
    elif name == "half_left_out":
        real = pipeline.CollaborativeServer._process_one

        def every_other(self, pkt):     # every other round of the agents' keyframes
            self._n_seen = getattr(self, "_n_seen", 0) + 1
            if self._n_seen < 80 or (self._n_seen // 4) % 2 == 0:
                return real(self, pkt)
            return None
        monkeypatch.setattr(pipeline.CollaborativeServer, "_process_one", every_other)
    elif name == "loop_edge_altered":
        real = posegraph.CollaborativePoseGraph._record_loop

        def altered(self, i, j, edge, inter):
            edge = dict(edge, t_ij=edge["t_ij"] + 0.05)
            return real(self, i, j, edge, inter)
        monkeypatch.setattr(posegraph.CollaborativePoseGraph, "_record_loop", altered)
    elif name == "solve_unchanged":      # every 4-DoF solve returns the poses it was given
        from cvids_tpu_torch.server import optimizer
        monkeypatch.setattr(optimizer, "optimize_pose_graph_graphed",
                            lambda nodes, edges, *a, **k: nodes)
    elif name == "depth_altered":
        real = estimator.finalize
        monkeypatch.setattr(estimator, "finalize",
                            lambda cfg, st, *a: (lambda mu, ok: (mu * 1.01, ok))(*real(cfg, st, *a)))


@pytest.mark.parametrize("cell,fault", [
    (DENSE, "state_unchanged_dense"), (DENSE, "half_left_out"), (DENSE, "loop_edge_altered"),
    (DENSE, "depth_altered"), (DENSE, "solve_unchanged"), (POSE, "state_unchanged_loops"),
    (POSE, "half_left_out"), (POSE, "loop_edge_altered"), (POSE, "solve_unchanged")])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    _fault(fault, monkeypatch)
    result, lines = tiny_run(cell)
    assert result["correct"] is False, (fault, lines)


def test_a_cell_needs_only_new_files(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as files and
    entries to a copy of the benchmark, with no file of it edited, run."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/server4_rs640.json").read_text())
    cfg.update(name="server3_rs640", agents=3)
    (tmp_path / "benchmark/configs/server3_rs640.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "benchmark/traffic/posegraph_backlog.json").read_text())
    traffic["steps_per_sweep"] = 24
    (tmp_path / "benchmark/traffic/short_sweeps.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark/metrics/server_kf_p50_ms.py").write_text(
        "import numpy as np\n\n\ndef read(run):\n"
        "    return float(np.median(run.window.latencies_s)) * 1e3\n")
    bench["configs"].append(dict(bench["configs"][0], name="server3_rs640",
                                 file="benchmark/configs/server3_rs640.json"))
    bench["workloads"].append({"name": "server3_rs640.short_sweeps", "config": "server3_rs640",
                               "traffic": "short_sweeps", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "server_kf_p50_ms", "unit": "ms", "better": "lower",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["server3_rs640.short_sweeps"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, torch; torch.set_num_threads(2)\n"
            "from benchmark import harness\nfrom benchmark.tests import tiny\n"
            "r, _ = harness.run_cell(harness.load_benchmark(), 'server3_rs640.short_sweeps', 5, 2.0,"
            " False, device='cpu', config_patch=tiny.patch)\nprint(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert "server_kf_p50_ms" in result["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [DENSE, EUROC, POSE])
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
                          str(SEED), "--seconds", "5", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True, out.stderr[-3000:]

"""The readers of the dense reference roll's spans: found by name in the two
dense cells and not in the pose graph's, a value from spans by hand, an
eager roll counted as not replayed, and nothing (not an error) on a program
that records no roll span."""

from types import SimpleNamespace

import pytest

from benchmark import harness

DENSE = "server4_rs640.dense_backlog"
EUROC = "server4_euroc752.dense_backlog"
POSE = "server4_rs640.posegraph_backlog"
ROLL_METRICS = ["roll_ms", "roll_graphed_share"]
# what a window's spans read as: (total seconds, calls)
SPANS = {"ingest": (0.8, 100), "depth": (0.5, 100), "fuse": (0.3, 20), "roll": (0.04, 20),
         "roll_graph": (0.01, 20), "depth_sync": (0.1, 500)}
BY_HAND = {"roll_ms": 2.0, "roll_graphed_share": 1.0}


@pytest.mark.parametrize("cell", [DENSE, EUROC, POSE])
def test_dense_cells_list_the_roll_metrics(cell):
    bench = harness.load_benchmark()
    names = {m["name"] for m in harness.cell_metrics(bench, harness.cell_files(bench, cell)[0],
                                                     "per_layer")}
    if cell == POSE:
        assert not names & set(ROLL_METRICS)
    else:
        assert names >= set(ROLL_METRICS)
    for m in bench["per_layer"]:
        if m["name"] in ROLL_METRICS:
            assert (m["source"], m["layer"], m["moves"]) == ("program_span", "dense",
                                                             "server_kf_per_s")


@pytest.mark.parametrize("name", ROLL_METRICS)
def test_roll_metric_by_hand(name):
    assert harness.reader(name)(SimpleNamespace(spans=dict(SPANS))) == pytest.approx(BY_HAND[name])


def test_one_eager_roll_lowers_the_graphed_share():
    spans = dict(SPANS, roll=(0.05, 21))
    assert harness.reader("roll_graphed_share")(SimpleNamespace(spans=spans)) == \
        pytest.approx(20 / 21)
    eager = {k: v for k, v in SPANS.items() if k != "roll_graph"}
    assert harness.reader("roll_graphed_share")(SimpleNamespace(spans=eager)) == 0.0


@pytest.mark.parametrize("name", ROLL_METRICS)
def test_roll_metric_absent_on_a_program_without_the_spans(name):
    run = SimpleNamespace(spans={"ingest": (0.8, 100), "depth": (0.5, 100),
                                 "remap": (0.1, 100), "fuse": (0.2, 10)})
    assert harness.reader(name)(run) is None

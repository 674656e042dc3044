"""The reader of the program's ``edge_graph_replays`` counter
(``portbench/metrics/edge_graph_replays.py``), on the synthetic span log
of ``test_portbench_program_spans``: 2.0 a recording where each ``solve``
carries the counter at 2, and nothing where the program has no such
counter."""

import pytest

from portbench.harness import program_spans
from portbench.harness.manifest import Manifest
from portbench.tests._support import REPO
from portbench.tests.test_portbench_program_spans import ITERATION, _counts, _run


@pytest.mark.parametrize("edges", [2, None], ids=["counted", "absent"])
def test_edge_graph_replays_reads_the_counter(monkeypatch, edges):
    attrs = _counts(graph_replays=ITERATION - 1, graph_cache_hits=1, host_copies=1, k2_launches=ITERATION)
    if edges is not None:
        attrs["edge_graph_replays"] = edges
    run, _ = _run(monkeypatch=monkeypatch, solve_attrs=attrs)
    got = Manifest(REPO).reader("edge_graph_replays").read(run)
    assert got == (None if edges is None else 2.0)
    # the other readers read as before either way
    assert program_spans.mean_count(run, "host_copies") == 4.0

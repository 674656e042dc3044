"""The reader of the program's ``k5_launches`` counter
(``portbench/metrics/k5_launches.py``), on the synthetic span log of
``test_portbench_program_spans``: 251.0 a recording where each ``solve``
carries the counter at 251 (four launches an iteration and one a loss) and
the frontend's spans at 0, and nothing where the program has no such
counter."""

import pytest

from portbench.harness import program_spans
from portbench.harness.manifest import Manifest
from portbench.tests._support import REPO
from portbench.tests.test_portbench_program_spans import ITERATION, _counts, _run

LAUNCHES = 5 * ITERATION + 1


@pytest.mark.parametrize("launches", [LAUNCHES, None], ids=["counted", "absent"])
def test_k5_launches_reads_the_counter(monkeypatch, launches):
    attrs = _counts(graph_replays=ITERATION - 1, graph_cache_hits=1, host_copies=1, k1_launches=ITERATION)
    if launches is not None:
        attrs["k5_launches"] = launches
    run, spans = _run(monkeypatch=monkeypatch, solve_attrs=attrs)
    if launches is not None:
        # the program reports the counter in every top-level span: no change outside solve
        for s in spans:
            if s.parent is None and s.name != "solve":
                s.attrs["k5_launches"] = 0
    got = Manifest(REPO).reader("k5_launches").read(run)
    assert got == (None if launches is None else float(LAUNCHES))
    # the other readers read as before either way
    assert program_spans.mean_count(run, "host_copies") == 4.0
    assert program_spans.mean_count(run, "k1_launches") == float(ITERATION)

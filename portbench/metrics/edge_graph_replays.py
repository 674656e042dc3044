"""``edge_graph_replays``: the program's ``edge_graph_replays`` counter
(each replay of a solver call's init or finalize graph: 2 a call that
captures its edges, 0 otherwise), summed over its top-level spans, a
profiled recording (:mod:`portbench.harness.program_spans`).  A program
without the counter gives nothing to read."""

from portbench.harness.program_spans import mean_count


def read(run):
    return mean_count(run, "edge_graph_replays")

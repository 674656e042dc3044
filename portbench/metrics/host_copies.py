"""``host_copies``: the program's ``host_copies`` counter (each transfer
between the host and the card at the program's own sites: the mixture,
the windows, the solver's losses), summed over its top-level spans, a
profiled recording (:mod:`portbench.harness.program_spans`)."""

from portbench.harness.program_spans import mean_count


def read(run):
    return mean_count(run, "host_copies")

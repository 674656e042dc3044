"""``k4_launches``: the program's ``k4_launches`` counter (each launch of
kernel K4, FastMNMF's row sweep and per-bin power normalisation: one an
iteration where it engages, 50 a 50-iteration call), summed over its
top-level spans, a profiled recording
(:mod:`portbench.harness.program_spans`).  A program without the counter
gives nothing to read."""

from portbench.harness.program_spans import mean_count


def read(run):
    return mean_count(run, "k4_launches")

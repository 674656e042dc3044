"""``k5_launches``: the program's ``k5_launches`` counter (each launch of
kernel K5, FastMNMF's MU sweeps, K1's weights and the NLL's fit with the
model formed inside them: four an iteration and one a loss where it
engages, 251 a 50-iteration call), summed over its top-level spans, a
profiled recording (:mod:`portbench.harness.program_spans`).  A program
without the counter gives nothing to read."""

from portbench.harness.program_spans import mean_count


def read(run):
    return mean_count(run, "k5_launches")

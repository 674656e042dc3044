"""``k3_launches``: the program's ``k3_launches`` counter (each launch of
kernel K3, the batched Hermitian eigensolver: three an iteration of
Sawada's spatial update at C >= 3, one for each matrix power of the
Riccati solve, 150 a 50-iteration call), summed over its top-level spans,
a profiled recording (:mod:`portbench.harness.program_spans`).  A program
without the counter gives nothing to read."""

from portbench.harness.program_spans import mean_count


def read(run):
    return mean_count(run, "k3_launches")

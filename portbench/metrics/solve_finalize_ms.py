"""``solve_finalize_ms``: the program's ``solve.finalize`` span (the last
publish, ``finalize`` with projection-back, the whole output), ms a
profiled recording (:mod:`portbench.harness.program_spans`)."""

from portbench.harness.program_spans import mean_ms


def read(run):
    return mean_ms(run, "solve.finalize")

"""``solve_init_ms``: the program's ``solve.init`` span (the solver's
input, its host draws, ``init_state``, the first publish and the initial
loss), ms a profiled recording (:mod:`portbench.harness.program_spans`)."""

from portbench.harness.program_spans import mean_ms


def read(run):
    return mean_ms(run, "solve.init")

"""``solve_eager_step_ms``: the program's ``solve.eager_step`` span (the
eager first iteration, its loss, the graph's lookup and load) less its
``solve.capture`` child, ms a profiled recording
(:mod:`portbench.harness.program_spans`)."""

from portbench.harness.program_spans import mean_ms


def read(run):
    return mean_ms(run, "solve.eager_step", less="solve.capture")

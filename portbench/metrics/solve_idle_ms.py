"""``solve_idle_ms``: each of the program's ``solve`` spans less the part
of it in which the card ran a kernel, copy or fill, ms a profiled
recording: the card's idle time that the solver call is to blame for, on
the profiler's clock (:mod:`portbench.harness.program_spans`)."""

from portbench.harness.program_spans import solve_idle_ms


def read(run):
    return solve_idle_ms(run)

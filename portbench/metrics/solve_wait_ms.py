"""``solve_wait_ms``: the program's ``solve.wait`` span, the losses' one
transfer to the host, where the host waits for the card, ms a profiled
recording (:mod:`portbench.harness.program_spans`)."""

from portbench.harness.program_spans import mean_ms


def read(run):
    return mean_ms(run, "solve.wait")

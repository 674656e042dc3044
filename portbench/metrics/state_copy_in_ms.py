"""``state_copy_in_ms``: the program's ``solve.state_copy_in`` spans, the
copies of a solver's drawn or warm-start state from the host (pageable
memory) inside ``solve.init``, ms a profiled recording
(:mod:`portbench.harness.program_spans`).  A program without the span gives
nothing to read."""

from portbench.harness.program_spans import mean_ms


def read(run):
    return mean_ms(run, "solve.state_copy_in")

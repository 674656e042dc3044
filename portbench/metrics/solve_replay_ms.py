"""``solve_replay_ms``: the program's ``solve.replay`` span, the host's
time to enqueue the ``iteration - 1`` replays of the captured step, ms a
profiled recording (:mod:`portbench.harness.program_spans`)."""

from portbench.harness.program_spans import mean_ms


def read(run):
    return mean_ms(run, "solve.replay")

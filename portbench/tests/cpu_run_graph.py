""":mod:`portbench.tests.cpu_run` with the solvers' captured loop emulated
on the CPU (each replay an eager call of the step on the static buffers,
the program's own CPU route for its tests), so that a traced run holds the
spans and counters of the captured loop (the tests' helper; not a test).

    python -m portbench.tests.cpu_run_graph --root <checkout> --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import sys

from portbench.tests import cpu_run


def main(argv=None):
    from audio_source_separation_tpu_torch.runtime.solver import IterativeSolver

    IterativeSolver._emulate_graph = True
    return cpu_run.main(argv)


if __name__ == "__main__":
    sys.exit(main())

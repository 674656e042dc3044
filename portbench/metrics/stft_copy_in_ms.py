"""``stft_copy_in_ms``: the program's ``stft.copy_in`` spans, the copies
of the mixture and the window into the card (pageable host memory), ms a
profiled recording (:mod:`portbench.harness.program_spans`)."""

from portbench.harness.program_spans import mean_ms


def read(run):
    return mean_ms(run, "stft.copy_in")

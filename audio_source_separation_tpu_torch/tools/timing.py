"""Device timing of kernels on the card, shared by ``chip_smoke.py`` and the
tools here."""

import time

import numpy as np
import torch


def median_ms(fn, warmup=5, reps=25, before=None):
    """Median device time of one call of ``fn`` over ``reps`` calls.

    Each call sits between two CUDA events.  All calls are queued behind a
    spin kernel that lasts longer than the host takes to enqueue them, so
    the device never waits on the host between the events and they time
    the device work alone, not the wrapper's Python overhead.  ``before``,
    if given, runs ahead of each call outside its events (an L2 flush)."""
    def call():
        if before is not None:
            before()
        fn()

    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    start = time.perf_counter()
    call()
    host_s = time.perf_counter() - start
    torch.cuda.synchronize()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(reps)
    ]
    # 3e9 cycles/s is above the card's top clock, so the spin outlasts 2x
    # the measured enqueue time
    torch.cuda._sleep(int(2 * reps * host_s * 3e9) + 1_000_000)
    for begin, end in events:
        if before is not None:
            before()
        begin.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([begin.elapsed_time(end) for begin, end in events]))


def l2_flusher():
    """A call that overwrites 128 MB, more than an H100's 50 MB L2, so the
    next kernel reads its inputs from device memory."""
    buffer = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    return buffer.zero_

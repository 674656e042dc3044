"""Tracing and profiling hooks.

  * :func:`trace`: a ``torch.profiler`` context over the CPU and, where there
    is one, the card, written as a Chrome trace (Perfetto or
    ``chrome://tracing`` open it);
  * :class:`IterationTimer`: a callback that stamps the host clock at each
    call;
  * :func:`benchmark_solver`: a solver's sustained iterations per second,
    differenced over two loop lengths;
  * :func:`measure_memory_bandwidth`: the device's sustained memory rate on a
    float32 triad, the denominator of a roofline share;
  * :func:`state_payload_bytes`: the byte size of a solver's post-init state;
  * :func:`scan_cost_analysis`: raises, since the port has no compiler cost
    model.

Times on the card come from CUDA events (:mod:`~..tools.timing`'s route);
on the CPU from ``time.perf_counter`` after a synchronise.
"""

import contextlib
import os
import time
import warnings

import numpy as np
import torch

from .solver import full_f32_matmuls


@contextlib.contextmanager
def trace(log_dir):
    """Profile everything inside the block into ``log_dir`` as a Chrome
    trace (``trace.json``); CUDA activity is traced where there is a card."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as profile:
        yield profile
    profile.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class IterationTimer:
    """Callback recording the host clock (seconds) at each call;
    ``durations`` are the seconds between calls."""

    def __init__(self):
        self.timestamps = []

    def __call__(self, solver):
        self.timestamps.append(time.perf_counter())

    @property
    def durations(self):
        return np.diff(self.timestamps)


def _min_seconds(fn, device, windows):
    """The least time of ``windows`` calls of ``fn``: CUDA events on the
    card, the host clock after a synchronise on the CPU."""
    best = float("inf")
    for _ in range(windows):
        if device.type == "cuda":
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            begin.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            best = min(best, begin.elapsed_time(end) / 1e3)
        else:
            start = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - start)
    return best


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_solver(solver, X, iteration=30, warmup=True, short=None, update_fn=None):
    """Sustained iterations per second of a solver's loop.

    The solver's state is made once (``prepare_state_kwargs``, then
    ``init_state``); then ``update_fn`` (state -> state, default
    ``solver.update_state``) runs ``short`` and ``iteration`` times from it,
    each length timed over several windows and the least kept.  The rate is
    the differenced ``(iteration - short) / (t_long - t_short)``, so the
    fixed cost of a window cancels.  The loop runs inside
    :func:`~.solver.full_f32_matmuls`, as the solver's own does.

    Returns ``(iterations_per_sec, compile_seconds)``.  "Compile seconds"
    is the first call's time: the kernels' build or load and cuBLAS's
    initialisation (there is no XLA compile here).  ``warmup`` is the JAX
    signature's; the first call always runs.
    """
    if update_fn is None:
        update_fn = solver.update_state
    if short is None:
        short = max(1, iteration // 10)
    if not 0 < short < iteration:
        raise ValueError("benchmark_solver needs 0 < short < iteration, got {} and {}".format(short, iteration))

    with full_f32_matmuls():
        Xt = solver._to_input(X)
        solver.input = Xt
        kwargs = solver.prepare_state_kwargs(Xt, {})
        state = solver.init_state(Xt, **{k: v for k, v in kwargs.items() if v is not None})
        device = Xt.device

        def run(n):
            s = state
            for _ in range(n):
                s = update_fn(s)
            return s

        start = time.perf_counter()
        run(iteration)
        _sync(device)
        compile_seconds = time.perf_counter() - start
        run(short)
        t_long = _min_seconds(lambda: run(iteration), device, 4)
        t_short = _min_seconds(lambda: run(short), device, 4)
    if t_long - t_short < 0.010:
        warnings.warn(
            "benchmark_solver: differenced window is {:.1f} ms (< 10 ms); rate is jitter-dominated -- "
            "increase `iteration`".format(1e3 * (t_long - t_short)),
            RuntimeWarning,
        )
    marginal = max(t_long - t_short, 1e-9) / (iteration - short)
    return 1.0 / marginal, compile_seconds


def scan_cost_analysis(solver, X, iteration=None, short=None, update_fn=None):
    """The JAX package reads XLA's compiled cost model of one iteration;
    PyTorch runs eagerly and the port has no such model, so this raises."""
    raise NotImplementedError(
        "scan_cost_analysis reads XLA's compiled cost model; the PyTorch port runs eagerly and has none "
        "(time the loop with benchmark_solver, and count bytes with state_payload_bytes)"
    )


def state_payload_bytes(solver, X):
    """The byte size of the solver's post-init state: ``numel x
    element_size`` summed over the tensors that ``init_state`` returns.
    The port's state is its own (for example AuxIVA-IP at C = 2 carries
    K2's ``psum`` where the JAX package carries pair products), so the
    number differs from the JAX package's."""
    with full_f32_matmuls():
        Xt = solver._to_input(X)
        solver.input = Xt
        kwargs = solver.prepare_state_kwargs(Xt, {})
        state = solver.init_state(Xt, **{k: v for k, v in kwargs.items() if v is not None})
    return sum(v.numel() * v.element_size() for v in state.values() if isinstance(v, torch.Tensor))


def measure_memory_bandwidth(n_elems=1 << 26, iters=64, windows=4, device=None):
    """Sustained device memory rate (GB/s) on a float32 triad ``y <- a x + b
    y`` (two reads and one write of ``n_elems`` floats an iteration, one
    ``lerp_`` kernel with ``a = 1e-7``, ``b = 1 - a``), differenced over two
    loop lengths as :func:`benchmark_solver` does.  On the card this is the
    measured denominator of a roofline share."""
    from .device import resolve_device

    device = resolve_device(device)
    x = torch.ones(n_elems, dtype=torch.float32, device=device)
    y = torch.full((n_elems,), 0.5, dtype=torch.float32, device=device)

    def run(n):
        for _ in range(n):
            y.lerp_(x, 1e-7)

    short = max(1, iters // 8)
    run(iters)
    _sync(device)
    t_long = _min_seconds(lambda: run(iters), device, windows)
    t_short = _min_seconds(lambda: run(short), device, windows)
    per_iter = max(t_long - t_short, 1e-12) / (iters - short)
    return 3.0 * n_elems * 4 / per_iter / 1e9

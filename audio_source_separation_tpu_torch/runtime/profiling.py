"""Tracing and profiling hooks.

  * :func:`trace`: a ``torch.profiler`` context over the CPU and, where there
    is one, the card, written as a Chrome trace (Perfetto or
    ``chrome://tracing`` open it), with the program's own spans on a track
    of their own;
  * :func:`span`, :func:`spans`, :data:`counters`: the program's span log
    and counters (:mod:`.spanlog`), which record while a profiler does;
  * :class:`IterationTimer`: a callback that stamps the host clock at each
    call;
  * :func:`benchmark_solver`: a solver's sustained iterations per second,
    differenced over two loop lengths, of the loop its call runs (the
    captured step replayed, on a card, for a capturable solver);
  * :func:`measure_memory_bandwidth`: the device's sustained memory rate on a
    float32 triad, the denominator of a roofline share;
  * :func:`state_payload_bytes`: the byte size of a solver's post-init state;
  * :func:`scan_cost_analysis`: the bytes and FLOPs of one solver iteration,
    counted as it runs (:func:`iteration_cost`, by the rules of
    :mod:`.cost_model`).

Times on the card come from CUDA events (:mod:`~..tools.timing`'s route);
on the CPU from ``time.perf_counter`` after a synchronise.
"""

import contextlib
import json
import os
import time
import warnings

import numpy as np
import torch

from .cost_model import CostCounter
from .graph import StepGraph, new_stream, on_stream
from .solver import IterativeSolver, full_f32_matmuls
from .spanlog import Span, counters, span, spans

# the Chrome trace's process of the program's spans, sorted above the rest
SPANS_PID = "program spans"


@contextlib.contextmanager
def trace(log_dir):
    """Profile everything inside the block into ``log_dir`` as a Chrome
    trace (``trace.json``); CUDA activity is traced where there is a card.
    The program's spans of the block (:mod:`.spanlog`) go into the same
    file, on the profiler's clock, as the process ``program spans``; a
    top-level span's counters are its ``args``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    start_ns = time.time_ns()
    with torch.profiler.profile(activities=activities) as profile:
        yield profile
    path = os.path.join(log_dir, "trace.json")
    profile.export_chrome_trace(path)
    _add_spans(path, spans(since_ns=start_ns))


def _add_spans(path, logged):
    """Append ``logged`` spans to the Chrome trace at ``path`` as complete
    events, at the trace's own time base (``baseTimeNanoseconds``, where
    the trace names one) in microseconds."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": SPANS_PID, "tid": 0, "args": {"name": SPANS_PID}})
    events.append({"ph": "M", "name": "process_sort_index", "pid": SPANS_PID, "tid": 0, "args": {"sort_index": -1}})
    for s in logged:
        args = {"id": s.id, "parent": s.parent}
        args.update(s.attrs or {})
        events.append(
            {
                "ph": "X",
                "cat": "program",
                "name": s.name,
                "pid": SPANS_PID,
                "tid": 0,
                "ts": (s.start_ns - base) / 1e3,
                "dur": (s.end_ns - s.start_ns) / 1e3,
                "args": args,
            }
        )
    with open(path, "w") as f:
        json.dump(doc, f)


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


def _init_state(solver, X):
    """The solver's post-init state on ``X``, as its call makes it:
    ``_to_input``, ``prepare_state_kwargs`` (the host draws), ``init_state``.
    Run inside :func:`~.solver.full_f32_matmuls`."""
    Xt = solver._to_input(X)
    solver.input = Xt
    kwargs = solver.prepare_state_kwargs(Xt, {})
    return solver.init_state(Xt, **{k: v for k, v in kwargs.items() if v is not None})


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
    :func:`~.solver.full_f32_matmuls`, as the solver's own does.  Where the
    solver's call runs the captured loop (:mod:`.graph`), ``update_fn`` is
    captured the same way, after one eager step, and each iteration is a
    replay, as the JAX package times its jitted scan; else each is an eager
    call.

    Returns ``(iterations_per_sec, compile_seconds)``.  "Compile seconds"
    is the first call's time: the kernels' build or load, cuBLAS's
    initialisation and the step's capture (there is no XLA compile here).
    ``warmup`` is the JAX signature's; the first call always runs.
    """
    if update_fn is None:
        update_fn = solver.update_state
    if short is None:
        short = max(1, iteration // 10)
    if not 0 < short < iteration:
        raise ValueError("benchmark_solver needs 0 < short < iteration, got {} and {}".format(short, iteration))

    with full_f32_matmuls():
        state = _init_state(solver, X)
        device = solver.input.device
        start = time.perf_counter()
        if solver._uses_graph(solver.input):
            stream = new_stream(device)
            with on_stream(stream):
                graph = StepGraph(type(solver).__name__, update_fn(state), update_fn, stream=stream)
            run = graph.replay
        else:

            def run(n):
                s = state
                for _ in range(n):
                    s = update_fn(s)
                return s

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


def iteration_cost(solver, X, update_fn=None):
    """Count one iteration of ``solver`` on ``X`` as it runs: a
    :class:`~.cost_model.CostCounter` with the ``bytes``, ``flops``, kernel
    ``charges`` and per-op rows of one ``update_fn(state)`` (default
    ``solver.update_state``), by the rules of :mod:`.cost_model`.

    The post-init state is built as :func:`state_payload_bytes` builds it,
    on the solver's device (the card unless the solver was made with
    ``device="cpu"``), inside :func:`~.solver.full_f32_matmuls`, uncounted;
    the host draws are those of the solver's own call.  Then one update runs
    for real under the counter; the NLL is not counted.  The solver's
    attributes are restored afterwards, so its next call gives what a fresh
    solver's would, and a caller's input tensor is copied, never updated.
    Under :meth:`~.solver.IterativeSolver.use_mesh` the count is that of
    the whole unsharded iteration on one device, with no collective, as the
    JAX package's count is on the CPU.

    What it leaves out: the port carries the fields the JAX package derives
    again at the top of every scan iteration (``scan_restore_state``), so
    that recompute, which the JAX count holds, is not in this one.  What it
    counts follows the device: where ``torch.linalg`` dispatches other aten
    ops on CUDA than on the CPU (one cuSOLVER call against LAPACK's pieces),
    a solver's CPU and card counts differ there; K1, K2 and K3 (every
    eigensolve of a step) charge the same on both.  A failure while
    counting, a kernel's build or launch included, raises.
    """
    if not isinstance(solver, IterativeSolver):
        raise TypeError("iteration_cost counts an IterativeSolver's iteration, got {}".format(type(solver).__name__))
    if solver.device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; make the solver with device='cpu' to count on the host")
    if update_fn is None:
        update_fn = solver.update_state
    attributes = dict(vars(solver))
    counter = CostCounter()
    try:
        with full_f32_matmuls():
            if isinstance(X, torch.Tensor):
                X = X.clone()  # an update in place must not reach the caller's tensor
            state = _init_state(solver, X)
            _sync(solver.device)
            with counter:
                update_fn(state)
            _sync(solver.device)
    finally:
        vars(solver).clear()
        vars(solver).update(attributes)
    return counter


def scan_cost_analysis(solver, X, iteration=None, short=None, update_fn=None):
    """The bytes and FLOPs of one solver iteration, ``(bytes_per_iter,
    flops_per_iter)`` as Python floats, counted as the iteration runs
    (:func:`iteration_cost`; the rules are :mod:`.cost_model`'s).  The JAX
    package reads XLA's cost model of its compiled scan body instead, so
    the two counts differ by fusion, by that recompute and by the layouts.
    ``iteration`` and ``short`` are accepted for the signature's symmetry
    with :func:`benchmark_solver` and ignored."""
    counter = iteration_cost(solver, X, update_fn=update_fn)
    return float(counter.bytes), float(counter.flops)


def state_payload_bytes(solver, X):
    """The byte size of the solver's post-init state: ``numel x
    element_size`` summed over the tensors that ``init_state`` returns.
    The port's state is its own (for example AuxIVA-IP at C = 2 carries
    K2's ``psum`` where the JAX package carries pair products), so the
    number differs from the JAX package's."""
    with full_f32_matmuls():
        state = _init_state(solver, X)
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

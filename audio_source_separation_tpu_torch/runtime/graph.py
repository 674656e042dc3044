"""The captured solver loop: one step as a CUDA graph, replayed.

The JAX package runs a solver's iteration loop as one ``jax.lax.scan``
jitted once per (shape, iteration-count) signature, with no host round trip
inside the loop (``audio_source_separation_tpu/runtime/solver.py:12-14``;
the scan is built by ``_scan_fn`` at ``:317`` and cached by ``_get_jit``).
On a CUDA card the counterpart is a CUDA graph of one step, captured once
per signature and replayed once an iteration (:func:`graph_loop`):

  * init and the first iteration run eagerly.  For a new signature the first
    iteration runs on the graph's own stream, so the kernels are built and
    loaded and their scratch is allocated before capture: K1's and K2's
    wrappers (K3 keeps none) keep scratch and tickets per stream and refuse to allocate them
    during a capture.  After capture the graph takes that scratch out of
    the wrappers' tables, so each graph owns its own, though capture streams
    come from PyTorch's pool and repeat.
  * one step is captured on static state buffers (:class:`StepGraph`):
    ``update_state`` and, when the loss is recorded, ``nll``.  The step's
    outputs are copied back onto its inputs inside the graph; a field the
    step passes through unchanged is not copied.  The loss goes into a
    device buffer at a device-side counter, so no index is baked into the
    graph, and crosses to the host in one transfer.
  * the graph replays ``iteration - 1`` times on the caller's stream, then
    ``finalize`` runs eagerly on copies of the static buffers: neither the
    output nor a published attribute aliases them, so a later call, which
    overwrites them, cannot reach what a caller holds.
  * capture runs each kernel wrapper once and bumps its ``launches``
    count; the change is taken back after capture, and ``replay(n)`` adds
    ``n`` times a step's launches, so each count still says how many
    launches the card ran.

A solver whose :meth:`~.solver.IterativeSolver.capturable_edges` says so
(AuxIVA's component state) has the call's two edges captured too, once per
signature beside the step (:func:`edge_init`, :func:`edge_loop`,
:class:`EdgeGraph`), where the call gives no callbacks and no warm start.
The plain attributes that init sets from the input's shape are set
eagerly first (``init_attributes``: they are in the key, and a replay runs
no Python); then X is copied into the init graph's static input, which is
also the step graph's, and one replay of ``init_state`` and the initial
loss gives the post-init state.  The first iteration runs eagerly and the
rest replay as above; one replay of ``finalize`` on the step graph's static
state follows, and its output is cloned, so the rule above holds: neither
the output nor a published attribute aliases a static buffer.  All the
edge graphs of a solver share one capture stream and one memory pool
(:class:`_EdgeCache` says why that is safe); ``edge_graph_replays`` and
``edge_graph_captures`` count them apart from the step's counters.

The graphs are cached on the solver, keyed by what the captured step reads:
the post-init state's fields, shapes and dtypes, the device, and every
plain Python attribute of the solver (a scalar, a string or ``None``, such
as ``recordable_loss``, a hyperparameter, or what ``prepare_state_kwargs``
sets for a member of a batch), and the objects the step reads besides them
(``_graph_inputs``: GaussIDLMA's network), which the cache holds.  A later call of the same signature copies
its first iteration's state into the static buffers and replays; it does
not capture again.  With callbacks the graph replays once an iteration and
the state is published, as copies, before the callbacks run, as the JAX
package steps its jitted body from Python when it has callbacks.

What it does not do: unroll several steps into one graph, capture the
edges of a call with callbacks or a warm start, or of a solver that does
not opt in (their init reads host draws), or run a mesh (``use_mesh``
keeps the eager loop).  A solver says by ``capturable(X)``
whether its configuration's step on the input ``X`` can be captured (no host read, no op that
synchronises); one that says so and fails to capture raises
:class:`GraphCaptureError`, naming the line, and never falls back to the
eager loop.  On the CPU nothing is captured: a solver whose
``_emulate_graph`` is set runs the same static-buffer path, each replay an
eager call of the step or the edge, which is how the CPU tests hold it; its
one run in place of each capture is audited (:class:`CaptureAudit`) for the
ops a capture refuses, and raises as the card would.
"""

import contextlib
import functools
import gc
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves, tree_map

from .spanlog import counters, span

# losses kept on the device between transfers
LOSS_SLOTS = 1024


class GraphCaptureError(RuntimeError):
    """A step declared capturable could not be captured or replayed."""


def _kernels():
    """The kernels' wrapper modules: K2's, K1's, K3's, K4's."""
    from ..ops import cov_kernel, eigh_kernel, fused_ip, mnmf_rows

    return fused_ip, cov_kernel, eigh_kernel, mnmf_rows


@functools.cache
def _counted():
    """The kernel wrappers whose ``launches`` a replay adds to (resolved
    once)."""
    fused_ip, cov_kernel, eigh_kernel, mnmf_rows = _kernels()
    return (
        fused_ip.fused_auxiva_ip_iter, cov_kernel.weighted_covariance_planes, eigh_kernel.batched_eigh,
        mnmf_rows.fastmnmf_rows,
    )


def _launch_counts():
    return tuple(fn.launches for fn in _counted())


def _set_launch_counts(counts):
    for fn, n in zip(_counted(), counts):
        fn.launches = n


def _add_launch_counts(delta, times):
    for fn, n in zip(_counted(), delta):
        fn.launches += n * times


def _signature(state):
    """``((field, shape, dtype), ...)`` of a state of tensors; a field that
    is not a tensor raises (the graph would bake its value in)."""
    signature = []
    for k in sorted(state):
        v = state[k]
        if not isinstance(v, torch.Tensor):
            raise GraphCaptureError("state field {!r} is a {}, not a tensor".format(k, type(v).__name__))
        signature.append((k, tuple(v.shape), v.dtype))
    return tuple(signature)


def _plain(value):
    if value is None or isinstance(value, (bool, int, float, str)):
        return True
    return isinstance(value, tuple) and all(_plain(v) for v in value)


def _scalars(solver):
    """The solver's plain attributes, ``((name, value), ...)``: whatever of
    them the step reads is in the cache key."""
    return tuple(sorted((k, v) for k, v in vars(solver).items() if _plain(v)))


def _same_view(a, b):
    return a is b or (
        a.data_ptr() == b.data_ptr() and a.shape == b.shape and a.stride() == b.stride() and a.dtype == b.dtype
    )


def _storage(t):
    return t.untyped_storage().data_ptr()


def _innermost_line(frames):
    """``file:line (code)`` of the innermost of ``frames`` outside torch."""
    torch_dir = os.path.dirname(torch.__file__)
    frames = [f for f in frames if not f.filename.startswith(torch_dir)]
    if not frames:
        return "an unknown line"
    f = frames[-1]
    return "{}:{} ({})".format(f.filename, f.lineno, (f.line or "").strip())


def _failing_line(err):
    """``file:line (code)`` of the innermost frame of ``err`` outside torch."""
    return _innermost_line(traceback.extract_tb(err.__traceback__))


# what a capture refuses, by aten op: each reads on the host or copies from it
UNCAPTURABLE = {
    "_local_scalar_dense": "reads a value on the host (.item(), float(t), bool(t))",
    "lift_fresh": "builds a tensor from host data inside the step",
    "_linalg_check_errors": "checks a linear-algebra status on the host",
    "_linalg_eigh": "is torch.linalg.eigh, whose status cuSOLVER reads on the host",
    "_linalg_svd": "is torch.linalg.svd, whose status cuSOLVER reads on the host",
    "nonzero": "sizes its output from the data on the host",
    "masked_select": "sizes its output from the data on the host",
}


class CaptureAudit(TorchDispatchMode):
    """The CPU's stand-in for a capture's refusals: inside ``with
    CaptureAudit(name):`` an aten op of :data:`UNCAPTURABLE` raises
    :class:`GraphCaptureError` naming the line, as a capture on the card
    does.  A kernel wrapper's plain version, which stands for a launch on
    the card, runs with the audit paused (:func:`~.cost_model.charged`)."""

    def __init__(self, name, what="step"):
        super().__init__()
        self.name, self.what = name, what
        self._paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        op = func.overloadpacket.__name__
        if not self._paused and op in UNCAPTURABLE:
            raise GraphCaptureError(
                "{} declares its {} capturable, but capture failed at {}: aten.{} {}".format(
                    self.name, self.what, _innermost_line(traceback.extract_stack()[:-1]), op, UNCAPTURABLE[op]
                )
            )
        return func(*args, **(kwargs or {}))


def active_audit():
    """The innermost :class:`CaptureAudit` in force, else ``None``."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CaptureAudit):
            return mode
    return None


@contextlib.contextmanager
def on_stream(stream):
    """Run the block on ``stream`` (``None``: where it is), ordered after
    the caller's stream's work and before its later work."""
    if stream is None:
        yield
        return
    caller = torch.cuda.current_stream(stream.device)
    stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        yield
    caller.wait_stream(stream)


def _device_of(state):
    return next(iter(state.values())).device


def new_stream(device):
    """A graph's own capture stream on ``device``; ``None`` off CUDA."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def _capture(name, what, device, stream, body, pool=None):
    """``body()`` captured on ``stream`` as a CUDA graph, in the memory pool
    ``pool`` (``None``: a pool of its own): ``(graph, body's result)``.  A
    failure raises :class:`GraphCaptureError` naming the line."""
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize(device)
    # no collection during the capture: a graph freed there would release
    # its memory, which a capture forbids, and void this one
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="global")
            try:
                result = body()
            except Exception as err:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                if isinstance(err, GraphCaptureError):
                    raise
                raise GraphCaptureError(
                    "{} declares its {} capturable, but capture failed at {}: {}".format(
                        name, what, _failing_line(err), str(err).splitlines()[0] if str(err) else type(err).__name__
                    )
                ) from err
            try:
                graph.capture_end()
            except RuntimeError as err:
                raise GraphCaptureError("{}: capture of its {} failed: {}".format(name, what, err)) from err
    finally:
        if collecting:
            gc.enable()
    return graph, result


def _take_scratch(device, stream):
    """The kernels' scratch on ``stream``, taken out of their wrappers'
    tables for the graph just captured there."""
    return [module.take_scratch(device, stream.cuda_stream) for module in _kernels()]


class StepGraph:
    """One step, ``update`` and optionally ``loss``, captured on static
    copies of ``state`` (the state after an eager step on ``stream``, the
    current stream when this is made); ``loss_like`` is a loss of that
    step, whose type the loss buffer takes.  The fields named in ``keep``
    are static buffers already (the init graph's input) and are used as
    they are, not copied.  ``stream=None`` emulates the graph: each replay
    calls the step eagerly on the static buffers.
    """

    def __init__(self, name, state, update, loss=None, loss_like=None, stream=None, keep=()):
        self.name = name
        self.signature = _signature(state)
        self.device = _device_of(state)
        self._update, self._loss = update, loss
        self.static = {k: (v if k in keep else v.clone()) for k, v in state.items()}
        self.loss_buf = self.slot = None
        if loss is not None:
            self.loss_buf = loss_like.new_zeros((LOSS_SLOTS,))
            self.slot = torch.zeros((1,), dtype=torch.int64, device=self.device)
        before = _launch_counts()
        start = time.perf_counter()
        try:
            if stream is None:
                # run once on copies, for the signature check, the
                # pass-through fields and the launches of a step, under the
                # audit of what a capture would refuse
                static = {k: v.clone() for k, v in self.static.items()}
                slots = None if loss is None else (self.loss_buf.clone(), self.slot.clone())
                with CaptureAudit(name):
                    self.identity = self._step(static, slots)
                self.graph = None
            else:
                self.graph, self.identity = self._capture(stream)
                # replays need no Python: dropping the step's bound methods
                # leaves no cycle through the solver's cache, so a solver and
                # its graphs are freed when the solver is, never by the
                # cycle collector in the middle of another capture
                self._update = self._loss = None
            self.launches = tuple(after - b for after, b in zip(_launch_counts(), before))
        finally:
            _set_launch_counts(before)
        # seconds to capture (emulated: to run the step once)
        self.capture_s = time.perf_counter() - start

    def _capture(self, stream):
        slots = None if self._loss is None else (self.loss_buf, self.slot)
        graph, identity = _capture(self.name, "step", self.device, stream, lambda: self._step(self.static, slots))
        # the scratch the captured launches point at is this graph's alone
        self.scratch = _take_scratch(self.device, stream)
        return graph, identity

    def _step(self, static, slots):
        """The captured step: update, loss at the slot, outputs copied back
        onto the inputs.  Returns the fields passed through unchanged."""
        out = self._update(static)
        if _signature(out) != self.signature:
            raise GraphCaptureError(
                "{}: a captured step must keep its state's fields, shapes and dtypes; it maps {} to {}".format(
                    self.name, self.signature, _signature(out)
                )
            )
        if slots is not None:
            loss_buf, slot = slots
            loss_buf.index_copy_(0, slot, self._loss(out).reshape(1))
            slot.add_(1)
        identity = frozenset(k for k, v in out.items() if _same_view(v, static[k]))
        inputs = {_storage(v) for v in static.values()}
        # an output that shares memory with an input is copied first, so no
        # copy-back reads what another has already written
        pending = {k: (v.clone() if _storage(v) in inputs else v) for k, v in out.items() if k not in identity}
        for k, v in pending.items():
            static[k].copy_(v)
        return identity

    def load(self, state):
        """Copy ``state`` (the state after a call's eager step) into the
        static buffers."""
        if _signature(state) != self.signature:
            raise GraphCaptureError(
                "{}: the state {} does not match the captured {}".format(self.name, _signature(state), self.signature)
            )
        for k, v in state.items():
            if v is not self.static[k]:
                self.static[k].copy_(v)

    def replay(self, n=1):
        """``n`` steps; the launch counts gain a step's launches each, and
        ``graph_replays`` gains ``n``, once for the call."""
        if self.graph is not None:
            for _ in range(n):
                self.graph.replay()
        else:
            before = _launch_counts()
            try:
                slots = None if self._loss is None else (self.loss_buf, self.slot)
                for _ in range(n):
                    self._step(self.static, slots)
            finally:
                _set_launch_counts(before)
        _add_launch_counts(self.launches, n)
        counters["graph_replays"] += n

    def run(self, n):
        """``n`` steps from the loaded state; returns their losses as 1-D
        device tensors at the loss's type (none without a loss), copied out
        of the buffer every ``LOSS_SLOTS`` steps."""
        chunks = []
        while n > 0:
            m = min(n, LOSS_SLOTS)
            if self.slot is not None:
                self.slot.zero_()
            self.replay(m)
            if self.loss_buf is not None:
                chunks.append(self.loss_buf[:m].clone())
            n -= m
        return chunks

    def snapshot(self, state):
        """The static state as fresh tensors; a pass-through field is
        ``state``'s own (the loaded state's: a static buffer only where the
        graph keeps it, see ``keep``)."""
        return {k: (state[k] if k in self.identity else v.clone()) for k, v in self.static.items()}


def _graph_cache(solver):
    """The solver's graphs by signature (made on first use)."""
    return vars(solver).setdefault("_graph_cache", {})


def _first_step_graph(solver, state, record, keep=()):
    """One eager step of ``solver`` from its post-init ``state``, then the
    step's graph: a cached one of the same signature, loaded with the new
    state, or one captured now, the eager step run on the graph's own
    stream (``keep``: :class:`StepGraph`'s).  Returns ``(state after the
    step, its loss or None, graph)``."""
    update, loss = solver.update_state, (solver.nll if record else None)
    key = (_signature(state), str(_device_of(state)), _scalars(solver), solver._graph_inputs())
    cache = _graph_cache(solver)
    graph = cache.get(key)
    if graph is not None:
        state = update(state)
        value = None if loss is None else loss(state)
        graph.load(state)
        counters["graph_cache_hits"] += 1
        return state, value, graph
    stream = new_stream(_device_of(state))
    with on_stream(stream):
        state = update(state)
        value = None if loss is None else loss(state)
        with span("solve.capture"):
            graph = StepGraph(type(solver).__name__, state, update, loss, loss_like=value, stream=stream, keep=keep)
    cache[key] = graph
    counters["graph_captures"] += 1
    return state, value, graph


def replay_loop(solver, state, iteration, record, keep=()):
    """``iteration`` steps from the post-init ``state``: the first eager,
    the rest replayed.  Returns ``(final state, losses, step graph)``, the
    state as fresh tensors but for the fields the step passes through, the
    losses as a list of device tensors (empty unless ``record``), and the
    graph ``None`` where no step ran."""
    if iteration < 1:
        return state, [], None
    with span("solve.eager_step"):
        state, value, graph = _first_step_graph(solver, state, record, keep)
    losses = [value] if record else []
    with span("solve.replay"):
        losses.extend(graph.run(iteration - 1))
        final = graph.snapshot(state) if iteration > 1 else state
    return final, losses, graph


def graph_loop(solver, state, losses, iteration):
    """:meth:`~.solver.IterativeSolver._eager_loop`'s counterpart from the
    same post-init ``state`` and ``losses``: the same losses, callbacks,
    publishing and output, the iterations after the first replayed from
    the step's graph."""
    record = bool(solver.recordable_loss)
    if solver.callbacks is None:
        final, steps, _ = replay_loop(solver, state, iteration, record)
        with span("solve.wait"):
            solver._flush_losses(losses + steps)
        return solver._finish(final, publish=True)
    with span("solve.wait"):
        solver._flush_losses(losses)
    final = state
    with span("solve.steps"):
        if solver.callback_on_init:
            solver._on_callback()
        if iteration > 0:
            final, value, graph = _first_step_graph(solver, state, record)
            for i in range(iteration):
                if i:
                    chunk = graph.run(1)
                    value = chunk[0][0] if record else None
                    final = graph.snapshot(final)
                if record:
                    solver.loss.append(float(value))
                solver._publish(final)
                solver._on_callback()
    return solver._finish(final, publish=False)


class EdgeGraph:
    """One edge of a call, its init or its finalize, as a CUDA graph:
    ``body(*inputs)`` captured on ``inputs``, static tensors (or dicts of
    them) that the caller fills before each replay.  The body's result, a
    pytree of tensors, is the graph's static output (:attr:`outputs`), which
    each :meth:`replay` refreshes in place; an output may be one of the
    inputs, passed through.  Before the capture the body runs once eagerly
    on ``stream``, so what it launches is built and loaded.  ``pool`` is a
    memory pool the graph shares (``None``: its own).  ``stream=None``
    emulates the graph as :class:`StepGraph` does: the body runs once under
    the audit, and each replay runs it eagerly and copies its result into
    the outputs."""

    def __init__(self, name, what, body, inputs, stream=None, pool=None):
        self.inputs, self._body = inputs, body
        if stream is not None:
            with on_stream(stream):
                body(*inputs)
        before = _launch_counts()
        try:
            if stream is None:
                passed = {id(t) for t in tree_leaves(inputs)}
                with CaptureAudit(name, what):
                    out = body(*inputs)
                out = tree_map(lambda v: v if id(v) in passed else v.clone(), out)
                self.graph = None
            else:
                self.graph, out = _capture(name, what, stream.device, stream, lambda: body(*inputs), pool=pool)
                self.scratch = _take_scratch(stream.device, stream)
                # no Python at a replay, and no cycle through the solver
                self._body = None
            self.launches = tuple(after - b for after, b in zip(_launch_counts(), before))
        finally:
            _set_launch_counts(before)
        self.outputs = out
        self._leaves = tree_leaves(out)
        counters["edge_graph_captures"] += 1

    def replay(self):
        """One run of the body on the inputs as they stand; returns
        :attr:`outputs`.  ``edge_graph_replays`` gains 1."""
        if self.graph is not None:
            self.graph.replay()
        else:
            before = _launch_counts()
            try:
                for static, v in zip(self._leaves, tree_leaves(self._body(*self.inputs))):
                    if v is not static:
                        static.copy_(v)
            finally:
                _set_launch_counts(before)
        _add_launch_counts(self.launches, 1)
        counters["edge_graph_replays"] += 1
        return self.outputs


class _EdgeCache(dict):
    """A solver's edges by call signature, and the capture stream and the
    memory pool that all of their graphs share (``None`` off CUDA).  Sharing
    is safe because each edge graph's output is read before any other edge
    graph replays: the init state by the call's first step, the finalize
    output by its clone; so the graphs of many lengths hold little more
    than their outputs."""

    def __init__(self, device):
        super().__init__()
        self.stream = new_stream(device)
        self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None


class _Edges:
    """The edges of one call signature: the init graph's static input, the
    init graph, and the finalize graph with the step graph whose static
    state it reads."""

    def __init__(self, X):
        self.input = torch.empty_like(X)
        self.init = self.finalize = self.step = None


def _init_body(solver, record):
    def body(X):
        state = solver.init_state(X)
        return state, ([solver.nll(state)] if record else [])

    return body


def edge_init(solver, X):
    """An engaged call's init (module docstring) on its input ``X``: the
    host attributes, X copied into the static input, one replay of the
    init graph, captured at a new signature.  Returns ``(post-init state,
    losses, edges)``: the state and the initial loss (in a list, where it is
    recorded) are the graph's static outputs.  The post-init state is not
    published: no callback runs to see it, and the final publish of
    :func:`edge_loop` replaces it."""
    solver.init_attributes(X)
    key = (tuple(X.shape), X.dtype, str(X.device), _scalars(solver), solver._graph_inputs())
    cache = vars(solver).get("_edge_cache")
    if cache is None:
        cache = solver._edge_cache = _EdgeCache(X.device)
    edges = cache.get(key)
    if edges is None:
        edges = cache[key] = _Edges(X)
    edges.input.copy_(X)
    if edges.init is None:
        record = bool(solver.recordable_loss) and solver.record_initial_loss
        with span("solve.capture_init"):
            edges.init = EdgeGraph(
                type(solver).__name__, "init", _init_body(solver, record), (edges.input,),
                stream=cache.stream, pool=cache.pool,
            )
    state, losses = edges.init.replay()
    return state, list(losses), edges


def edge_finalize(solver, edges, graph):
    """One replay of the finalize graph on the step ``graph``'s static
    state, captured at first sight of ``graph``: the output, cloned."""
    if edges.step is not graph:
        cache = solver._edge_cache
        with span("solve.capture_finalize"):
            edges.finalize = EdgeGraph(
                type(solver).__name__, "finalize", solver.finalize, (graph.static,),
                stream=cache.stream, pool=cache.pool,
            )
        edges.step = graph
    return tree_map(torch.clone, edges.finalize.replay())


def edge_loop(solver, edges, X, state, losses, iteration):
    """An engaged call after :func:`edge_init`: the first step eager (the
    step graph's static input is the init graph's), the rest replayed, the
    losses' one transfer, then :func:`edge_finalize` and the publish of the
    final state with the caller's ``X`` as its input.  Returns the
    output."""
    record = bool(solver.recordable_loss)
    final, steps, graph = replay_loop(solver, state, iteration, record, keep=("input",))
    with span("solve.wait"):
        solver._flush_losses(losses + steps)
    with span("solve.finalize"):
        output = edge_finalize(solver, edges, graph)
        solver._publish(dict(final, input=X))
        solver.estimation = output
    return output

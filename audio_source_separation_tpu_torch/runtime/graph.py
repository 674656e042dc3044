"""The call engine: a solver call's route, the graphs it replays, and
their cache.

The JAX package runs a solver's loop as one ``jax.lax.scan`` jitted once
per signature (``audio_source_separation_tpu/runtime/solver.py:12-14``).
On a CUDA card the counterpart is a CUDA graph of one step, captured once
per signature and replayed once an iteration.  A call takes one of three
routes, chosen by :func:`route_for` alone:

  * the eager loop (:class:`Route`), every op dispatched from the host:
    the CPU's, a mesh's, that of a solver whose step is not ``capturable``,
    and ``_eager_call``'s, the reference the others are held to;
  * the captured step (:class:`StepRoute`): init and the first iteration
    eager, the first on the graph's own stream at a new signature, so the
    kernels are built and their scratch allocated before capture; the rest
    replays of the step's graph;
  * the captured edges (:class:`EdgeRoute`), where the solver says
    ``capturable_edges`` and the call brings at least one iteration, no
    callbacks and no warm start: the init with the initial loss and the
    ``finalize`` are graphs too.  ``init_attributes`` first sets the plain
    attributes init sets from X's shape (they are in the key, and a replay
    runs no Python); X is copied into the init graph's static input, which
    the step graph keeps as its own.

A route gives three operations, :meth:`~Route.init`, :meth:`~Route.steps`
(or :meth:`~Route.step`, one at a time, for callbacks) and
:meth:`~Route.finalize`; ``IterativeSolver._drive`` runs them for a call
and ``batch_separate`` for each member.  Neither the output nor a
published attribute aliases a static buffer: the final state is copied out
of the step graph, and the finalize graph's output is cloned.

A :class:`Graph` captures a body on static inputs, or on the CPU emulates
it (the solver's ``_emulate_graph``: the body runs once under
:class:`CaptureAudit`, which raises as a capture would, and each replay
runs it eagerly); :class:`StepGraph` is one step on static state, its loss
written at a device-side counter into a buffer that crosses to the host in
one transfer.  A solver's graphs are cached in ``_graph_cache``, an
:class:`_Entry` per call signature: X's shape, dtype and device, the
solver's plain attributes (:func:`_scalars`, read once a call after init:
a hyperparameter, ``recordable_loss``, what ``prepare_state_kwargs`` sets)
and the objects the step reads besides them (``_graph_inputs``: GaussIDLMA's
network, held by the key).  A step that cannot be captured must not be
declared capturable: capture raises :class:`GraphCaptureError` naming the
line and never falls back to the eager loop.
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


@functools.cache
def _counted():
    """The kernel wrappers whose ``launches`` a replay adds to (resolved
    once; the kernels' modules import the runtime, so not at import)."""
    from .. import ops

    return ops.COUNTED_KERNELS


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


def _take_scratch(stream):
    """The kernels' scratch on ``stream``, taken out of their wrappers'
    tables for the graph just captured there."""
    from .. import ops

    return [module.take_scratch(stream.device, stream.cuda_stream) for module in ops.SCRATCH_OWNERS]


class Graph:
    """``body(*inputs)`` as a CUDA graph captured on ``stream``.

    ``inputs`` are static tensors (or dicts of them) that the caller fills
    before a replay; the body's result, a pytree of tensors, is the graph's
    static output (:attr:`outputs`), which each :meth:`replay` refreshes in
    place, an output that is an input passed through.  ``warm`` runs the
    body once eagerly on ``stream`` first, so what it launches is built and
    loaded.  ``pool`` is a memory pool the graph shares (``None``: its
    own).  After capture the graph takes the kernels' scratch of its stream
    out of their wrappers' tables, so each graph owns its own, though
    capture streams come from PyTorch's pool and repeat.  ``stream=None``
    emulates the graph: the body runs once under :class:`CaptureAudit` in
    place of the capture, and each replay runs it eagerly and copies its
    result into the outputs.

    The kernels' ``launches`` stay what the card runs: what the capture
    (or the audited run) adds is taken back, and each replay adds one run's
    (:attr:`launches`); the counter named ``counter`` gains one a replay.
    """

    def __init__(self, name, what, body, inputs, counter, stream=None, pool=None, warm=False):
        self.inputs, self._body, self.counter = inputs, body, counter
        if warm and stream is not None:
            with on_stream(stream):
                body(*inputs)
        before = _launch_counts()
        start = time.perf_counter()
        try:
            if stream is None:
                passed = {id(t) for t in tree_leaves(inputs)}
                with CaptureAudit(name, what):
                    out = body(*inputs)
                out = tree_map(lambda v: v if id(v) in passed else v.clone(), out)
                self.graph = None
            else:
                self.graph, out = _capture(name, what, stream.device, stream, lambda: body(*inputs), pool)
                self.scratch = _take_scratch(stream)
                # replays need no Python: dropping the body leaves no cycle
                # through the solver's cache, so a solver and its graphs are
                # freed when the solver is, never by the cycle collector in
                # the middle of another capture
                self._body = None
            self.launches = tuple(after - b for after, b in zip(_launch_counts(), before))
        finally:
            _set_launch_counts(before)
        # seconds to capture (emulated: to run the body once)
        self.capture_s = time.perf_counter() - start
        self.outputs = out
        self._leaves = tree_leaves(out)

    def replay(self, n=1):
        """``n`` runs of the body on the inputs as they stand; returns
        :attr:`outputs`.  The launch counts gain a run's launches each."""
        if self.graph is not None:
            for _ in range(n):
                self.graph.replay()
        else:
            before = _launch_counts()
            try:
                for _ in range(n):
                    for static, v in zip(self._leaves, tree_leaves(self._body(*self.inputs))):
                        if v is not static:
                            static.copy_(v)
            finally:
                _set_launch_counts(before)
        _add_launch_counts(self.launches, n)
        counters[self.counter] += n
        return self.outputs


class StepGraph(Graph):
    """One step, ``update`` and optionally ``loss``, captured on static
    copies of ``state`` (the state after an eager step on ``stream``, the
    current stream when this is made); ``loss_like`` is a loss of that
    step, whose type the loss buffer takes.  The step's outputs are copied
    back onto its inputs inside the graph, but for the fields it passes
    through (:attr:`identity`); the loss goes into a device buffer at a
    device-side counter, so no index is baked into the graph.  The fields
    named in ``keep`` are static buffers already (the init graph's input)
    and are used as they are, not copied.  ``stream=None`` emulates the
    graph (:class:`Graph`).  A replay adds to ``graph_replays``.
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
        super().__init__(name, "step", self._step, (self.static,), "graph_replays", stream)
        if stream is None:
            # the audited run stepped the buffers, which a capture does not
            self.load(state)
            if self.slot is not None:
                self.slot.zero_()
        else:
            self._update = self._loss = None

    def _step(self, static):
        """The captured step: update, loss at the slot, outputs copied back
        onto the inputs (:attr:`identity`: the fields passed through)."""
        out = self._update(static)
        if _signature(out) != self.signature:
            raise GraphCaptureError(
                "{}: a captured step must keep its state's fields, shapes and dtypes; it maps {} to {}".format(
                    self.name, self.signature, _signature(out)
                )
            )
        if self._loss is not None:
            self.loss_buf.index_copy_(0, self.slot, self._loss(out).reshape(1))
            self.slot.add_(1)
        self.identity = frozenset(k for k, v in out.items() if _same_view(v, static[k]))
        inputs = {_storage(v) for v in static.values()}
        # an output that shares memory with an input is copied first, so no
        # copy-back reads what another has already written
        pending = {k: (v.clone() if _storage(v) in inputs else v) for k, v in out.items() if k not in self.identity}
        for k, v in pending.items():
            static[k].copy_(v)
        return static

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


class _Cache(dict):
    """A solver's graphs, an :class:`_Entry` per call signature, and the
    capture stream and the memory pool that all of its edge graphs share
    (made at the first; ``None`` off CUDA).  Sharing is safe because each
    edge graph's output is read before any other edge graph replays: the
    init state by the call's first step, the finalize output by its clone;
    so the edges of many lengths hold little more than their outputs.  Each
    step graph keeps its own stream and pool."""

    stream = pool = None

    def edge_stream(self, device):
        if self.stream is None and device.type == "cuda":
            self.stream, self.pool = new_stream(device), torch.cuda.graph_pool_handle()
        return self.stream, self.pool


class _Entry:
    """The graphs of one call signature: its step graphs by post-init state
    signature and, where the call's edges are captured, the init graph's
    static input, the init graph, and the finalize graph with the step
    graph (``finalized``) whose static state it reads."""

    def __init__(self):
        self.steps = {}
        self.input = self.init = self.finalize = self.finalized = None


def _cache(solver):
    cache = vars(solver).get("_graph_cache")
    if cache is None:
        cache = solver._graph_cache = _Cache()
    return cache


class Route:
    """The eager route of a call on ``X``: every op dispatched from the
    host each iteration."""

    def __init__(self, solver, X):
        self.solver, self.X = solver, X
        self.record = bool(solver.recordable_loss)

    def init(self, state_kwargs, call=True):
        """The post-init state and the initial loss, in a list of device
        tensors where it is recorded.  A call's init publishes the state; a
        batch member's (``call=False``) neither publishes nor records."""
        solver = self.solver
        state = solver.init_state(self.X, **state_kwargs)
        if not call:
            return state, []
        solver._publish(state)
        return state, ([solver.nll(state)] if self.record and solver.record_initial_loss else [])

    def step(self, state):
        """One step: the state after it and its loss (a device tensor;
        ``None`` unless recorded)."""
        state = self.solver.update_state(state)
        return state, (self.solver.nll(state) if self.record else None)

    def steps(self, state, n):
        """``n`` steps: the state after them and their losses, a list of
        device tensors (empty unless recorded)."""
        losses = []
        with span("solve.steps"):
            for _ in range(n):
                state, loss = self.step(state)
                if self.record:
                    losses.append(loss)
        return state, losses

    def finalize(self, state):
        """The output of the final ``state``, whole (gathered under a
        mesh)."""
        return self.solver._whole_output(self.solver.finalize(state))


class StepRoute(Route):
    """The captured step: the call's first step eager, then the step's
    graph, found in the cache or captured; the rest replays."""

    # the state fields that are static buffers of the entry already
    keep = ()

    def __init__(self, solver, X):
        super().__init__(solver, X)
        self.entry = self.graph = None

    def _entry(self):
        """The call's cache entry, keyed once a call after init (which sets
        the attributes in the key); a new one is stored once it holds a
        graph."""
        if self.entry is None:
            solver, X = self.solver, self.X
            self.key = (tuple(X.shape), X.dtype, str(X.device), _scalars(solver), solver._graph_inputs())
            self.entry = _cache(solver).get(self.key) or _Entry()
        return self.entry

    def step(self, state):
        if self.graph is not None:
            losses = self.graph.run(1)
            return self.graph.snapshot(state), (losses[0][0] if self.record else None)
        solver, entry = self.solver, self._entry()
        update, loss = solver.update_state, (solver.nll if self.record else None)
        signature = _signature(state)
        graph = entry.steps.get(signature)
        if graph is not None:
            state = update(state)
            value = None if loss is None else loss(state)
            graph.load(state)
            counters["graph_cache_hits"] += 1
        else:
            stream = new_stream(self.X.device)
            with on_stream(stream):
                state = update(state)
                value = None if loss is None else loss(state)
                with span("solve.capture"):
                    graph = StepGraph(
                        type(solver).__name__, state, update, loss, loss_like=value, stream=stream, keep=self.keep
                    )
            entry.steps[signature] = graph
            _cache(solver)[self.key] = entry
            counters["graph_captures"] += 1
        self.graph = graph
        return state, value

    def steps(self, state, n):
        if n < 1:
            return state, []
        with span("solve.eager_step"):
            first, loss = self.step(state)
        with span("solve.replay"):
            losses = ([loss] if self.record else []) + self.graph.run(n - 1)
            return (self.graph.snapshot(first) if n > 1 else first), losses


class EdgeRoute(StepRoute):
    """The captured edges: the init and the finalize replayed from their
    graphs around the captured step, whose static input is the init
    graph's."""

    keep = ("input",)

    def init(self, state_kwargs, call=True):
        """X copied into the init graph's static input and one replay of
        the init graph (captured at a new signature), whose outputs are the
        post-init state and the initial loss.  Nothing is published: no
        callback runs to see the state, and the final publish replaces
        it."""
        solver = self.solver
        solver.init_attributes(self.X)
        entry = self._entry()
        if entry.input is None:
            entry.input = torch.empty_like(self.X)
        entry.input.copy_(self.X)
        if entry.init is None:
            record = self.record and solver.record_initial_loss

            def body(X):
                state = solver.init_state(X)
                return state, ([solver.nll(state)] if record else [])

            with span("solve.capture_init"):
                entry.init = self._edge("init", body, (entry.input,))
            _cache(solver)[self.key] = entry
        state, losses = entry.init.replay()
        return state, list(losses)

    def steps(self, state, n):
        state, losses = super().steps(state, n)
        # the caller's X in place of the static input, which the next call
        # refills
        return dict(state, input=self.X), losses

    def finalize(self, state):
        """One replay of the finalize graph on the step graph's static
        state, captured at first sight of that graph: the output, cloned."""
        entry, graph = self.entry, self.graph
        if entry.finalized is not graph:
            with span("solve.capture_finalize"):
                entry.finalize = self._edge("finalize", self.solver.finalize, (graph.static,))
            entry.finalized = graph
        return tree_map(torch.clone, entry.finalize.replay())

    def _edge(self, what, body, inputs):
        stream, pool = _cache(self.solver).edge_stream(self.X.device)
        graph = Graph(type(self.solver).__name__, what, body, inputs, "edge_graph_replays", stream, pool, warm=True)
        counters["edge_graph_captures"] += 1
        return graph


def route_for(solver, X, state_kwargs, iteration, callbacks):
    """The route of a call on ``X`` (its shard under a mesh) with the warm
    start ``state_kwargs`` left after ``prepare_state_kwargs``: the captured
    edges where the step is captured, the call runs at least one iteration
    with no ``callbacks`` and no warm start, and the solver says
    ``capturable_edges(X)``; else the captured step where
    ``solver._uses_graph(X)``; else the eager loop."""
    if not solver._uses_graph(X):
        return Route(solver, X)
    if iteration > 0 and not callbacks and not state_kwargs and solver.capturable_edges(X):
        return EdgeRoute(solver, X)
    return StepRoute(solver, X)

"""The solver runtime: one iteration engine for every separation model.

A solver defines functions over an explicit **state dict**:
``init_state``, ``update_state`` (returns the next state dict), ``nll``
and ``finalize``.  :class:`IterativeSolver` keeps the public API of the
reference: ``solver = Cls(**hyper); output = solver(X, iteration=N,
**state_kwargs)``, where ``state_kwargs`` warm-start the state (checkpoint
/ resume), any other kwargs become plain attributes for callbacks,
``solver.loss`` records the loss after every update (concatenating across
calls) and, where ``record_initial_loss`` is set, before the first one,
and callbacks run after every iteration, and after init where
``callback_on_init`` is set, with the state published as attributes.

A call's route, the eager loop or a captured step with or without captured
edges, is chosen by :func:`~.graph.route_for`, and
:meth:`IterativeSolver._drive` runs the route's init, steps and
finalize (:mod:`.graph`, the counterpart of the JAX package's jitted scan).

Under :meth:`IterativeSolver.use_mesh` the call runs on one shard of bins or
frames per rank of a ``torch.distributed`` device mesh (see
:mod:`~..parallel.mesh`): every rank passes the whole input, runs the loop
on its shard with an all-reduce at each reduction over the sharded axis,
and gathers the output and the published attributes once, after the loop.
"""

import contextlib

import numpy as np
import torch

from .device import resolve_device
from .graph import Route, route_for
from .spanlog import begin, count_copy, end, span

EPS = 1e-12


def state_tensor(value, X, dtype=None):
    """A state array (host-drawn float64 NumPy, or a tensor) on ``X``'s
    device at ``dtype`` (default ``X``'s real type): the cast comes after
    the draw, so float64 runs see the drawn values exactly.  A value that is
    not a tensor on ``X``'s device crosses from the host: the copy is a
    ``solve.state_copy_in`` span and counts as a host copy of the bytes it
    lands as."""
    dtype = X.real.dtype if dtype is None else dtype
    if isinstance(value, torch.Tensor) and value.device == X.device:
        return value.to(dtype=dtype).contiguous()
    with span("solve.state_copy_in"):
        out = torch.as_tensor(value).to(device=X.device, dtype=dtype).contiguous()
        count_copy(out.numel() * out.element_size())
    return out


@contextlib.contextmanager
def full_f32_matmuls():
    """Full float32 products (no TF32) in every CUDA matmul inside the
    block, and the caller's setting back on leaving it.

    ``torch.set_float32_matmul_precision`` sets both the legacy flag
    (``torch.backends.cuda.matmul.allow_tf32``) and, where this PyTorch has
    it, the newer ``torch.backends.cuda.matmul.fp32_precision``, so cuBLAS
    sees one consistent setting whichever API the caller used.  A caller who
    mixed the two leaves the legacy precision unreadable; only the newer
    setting is restored then.
    """
    matmul = torch.backends.cuda.matmul
    precision = getattr(matmul, "fp32_precision", None)
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:
        legacy = None
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        if precision is not None:
            matmul.fp32_precision = precision


class IterativeSolver:
    """Base class implementing the solver protocol.

    Subclasses define ``state_fields`` (the state keys that ``__call__``
    kwargs may warm-start), ``init_state(X, **kwargs)``,
    ``update_state(state)``, ``nll(state)`` (a 0-d tensor) and
    ``finalize(state)``; optionally ``prepare_state_kwargs`` for host-side
    defaults and ``input_dtype`` for the type the solver runs at.

    Precision: on the CPU the solver runs at the input's precision
    (complex128 input stays complex128).  On CUDA the input is cast to
    complex64 (float32 for the real-target factorisations) and the kernels
    take float32 planes, as the JAX package runs on the TPU with x64 off.
    The loop runs with TF32 off (:func:`full_f32_matmuls`).
    """

    state_fields = ()
    # the IVA/ILRMA families record the NLL before the first update too; the
    # factorisation models record only post-update losses
    record_initial_loss = True
    # real targets (NMF, NTF): the solver runs at a real type
    real_input = False
    # the PDS and IDLMA solvers call callbacks only after iterations
    callback_on_init = True
    # run the captured loop's static-buffer path on the CPU too, each replay
    # an eager step (the CPU tests' hook; nothing is captured there)
    _emulate_graph = False

    # the mesh of use_mesh, and what this call runs sharded on
    _mesh = None
    _shard_mode = "bins"
    _shard_axis_name = None
    _shard_pad = False
    _sharded = False
    _bin_pad = 0

    def __init__(self, callbacks=None, recordable_loss=True, eps=EPS, device=None):
        if callbacks is not None and callable(callbacks):
            callbacks = [callbacks]
        self.callbacks = callbacks
        self.eps = eps
        self.device = resolve_device(device)
        self.input = None
        self.recordable_loss = recordable_loss
        self.loss = [] if recordable_loss else None

    # multi-device execution
    def field_axes(self):
        """Shardable axes of each state field, ``{field: {"bins": axis,
        "frames": axis}}``; a field or a mode left out is replicated (the
        default: everything)."""
        return {}

    def use_mesh(self, mesh, mode="bins", axis_name=None, pad_bins=False):
        """Run every later call sharded over ``mesh``, a
        :class:`~torch.distributed.device_mesh.DeviceMesh` of one rank per
        device (``mesh=None`` resets).

        ``mode="bins"`` shards the frequency bins (every per-bin update is
        independent; the cross-bin sums of the weights and the NLL are
        all-reduced), ``mode="frames"`` the frames (every ``sum_t``
        statistic is all-reduced).  ``axis_name`` names the mesh dimension
        that shards: ``"tp"`` where the mesh has one, else its last.

        Every rank calls the solver with the whole input and gets the whole
        output back, and the same ``loss``.  The sharded length must divide
        by the mesh dimension; ``pad_bins=True`` zero-pads the bins up to a
        multiple for the solvers whose padded bins are provably neutral
        (:meth:`supports_bin_padding`), and crops the output and the
        published attributes back to the input's bins.
        """
        if mode not in ("bins", "frames"):
            raise ValueError("mode must be 'bins' or 'frames', got {!r}".format(mode))
        from ..parallel.mesh import mesh_axis

        self._mesh = mesh
        self._shard_mode = mode
        self._shard_pad = bool(pad_bins)
        self._shard_axis_name = None if mesh is None else mesh_axis(mesh, axis_name)
        return self

    def _validate_mesh(self, input):
        """Solver-specific check of the mesh against the (padded) input,
        after the divisibility check; raises where the state couples the
        sharded axis beyond per-element independence."""

    def supports_bin_padding(self):
        """Whether zero bins are provably neutral for this solver's updates."""
        return False

    def pad_state_kwarg(self, field, value, pad, axis):
        """A warm-start value padded with ``pad`` zeros along its bins
        ``axis`` (solvers override for another neutral fill)."""
        value = torch.as_tensor(value)
        shape = list(value.shape)
        shape[axis] = pad
        return torch.cat([value, value.new_zeros(shape)], dim=axis)

    def _shard_world(self, mode=None):
        """Ranks of the sharded dimension when this call runs sharded in
        ``mode`` (any mode for ``None``), else 1."""
        if not self._sharded or (mode is not None and mode != self._shard_mode):
            return 1
        mesh = self._mesh
        return mesh.size(mesh.mesh_dim_names.index(self._shard_axis_name))

    def _shard_group(self, mode=None):
        """The process group of the sharded dimension when this call runs
        sharded in ``mode`` (any mode for ``None``), else ``None``."""
        if not self._sharded or (mode is not None and mode != self._shard_mode):
            return None
        return self._mesh.get_group(self._shard_axis_name)

    def _shard_sum(self, x, mode=None):
        """``x`` summed over the shards when this call runs sharded in
        ``mode`` (:func:`~..parallel.mesh.shard_sum`)."""
        if not self._sharded:
            return x
        from ..parallel.mesh import shard_sum

        return shard_sum(x, self, mode)

    def _shard_sums(self, tensors, mode=None):
        """Several partial sums made whole by one all-reduce
        (:meth:`_shard_sum` of the packed tensors); complex ones travel as
        their real pairs, beside real ones of the same precision."""
        if self._shard_group(mode) is None:
            return tensors
        flat = [(torch.view_as_real(t) if t.is_complex() else t).reshape(-1) for t in tensors]
        whole = self._shard_sum(torch.cat(flat), mode).split([f.numel() for f in flat])
        # each sum in the layout of the partial sum it replaces, strides
        # included, so the ops downstream run as in the unsharded call
        return [
            torch.empty_like(t).copy_(
                torch.view_as_complex(part.reshape(*t.shape, 2)) if t.is_complex() else part.reshape(t.shape)
            )
            for part, t in zip(whole, tensors)
        ]

    def _shard_max(self, x, mode=None):
        """``x`` maximised over the shards when this call runs sharded in
        ``mode`` (:func:`~..parallel.mesh.shard_max`)."""
        if not self._sharded:
            return x
        from ..parallel.mesh import shard_max

        return shard_max(x, self, mode)

    def _bins_sum(self, x):
        return self._shard_sum(x, "bins")

    def _frames_sum(self, x):
        return self._shard_sum(x, "frames")

    def _fit_less_per_bin(self, fit, per_bin):
        """``fit - per_bin`` made whole, ``fit`` a partial sum over this
        shard's bins and frames and ``per_bin`` one over its bins only
        (replicated over frame shards): one all-reduce in either mode."""
        if self._shard_world("frames") > 1:
            return self._frames_sum(fit) - per_bin
        return self._bins_sum(fit - per_bin)

    def _frames_mean(self, x):
        """The mean over frame shards of a statistic each shard divided by
        its own frame count: the global ``(1/T) sum_t``, shards being equal."""
        return self._shard_sum(x, "frames") / self._shard_world("frames")

    def _n_bins(self, X):
        """The bin count of the whole (padded) input of this call; ``X`` is
        a ``(C, F, T)`` shard (the other layouts pass their own count when
        unsharded)."""
        return self._n_bins_global if self._sharded else X.shape[1]

    def _n_frames(self, X):
        """The frame count of the whole input of this call (``X``'s last
        axis when unsharded)."""
        return self._n_frames_global if self._sharded else X.shape[-1]

    def _input_axes(self, X):
        """``(bins axis, frames axis)`` of the input ``X``: the
        ``field_axes`` entry of ``"input"``, where the layout is not ``(C,
        F, T)``; a layout without bins gives ``None``."""
        axes = self.field_axes().get("input", {"bins": 1, "frames": 2})
        bins, frames = axes.get("bins"), axes.get("frames", -1)
        return (None if bins is None else bins % X.ndim), frames % X.ndim

    def _valid_bins(self, X):
        """``(F,)`` bool mask of the bins of this padded call's shard ``X``
        that are the input's, not padding."""
        start = self._bin_start
        return torch.arange(start, start + X.shape[1], device=X.device) < self._n_bins_true

    def _enter_mesh(self, X, state_kwargs):
        """Pad, check and cut the input and the warm-start kwargs to this
        rank's shard; returns them and marks the call sharded."""
        from ..parallel.mesh import mesh_device, shard_bounds, take_shard

        mesh, mode, name = self._mesh, self._shard_mode, self._shard_axis_name
        size = mesh.size(mesh.mesh_dim_names.index(name))
        device = mesh_device(mesh)
        own = self.device
        own_index = own.index if own.index is not None or own.type == "cpu" else torch.cuda.current_device()
        if own.type != device.type or own_index != device.index:
            raise ValueError("use_mesh: this rank's device is {}, the solver's {}".format(device, own))
        axes = self.field_axes()
        bin_ax, frame_ax = self._input_axes(X)
        self._bin_pad = 0
        self._n_bins_true = None if bin_ax is None else X.shape[bin_ax]
        if mode == "bins" and self._shard_pad and bin_ax is not None and X.shape[bin_ax] % size:
            if not self.supports_bin_padding():
                raise ValueError(
                    "use_mesh(pad_bins=True): {} does not support zero-bin padding in this configuration "
                    "(padded bins must be provably neutral); choose a mesh that divides n_bins or size the "
                    "STFT so one does".format(type(self).__name__)
                )
            pad = (-X.shape[1]) % size
            X = torch.cat([X, X.new_zeros((X.shape[0], pad, X.shape[2]))], dim=1)
            for k, v in state_kwargs.items():
                ax = axes.get(k, {}).get("bins")
                if ax is not None:
                    state_kwargs[k] = self.pad_state_kwarg(k, v, pad, ax % np.ndim(v))
            self._bin_pad = pad
        in_ax = axes.get("input", {}).get(mode)
        if in_ax is not None and X.shape[in_ax] % size:
            raise ValueError(
                "use_mesh(mode={!r}): axis length {} is not divisible by the {}-way mesh axis {!r}; choose a mesh "
                "that divides it, size the STFT so one does, or pass use_mesh(..., pad_bins=True) for solvers "
                "that support zero-bin padding".format(mode, X.shape[in_ax], size, name)
            )
        self._validate_mesh(X)
        self._full_input = X
        self._n_bins_global = None if bin_ax is None else X.shape[bin_ax]
        self._n_frames_global = X.shape[frame_ax]
        if in_ax is None:  # nothing of this solver shards: every rank runs it whole
            return X, state_kwargs
        self._sharded = True
        self._bin_start = shard_bounds(X.shape[bin_ax], mesh, name)[0] if mode == "bins" else 0
        for k, v in state_kwargs.items():
            ax = axes.get(k, {}).get(mode)
            if ax is not None:
                v = v if isinstance(v, torch.Tensor) else np.asarray(v)
                state_kwargs[k] = take_shard(v, ax, shard_bounds(v.shape[ax], mesh, name))
        self._shard_input = take_shard(X, in_ax, shard_bounds(X.shape[in_ax], mesh, name)).contiguous()
        return self._shard_input, state_kwargs

    @contextlib.contextmanager
    def _on_shard(self, X, state_kwargs):
        """The input and the warm-start kwargs of this rank's shard under the
        mesh of :meth:`use_mesh` (themselves without one), with the call
        marked sharded inside the block."""
        if self._mesh is None:
            yield X, state_kwargs
            return
        X, state_kwargs = self._enter_mesh(X, dict(state_kwargs))
        try:
            yield X, state_kwargs
        finally:
            self._sharded, self._bin_pad = False, 0

    def output_axes(self):
        """The shardable axes of :meth:`finalize`'s output, as
        ``field_axes`` gives a field's; a tuple of them, one per factor,
        for the solvers that return factors."""
        return self.field_axes()["estimation"]

    def _whole_output(self, output):
        """The output of :meth:`finalize` on this shard, each piece gathered
        whole along its axis and cropped to the input's bins."""
        if not self._sharded:
            return output
        axes = self.output_axes()
        if isinstance(output, tuple):
            return tuple(self._gather_whole(v, a) for v, a in zip(output, axes))
        return self._gather_whole(output, axes)

    def _gather_whole(self, value, axes):
        """``value`` gathered along its axis of this call's mode (``axes``
        as a field's entry of ``field_axes``), cropped to the input's bins."""
        from ..parallel.mesh import shard_gather

        axis = axes.get(self._shard_mode)
        if axis is not None and isinstance(value, torch.Tensor) and value.ndim:
            value = shard_gather(value, axis % value.ndim, self)
        return self._crop_bins(value, axes.get("bins"))

    def _global_state(self, state):
        """The state as a whole: each sharded field gathered along its axis
        (the shard's own input is the whole one already), cropped to the
        input's bins."""
        if not self._sharded:
            return state
        axes = self.field_axes()
        out = {}
        for k, v in state.items():
            if v is self._shard_input:
                out[k] = self._crop_bins(self._full_input, axes.get(k, {}).get("bins"))
            else:
                out[k] = self._gather_whole(v, axes.get(k, {}))
        return out

    def _crop_bins(self, value, axis):
        """``value`` cut back to the input's bins along ``axis`` after a
        padded call."""
        if not self._bin_pad or axis is None or not isinstance(value, torch.Tensor) or not value.ndim:
            return value
        from ..parallel.mesh import take_shard

        return take_shard(value, axis, (0, self._n_bins_true))

    def _publish(self, state):
        """Publish the state as a whole (:meth:`_sync_attributes`)."""
        self._sync_attributes(self._global_state(state))

    # functional API -- override in subclasses
    def init_state(self, X, **kwargs):
        raise NotImplementedError

    def update_state(self, state):
        raise NotImplementedError

    def nll(self, state):
        raise NotImplementedError

    def finalize(self, state):
        raise NotImplementedError

    def prepare_state_kwargs(self, input, state_kwargs):
        """Host-side hook: fill in defaults that need host RNG (NumPy)."""
        return state_kwargs

    def capturable(self, X):
        """Whether this configuration's step (``update_state``, then
        ``nll``) on the input ``X`` (the tensor ``init_state`` takes) can be
        captured as a CUDA graph: no host read and no op that synchronises.
        It is decided before init, from the configuration and ``X``'s shape
        (ProxLaplaceIVA's ``svd`` past C = 2 reads on the host).  The
        captured loop (:mod:`.graph`) runs the solvers that say so on a CUDA
        card; the rest keep the eager loop, as does any call under
        :meth:`use_mesh` (a collective in the step)."""
        return False

    def capturable_edges(self, X):
        """Whether the call's edges on the input ``X``, ``init_state`` with
        the initial loss and ``finalize``, can be captured as CUDA graphs
        beside the step (:class:`~.graph.EdgeRoute`): both read nothing on
        the host and take no host-drawn init.  It is asked only where the
        step is captured and the call brings no callbacks and no warm
        start; a solver that says so and fails to capture raises."""
        return False

    def init_attributes(self, X):
        """Set the plain attributes that ``init_state`` sets from the input
        ``X`` (its shape): run on their own before the edges' graphs are
        looked up, since they are in the key and a replay runs no Python."""

    def _graph_inputs(self):
        """The objects a captured step reads besides its state and the
        solver's plain attributes (a network, say): a tuple in the graph
        cache's key, held there as long as the graph."""
        return ()

    def _uses_graph(self, X):
        """Whether a call on the input ``X`` runs the captured loop: a
        capturable step at ``X``'s shape, no mesh, a CUDA device (or the CPU
        hook)."""
        on_card = X.device.type == "cuda" or self._emulate_graph
        return on_card and self._mesh is None and self.capturable(X)

    def input_dtype(self, X):
        """The type the solver runs at for the input tensor ``X``: complex64
        (``real_input``: float32) on CUDA, the input's own precision on the
        CPU."""
        if self.real_input:
            cuda, least = torch.float32, torch.promote_types(X.real.dtype, torch.float32)
        else:
            cuda, least = torch.complex64, torch.promote_types(X.dtype, torch.complex64)
        return cuda if self.device.type == "cuda" else least

    # runtime
    def _to_input(self, input):
        """The input as a tensor on the solver's device, of
        :meth:`input_dtype` (a real type takes the real part)."""
        X = input if isinstance(input, torch.Tensor) else torch.as_tensor(np.asarray(input))
        dtype = self.input_dtype(X)
        if X.is_complex() and not dtype.is_complex:
            X = X.real
        out = X.to(device=self.device, dtype=dtype).contiguous()
        if not isinstance(input, torch.Tensor) or (X.device.type == "cpu" and out.device.type != "cpu"):
            count_copy(out.numel() * out.element_size())
        return out

    def _sync_attributes(self, state):
        """Publish the state as attributes (tensor references, no copy);
        :meth:`save_state` writes what is published.  Subclasses whose state
        lives in another frame than their warm-start kwargs publish them in
        the kwargs' frame here."""
        for k, v in state.items():
            setattr(self, k, v)

    def _split_kwargs(self, kwargs):
        state_kwargs, extra = {}, {}
        for k, v in kwargs.items():
            (state_kwargs if k in self.state_fields else extra)[k] = v
        return state_kwargs, extra

    def __call__(self, input, iteration=100, **kwargs):
        """Run ``iteration`` update steps and return the separated output.

        Args:
            input: ``(n_channels, n_bins, n_frames)`` complex spectrogram
                (numpy or tensor; moved to the solver's device), or the
                factorisation models' targets.
        Returns:
            ``(n_sources, n_bins, n_frames)`` complex tensor on the device
            (the factorisation models: their factors).
        """
        # full float32 products in every matmul of the loop: the IP and
        # Riccati chains invert matrices built from them
        with full_f32_matmuls():
            return self._run(input, iteration, kwargs)

    def _eager_call(self, input, iteration=100, **kwargs):
        """``__call__`` through the eager loop on any device: the reference
        that the captured loop is held to."""
        with full_f32_matmuls():
            return self._run(input, iteration, kwargs, eager=True)

    def _run(self, input, iteration, kwargs, eager=False):
        with span("solve"):
            init = begin("solve.init")
            X = self._to_input(input)
            self.input = X

            state_kwargs, extra = self._split_kwargs(kwargs)
            for k, v in extra.items():
                setattr(self, k, v)
            state_kwargs = self.prepare_state_kwargs(X, state_kwargs)
            state_kwargs = {k: v for k, v in state_kwargs.items() if v is not None}
            # the host inits above were drawn at the true bin count; a mesh
            # pads and cuts them with the input
            with self._on_shard(X, state_kwargs) as (X, state_kwargs):
                if eager:
                    route = Route(self, X)
                else:
                    route = route_for(self, X, state_kwargs, iteration, self.callbacks is not None)
                state, losses = route.init(state_kwargs)
                end(init)
                return self._drive(route, state, losses, iteration)

    def _drive(self, route, state, losses, iteration):
        """The call after ``route``'s init (:mod:`.graph`) gave the
        post-init ``state`` and ``losses``.  Without callbacks: every step,
        the losses' one transfer, the final publish and the finalize.  With
        callbacks: the callbacks after init where ``callback_on_init`` is
        set, then each step with its loss read on the host, the state
        published and the callbacks."""
        if self.callbacks is None:
            state, steps = route.steps(state, iteration)
            with span("solve.wait"):
                self._flush_losses(losses + steps)
        else:
            with span("solve.wait"):
                self._flush_losses(losses)
            with span("solve.steps"):
                if self.callback_on_init:
                    self._on_callback()
                for _ in range(iteration):
                    state, loss = route.step(state)
                    if route.record:
                        self.loss.append(float(loss))
                    self._publish(state)
                    self._on_callback()
        with span("solve.finalize"):
            if self.callbacks is None:
                self._publish(state)
            output = route.finalize(state)
            self.estimation = output
            return output

    def _flush_losses(self, losses):
        """Copy the device-side losses (0-d or 1-d tensors) to ``self.loss``
        in one transfer."""
        if losses:
            flat = torch.cat([v.reshape(-1) for v in losses])
            count_copy(flat.numel() * flat.element_size())
            self.loss.extend(flat.cpu().tolist())
            losses.clear()

    def _on_callback(self):
        for callback in self.callbacks:
            callback(self)

    # checkpoint / resume
    def save_state(self, path):
        """Write the warm-startable state arrays to an ``.npz`` checkpoint
        (the format the JAX package's ``save_state`` writes)."""
        payload = {}
        for field in self.state_fields:
            value = getattr(self, field, None)
            if value is not None:
                if isinstance(value, torch.Tensor):
                    value = value.detach().cpu().numpy()
                payload[field] = np.asarray(value)
        np.savez(path, **payload)

    @staticmethod
    def load_state(path):
        """Load a checkpoint written by :meth:`save_state` as warm-start
        kwargs for ``__call__``."""
        with np.load(path) as data:
            return {k: data[k] for k in data.files}

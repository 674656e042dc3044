"""Batched separation: many mixtures of one shape through one solver.

``batch_separate`` runs each example in turn on the solver's device through
the route its own ``solver(X)`` call takes (:func:`~..runtime.graph.route_for`),
so each example launches exactly what that call launches: on a card, for a
capturable solver, replays of the graphs of the shape, captured once for
every member; outputs and losses are stacked on the device and cross to the
host once.

  * every mixture in a batch shares its shape and the hyperparameters;
  * the host-RNG default inits are drawn for every example first, in the
    JAX package's order (each example in the reference's draw order);
  * callbacks are not called.

Over a ``("dp", "tp")`` device mesh the examples split over ``dp`` in
contiguous blocks, each example runs sharded over ``tp`` in bins mode
(:meth:`~..runtime.solver.IterativeSolver.use_mesh`), and the outputs and
losses are gathered over both dimensions, so every rank returns the whole
batch.
"""

import numpy as np
import torch

from ..runtime.graph import route_for
from ..runtime.solver import full_f32_matmuls
from .mesh import all_gather_cat, shard_bounds


def _take(value, b):
    """Example ``b`` of a warm-start value with a leading batch axis."""
    return value[b] if isinstance(value, torch.Tensor) else np.asarray(value[b])


def _stack(outputs):
    """Stack per-example outputs: a tensor, or a tuple of tensors (the
    factorisation models' factors)."""
    if isinstance(outputs[0], torch.Tensor):
        return torch.stack(outputs)
    return tuple(torch.stack(parts) for parts in zip(*outputs))


def _to_host(outputs):
    if isinstance(outputs, torch.Tensor):
        return outputs.cpu().numpy()
    return tuple(part.cpu().numpy() for part in outputs)


def batch_separate(solver, inputs, iteration=100, mesh=None, state_kwargs=None, host=True):
    """Separate a batch of mixtures.

    Args:
        solver: a solver instance of any family (its ``init_state`` /
            ``update_state`` / ``nll`` / ``finalize`` core).  A solver whose
            call takes more than the input (``GaussIDLMA``'s ``dnn``) reads
            it from the attribute that its call would set.
        inputs: ``(batch, n_channels, n_bins, n_frames)`` complex (the
            factorisation models: ``(batch, *target_shape)``), NumPy or a
            tensor; cast as the solver's own call casts its input
            (complex64 on the card).
        iteration: number of update steps.
        mesh: optional ``("dp", "tp")`` (or ``("dp",)``)
            :class:`~torch.distributed.device_mesh.DeviceMesh` (module
            docstring); the batch must divide by its ``dp`` size.  Without
            one the members run unsharded, whatever mesh the solver holds.
        state_kwargs: optional dict of warm-start arrays, each with a
            leading batch axis (a stack of :func:`~..utils.state_from_jax`
            dicts works).
        host: return NumPy (default); ``host=False`` returns the tensors on
            the solver's device.
    Returns:
        ``(outputs (batch, n_sources, n_bins, n_frames), losses (batch,
        iteration))``, the losses without the pre-loop one, or ``None``
        where ``solver.recordable_loss`` is off.
    """
    with full_f32_matmuls():
        return _batch_separate(solver, inputs, iteration, state_kwargs or {}, host, mesh)


def _batch_separate(solver, inputs, iteration, state_kwargs, host, mesh):
    Xs = solver._to_input(inputs)
    batch = Xs.shape[0]
    members, tp = range(batch), None
    if mesh is not None:
        dp = mesh.size(mesh.mesh_dim_names.index("dp"))
        if batch % dp:
            raise ValueError("batch_separate: a batch of {} does not divide by the {}-way 'dp' axis".format(batch, dp))
        members = range(*shard_bounds(batch, mesh, "dp"))
        tp = mesh["tp"] if "tp" in mesh.mesh_dim_names else None

    # host-RNG inits for every example first (the JAX package's draw order).
    # prepare_state_kwargs may set solver attributes from its example (MNMF's
    # annealing scale), so each example's run sees the attributes its own
    # preparation left, as its own call would
    prepared = []
    for b in range(batch):
        solver.input = Xs[b]
        kw = {k: _take(v, b) for k, v in state_kwargs.items()}
        kw = solver.prepare_state_kwargs(Xs[b], kw)
        prepared.append(({k: v for k, v in kw.items() if v is not None}, dict(vars(solver))))

    record = bool(solver.recordable_loss)
    meshed = solver._mesh, solver._shard_mode, solver._shard_axis_name, solver._shard_pad
    outputs, losses = [], []
    try:
        for b in members:
            kw, attributes = prepared[b]
            vars(solver).update(attributes)
            solver.use_mesh(tp, mode="bins")
            with solver._on_shard(Xs[b], kw) as (X, kw):
                # its own call's route, less the initial loss (the init
                # graph's, where its edges are captured, is not a batch's)
                # and the publishes
                route = route_for(solver, X, kw, iteration, solver.callbacks is not None)
                state, _ = route.init(kw, call=False)
                state, example_losses = route.steps(state, iteration)
                outputs.append(route.finalize(state))
            if record:
                flat = [v.reshape(-1) for v in example_losses]
                losses.append(torch.cat(flat) if flat else Xs.real.new_zeros((0,)))
    finally:
        solver._mesh, solver._shard_mode, solver._shard_axis_name, solver._shard_pad = meshed
    outputs = _stack(outputs)
    losses = torch.stack(losses) if record else None
    if mesh is not None:
        group = mesh.get_group("dp")
        outputs = all_gather_cat(outputs, 0, group)
        losses = all_gather_cat(losses, 0, group) if record else None
    if not host:
        return outputs, losses
    return _to_host(outputs), (losses.cpu().numpy() if record else None)

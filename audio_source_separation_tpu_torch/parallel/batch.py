"""Batched separation: many mixtures of one shape through one solver.

``batch_separate`` runs each example's functional-core loop (``init_state``,
``update_state``, ``nll``, ``finalize``) in turn on the solver's device, so
each example launches exactly what its own ``solver(X)`` call launches;
outputs and losses are stacked on the device and cross to the host once.

  * every mixture in a batch shares its shape and the hyperparameters;
  * the host-RNG default inits are drawn for every example first, in the
    JAX package's order (each example in the reference's draw order);
  * callbacks are not called.
"""

import numpy as np
import torch

from ..runtime.solver import full_f32_matmuls


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
        mesh: sharding over devices waits for the ``torch.distributed``
            port; anything but ``None`` raises ``NotImplementedError``.
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
    if mesh is not None:
        raise NotImplementedError(
            "batch_separate(mesh=...): sharding over devices waits for slice 10b (torch.distributed)"
        )
    with full_f32_matmuls():
        return _batch_separate(solver, inputs, iteration, state_kwargs or {}, host)


def _batch_separate(solver, inputs, iteration, state_kwargs, host):
    Xs = solver._to_input(inputs)
    batch = Xs.shape[0]

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
    outputs, losses = [], []
    for b, (kw, attributes) in enumerate(prepared):
        vars(solver).update(attributes)
        state = solver.init_state(Xs[b], **kw)
        example_losses = []
        for _ in range(iteration):
            state = solver.update_state(state)
            if record:
                example_losses.append(solver.nll(state))
        outputs.append(solver.finalize(state))
        if record:
            losses.append(torch.stack(example_losses) if example_losses else Xs.real.new_zeros((0,)))
    outputs = _stack(outputs)
    losses = torch.stack(losses) if record else None
    if not host:
        return outputs, losses
    return _to_host(outputs), (losses.cpu().numpy() if record else None)

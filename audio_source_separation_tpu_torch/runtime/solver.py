"""The solver runtime: one iteration engine for every separation model.

A solver defines functions over an explicit **state dict**:
``init_state``, ``update_state`` (returns the next state dict), ``nll``
and ``finalize``.  :class:`IterativeSolver` runs them in a Python loop on the
solver's device and keeps the public API of the reference:
``solver = Cls(**hyper); output = solver(X, iteration=N, **state_kwargs)``,
where ``state_kwargs`` warm-start the state (checkpoint / resume), any other
kwargs become plain attributes for callbacks, ``solver.loss`` records the
loss after every update (concatenating across calls) and, where
``record_initial_loss`` is set, before the first one, and callbacks run
after every iteration, and after init where ``callback_on_init`` is set,
with the state published as attributes.
"""

import contextlib

import numpy as np
import torch

from .device import resolve_device

EPS = 1e-12


def real_tensor(value, X):
    """A state array (host-drawn float64 NumPy, or a tensor) on ``X``'s
    device at ``X``'s real type: the cast comes after the draw, so float64
    runs see the drawn values exactly."""
    return torch.as_tensor(value).to(device=X.device, dtype=X.real.dtype).contiguous()


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

    def __init__(self, callbacks=None, recordable_loss=True, eps=EPS, device=None):
        if callbacks is not None and callable(callbacks):
            callbacks = [callbacks]
        self.callbacks = callbacks
        self.eps = eps
        self.device = resolve_device(device)
        self.input = None
        self.recordable_loss = recordable_loss
        self.loss = [] if recordable_loss else None

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
        return X.to(device=self.device, dtype=dtype).contiguous()

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

    def _run(self, input, iteration, kwargs):
        X = self._to_input(input)
        self.input = X

        state_kwargs, extra = self._split_kwargs(kwargs)
        for k, v in extra.items():
            setattr(self, k, v)
        state_kwargs = self.prepare_state_kwargs(X, state_kwargs)
        state = self.init_state(X, **{k: v for k, v in state_kwargs.items() if v is not None})
        self._sync_attributes(state)

        losses = []
        if self.recordable_loss and self.record_initial_loss:
            losses.append(self.nll(state))

        if self.callbacks is not None:
            self._flush_losses(losses)
            if self.callback_on_init:
                self._on_callback()
            for _ in range(iteration):
                state = self.update_state(state)
                if self.recordable_loss:
                    self.loss.append(float(self.nll(state)))
                self._sync_attributes(state)
                self._on_callback()
        else:
            for _ in range(iteration):
                state = self.update_state(state)
                if self.recordable_loss:
                    losses.append(self.nll(state))
            self._flush_losses(losses)
            self._sync_attributes(state)

        output = self.finalize(state)
        self.estimation = output
        return output

    def _flush_losses(self, losses):
        """Copy the device-side losses to ``self.loss`` in one transfer."""
        if losses:
            self.loss.extend(torch.stack(losses).cpu().tolist())
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

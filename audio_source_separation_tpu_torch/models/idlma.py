"""Independent deeply-learned matrix analysis (IDLMA) (reference
``sss/idlma.py:10-245``, ``GaussIDLMA``).

Determined separation informed by a network: each iteration feeds the
estimates' amplitudes ``|Y|^domain`` to a user-supplied variance model
``dnn``, takes ``R = max(dnn(.), dnn_flooring)^(2 / domain)`` as the
sources' variances, runs the IP spatial update with per-bin weights ``1/R``
and normalises the estimates by projection-back (``idlma.py:141-225``).

The network runs in the loop on the solver's device: ``dnn`` is any torch
callable, typically an ``nn.Module`` on that device, called under
``torch.no_grad()`` on the ``(S, F, T)`` amplitude tensor.  ``jax_dnn``
keeps the JAX package's meaning: with ``jax_dnn=True`` (its fully jitted
scan) the network is a pure function of device tensors, and on the card
the step, network included, is captured as a CUDA graph
(:mod:`~..runtime.graph`); with ``jax_dnn=False`` (the default in both
packages) the loop stays eager, as the JAX package's host-DNN loop does,
and the network may compute anywhere and return any array.

Each iteration forms the covariance by one launch of kernel K1 with the
per-bin ``(S, F, T)`` weights (:meth:`~.iva.IVABase._ip_sweep`, as ILRMA).
The state takes one of two forms, fixed at init:

  * component form (guard ``one_norm`` or ``none``, C <= 4): ``{"input",
    "demix_filter", "pair_products" (C^2, F, T), "gram" (C, C, F),
    "estimation_power" (S, F, T), "dnn_output"}``.  The reference refits
    ``W`` to the projected-back estimates by least squares
    (``idlma.py:154-157``); since ``Y = W X`` exactly, that fit is the
    per-row scale itself, taken from the invariant mixture Gram
    (:func:`~..ops.ip_components.projection_back_components`), and ``|Y|^2``
    comes from the pair-product planes;
  * matrix form (otherwise): ``{"input", "demix_filter", "estimation",
    "dnn_output"}``, with the projection-back and the least-squares refit
    of ``idlma.py:141-157``.

As in the JAX package the state always starts from the identity filter and
unit variances: ``__call__`` keyword arguments become attributes, not
state, and the singular ``callback`` (the reference's name) runs after each
iteration only.

Under a mesh (the JAX package's ``field_axes``) everything shards with the
bins or the frames.  In frames mode the network maps this shard's frames,
and K1's covariance, the Gram and the projection-back's frame sums are
all-reduced.  In bins mode the network mixes the frequencies, so its input
is all-gathered along the bins once an iteration (the one gather inside
the loop) and each rank keeps its own bins of the output.  The NLL's sums
are all-reduced in either mode.
"""

import torch

from ..ops.fast_linalg import batched_log_abs_det
from ..ops.ip import uses_component_sweep
from ..ops.ip_components import (
    filter_rows,
    gram_components,
    pair_products_planes,
    projection_back_components,
    quadratic_power_planes,
)
from ..utils.flooring import EPS, THRESHOLD, floor_below
from .iva import IVABase


def torch_dnn(module):
    """A callable running ``module`` under ``no_grad`` (the reference's
    execution mode, ``idlma.py:218-224``) on the solver's device: the input
    is cast to the module's parameter type and the output back.  The module
    must be on the solver's device."""

    def call(amplitude):
        param = next(module.parameters(), None)
        x = amplitude if param is None else amplitude.to(param.dtype)
        with torch.no_grad():
            return module(x).to(amplitude.dtype)

    return call


class IDLMABase(IVABase):
    """Shared IDLMA protocol (``sss/idlma.py:10-88``); the reference takes a
    singular ``callback`` here (``idlma.py:11-13``)."""

    state_fields = ("demix_filter", "estimation", "dnn_output")
    callback_on_init = False

    def __init__(self, normalize=True, callback=None, dnn_flooring=1e-5, eps=EPS, device=None):
        super().__init__(callbacks=None, recordable_loss=True, eps=eps, device=device)
        self.callback = callback
        self.normalize = normalize
        self.dnn_flooring = dnn_flooring

    def __call__(self, input, iteration=100, dnn=None, **kwargs):
        """Run ``iteration`` IDLMA iterations with the variance model ``dnn``
        (see the module docstring); other keyword arguments become
        attributes."""
        self.dnn = dnn
        self.callbacks = None if self.callback is None else [self.callback]
        return super().__call__(input, iteration=iteration, **kwargs)

    def _split_kwargs(self, kwargs):
        # no warm start: every keyword is an attribute, as in the JAX package
        return {}, dict(kwargs)


class GaussIDLMA(IDLMABase):
    """Gaussian IDLMA (``sss/idlma.py:89-245``)."""

    def __init__(
        self,
        domain=2,
        normalize="projection-back",
        reference_id=0,
        callback=None,
        dnn_flooring=1e-5,
        eps=EPS,
        threshold=THRESHOLD,
        guard="one_norm",
        jax_dnn=False,
        device=None,
    ):
        super().__init__(normalize=normalize, callback=callback, dnn_flooring=dnn_flooring, eps=eps, device=device)
        # AssertionError, as the JAX package's assert raises, but kept under -O
        if not 1 <= domain <= 2:
            raise AssertionError("1 <= `domain` <= 2 is not satisfied.")
        self.domain = domain
        self.reference_id = reference_id
        self.threshold = threshold
        self.guard = guard
        self.jax_dnn = jax_dnn

    def capturable(self, X):
        """With ``jax_dnn=True``, the JAX package's flag for its fully
        jitted scan: the caller vouches that ``dnn`` is a pure function of
        device tensors (a torch module on the solver's device, as
        :func:`torch_dnn` wraps one), so the network runs inside the
        captured step, and the graph is cached per network
        (:meth:`_graph_inputs`).  With ``jax_dnn=False`` (the default) the
        network may read or compute on the host, and the loop stays eager,
        as JAX's host-DNN loop does.  The ``svd`` guard keeps the eager loop
        too (``torch.linalg.svdvals`` copies to the host)."""
        return bool(self.jax_dnn) and self.guard != "svd"

    def _graph_inputs(self):
        return (self.dnn,)

    def field_axes(self):
        """The JAX package's shardable axes, with the port's component
        state: the Gram ``(C, C, F)`` and the estimates' power."""
        return dict(
            super().field_axes(),
            dnn_output={"bins": 1, "frames": 2},
            gram={"bins": 2},
            estimation_power={"bins": 1, "frames": 2},
        )

    def init_state(self, X):
        W = self._initial_filter(X, None)
        state = {"input": X, "demix_filter": W, "dnn_output": torch.ones(X.shape, dtype=X.real.dtype, device=X.device)}
        if uses_component_sweep(self.guard, X.shape[0]):
            planes = pair_products_planes(X)
            gram = gram_components(planes, frames_sum=self._frames_sum if self._sharded else None)
            state.update(
                pair_products=planes,
                gram=torch.stack([torch.stack(row) for row in gram]),
                estimation_power=quadratic_power_planes(W, planes),
            )
        else:
            state["estimation"] = self.separate(X, W)
        return state

    def _power(self, state):
        if "estimation_power" in state:
            return state["estimation_power"]
        return torch.abs(state["estimation"]) ** 2

    def _apply_dnn(self, P):
        """``max(dnn(P^(domain / 2))^(2 / domain), dnn_flooring)``
        (``idlma.py:212-225``)."""
        amplitude = P ** (self.domain / 2)
        group = self._shard_group("bins")
        if group is not None:
            # the network mixes the frequencies: it sees every bin, and this
            # rank keeps its own
            from ..parallel.mesh import shard_gather

            amplitude = shard_gather(amplitude, 1, self)
        with torch.no_grad():
            out = torch.as_tensor(self.dnn(amplitude), dtype=P.dtype, device=P.device)
        if group is not None:
            out = out[:, self._bin_start : self._bin_start + P.shape[1]]
        out = out ** (2 / self.domain)
        if self.dnn_flooring:
            out = torch.clamp(out, min=self.dnn_flooring)
        return out.contiguous()

    def _variance(self, dnn_output):
        return floor_below(dnn_output ** (2 / self.domain), self.eps)

    def update_state(self, state):
        if self.normalize != "projection-back" and self.normalize is not True:
            if self.normalize:
                raise ValueError(
                    "Not support normalization based on {}. Choose 'power' or "
                    "'projection-back'".format(self.normalize)
                )
            raise ValueError("Set normalize=True")
        X = state["input"]
        dnn_output = self._apply_dnn(self._power(state))
        W = self._ip_sweep(state, 1.0 / self._variance(dnn_output))  # one K1 launch
        if "gram" in state:
            scale = projection_back_components(filter_rows(W), state["gram"], reference_id=self.reference_id)
            W = W * torch.stack(scale, dim=1)[:, :, None]
            return dict(
                state,
                demix_filter=W,
                dnn_output=dnn_output,
                estimation_power=quadratic_power_planes(W, state["pair_products"]),
            )
        Y = self.separate(X, W)
        Y = Y * self._projection_back(Y, X[self.reference_id])[..., None]
        # refit W to the normalised estimates (``idlma.py:154-157``)
        W = self.compute_demix_filter(Y, X, frames_sum=self._frames_sum if self._sharded else None)
        return dict(state, demix_filter=W, dnn_output=dnn_output, estimation=Y)

    def nll(self, state):
        R = self._variance(state["dnn_output"])
        n_frames = self._n_frames(state["input"])
        P = self._power(state)
        logdet = batched_log_abs_det(state["demix_filter"]).sum()
        return self._fit_less_per_bin(torch.sum(P / R + torch.log(R)), 2 * n_frames * logdet)

    def finalize(self, state):
        X = state["input"]
        Y = self.separate(X, state["demix_filter"])
        return Y * self._projection_back(Y, X[self.reference_id])[..., None]

    def _sync_attributes(self, state):
        super()._sync_attributes(state)
        if self.callbacks is not None and "estimation" not in state:
            self.estimation = self.separate(state["input"], state["demix_filter"])

    def __repr__(self):
        return "GaussIDLMA(domain={}, normalize={})".format(self.domain, self.normalize)
